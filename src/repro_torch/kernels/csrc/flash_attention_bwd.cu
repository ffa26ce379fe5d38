// Flash attention backward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the XLA backward of src/repro/kernels/ops.py:152 (the
// custom_vjp of _flash_custom, which recomputes each KV chunk's
// probabilities from the forward's logsumexp); no Pallas kernel exists for
// it.  Given q [B, Sq, H, D], k [B, Sk, KV, D], v [B, Sk, KV, Dv], the
// forward's out and the incoming dout [B, Sq, H, Dv] (bf16) and lse
// [B, Sq, H] (fp32, natural log of the scaled logits' sum of exponentials),
// it computes, with the same causal / window / no mask and q_offset as the
// forward:
//   delta = rowsum(dO * O)                  (fp32)
//   P     = exp(S - lse), S = scale Q K^T   (0 where masked)
//   dV    = P^T dO
//   dS    = P * (dO V^T - delta)
//   dQ    = scale dS K
//   dK    = scale dS^T Q
// dK and dV sum over the G query heads of each KV head.  Three launches on
// the caller's stream, no atomics, so two calls on one input give the same
// bits:
// 1. delta: one warp per (batch, query, head) row.
// 2. dK/dV: one CTA per (batch, KV head, tile of 64 keys); its four warps
//    own 16 keys each and walk the G heads and every tile of 32 queries
//    that the mask lets see one of its keys, recomputing S^T and P^T there
//    and accumulating dK and dV in fp32 registers.
// 3. dQ: one CTA per (batch, head, tile of 64 queries); four warps of 16
//    rows walk the key tiles of 64 that the mask leaves visible (the
//    forward's key range) and accumulate dQ in fp32 registers.
//
// What bounds it on the card: tensor-core operations.  At yi-6b's training
// shape (B 4, S 1024, 32 heads / 4 KV of 128, causal) the five products of
// the formula over the causal half are 86.0 GFLOP against ~40 MB of
// inputs and outputs; this design performs seven (S and dP once in each
// kernel), 120 GFLOP.  This first version is plain: mma.sync m16n8k16
// (bf16 in, fp32 accumulate) on operands that ldmatrix reads from padded
// shared-memory tiles filled by ordinary 16-byte loads, one tile at a
// time, with the mask evaluated on every element.  Left for later: wgmma,
// TMA and a pipelined ring of tiles (ROADMAP B2).
//
// Head dims (D, Dv): (64, 64) and (128, 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

// Four warps.  The two product kernels declare __launch_bounds__(THREADS,
// 1): with the bound on threads alone ptxas held the (64, 64) kernels to
// 128 registers and spilled; this way they take 154-238, without spills.
constexpr int THREADS = 128;
constexpr int KV_BN = 64;            // keys per dK/dV CTA, 16 a warp
constexpr int KV_BM = 32;            // queries per step of the dK/dV kernel
constexpr int Q_BM = 64;             // queries per dQ CTA, 16 a warp
constexpr int Q_BN = 64;             // keys per step of the dQ kernel
constexpr int PAD = 8;               // bf16 of padding per shared row
constexpr float LOG2E = 1.4426950408889634f;

enum MaskKind { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_WINDOW = 2 };

__device__ __forceinline__ bool visible(int mask_kind, int window, int qpos,
                                        int key) {
    if (mask_kind == MASK_NONE) return true;
    if (key > qpos) return false;
    return mask_kind != MASK_WINDOW || key > qpos - window;
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// `rows` rows of W bf16 from global memory (row stride `stride` elements)
// into a shared tile of row stride W + PAD; rows past `valid` are zeros.
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int rows,
                                          int valid) {
    constexpr int CPR = W / 8;                  // 16-byte chunks a row
    for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
        const int r = i / CPR;
        const int c = (i % CPR) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid)
            val = *reinterpret_cast<const uint4*>(src + r * stride + c);
        *reinterpret_cast<uint4*>(dst + r * (W + PAD) + c) = val;
    }
}

// mma.sync operands from a shared tile of row stride LD (fragment layouts
// of the PTX ISA's m16n8k16):
// A, 16 x 16 at (row0, k0) of a row-major [M][K] tile;
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int k0, int lane) {
    ldmatrix_x4(a, tile + (row0 + lane % 16) * LD + k0 + (lane / 16) * 8);
}

// B for two n8 tiles (b[0..1] columns n0..n0+7, b[2..3] the next eight),
// k0..k0+15, from a row-major [N][K] tile;
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0, int lane) {
    ldmatrix_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * LD + k0 +
                       ((lane / 8) % 2) * 8);
}

// the same from a row-major [K][N] tile (transposed by ldmatrix).
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0, int lane) {
    ldmatrix_x4_trans(b, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                             n0 + (lane / 16) * 8);
}

// An accumulator of n8 tiles 2kk and 2kk + 1 as the A operand of k16 slice
// kk (rows stay, its columns become k), rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kk) {
    a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// ------------------------------------------------------------------ delta
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ out,
                       const bf16* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int DV) {
    const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    const __nv_bfloat162* o2 =
        reinterpret_cast<const __nv_bfloat162*>(out + row * DV);
    const __nv_bfloat162* d2 =
        reinterpret_cast<const __nv_bfloat162*>(dout + row * DV);
    float acc = 0.f;
    for (int c = lane; c < DV / 2; c += 32) {
        const float2 o = __bfloat1622float2(o2[c]);
        const float2 d = __bfloat1622float2(d2[c]);
        acc += o.x * d.x + o.y * d.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[row] = acc;
}

// ------------------------------------------------------------------ dK/dV
template <int D, int DV>
struct KvLayout {
    static constexpr int LDK = D + PAD;
    static constexpr int LDV = DV + PAD;
    static constexpr int k_off = 0;                          // [KV_BN][LDK]
    static constexpr int v_off = k_off + KV_BN * LDK * 2;    // [KV_BN][LDV]
    static constexpr int q_off = v_off + KV_BN * LDV * 2;    // [KV_BM][LDK]
    static constexpr int do_off = q_off + KV_BM * LDK * 2;   // [KV_BM][LDV]
    static constexpr int lse_off = do_off + KV_BM * LDV * 2; // [KV_BM] fp32
    static constexpr int delta_off = lse_off + KV_BM * 4;    // [KV_BM] fp32
    static constexpr int bytes = delta_off + KV_BM * 4;
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Sq, int Sk, int H, int KV,
                      int mask_kind, int window, int q_offset, float scale) {
    using L = KvLayout<D, DV>;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
    bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
    bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
    float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
    float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

    const int n0 = blockIdx.x * KV_BN;
    const int hk = blockIdx.y;
    const int b = blockIdx.z;
    const int G = H / KV;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    // This thread's two keys (accumulator rows g and g + 8 of its warp).
    const int key0 = n0 + 16 * warp + lane / 4;
    const float scale_log2 = scale * LOG2E;

    load_tile<D>(Ks, k + ((long long)b * Sk + n0) * KV * D + hk * D,
                 (long long)KV * D, KV_BN, Sk - n0);
    load_tile<DV>(Vs, v + ((long long)b * Sk + n0) * KV * DV + hk * DV,
                  (long long)KV * DV, KV_BN, Sk - n0);

    // Query rows [m_lo, m_hi) that can see a key of this tile.
    int m_lo = 0;
    int m_hi = Sq;
    if (mask_kind != MASK_NONE) {
        m_lo = max(0, n0 - q_offset);
        if (mask_kind == MASK_WINDOW)
            m_hi = min(Sq, n0 + KV_BN - 1 + window - q_offset);
    }
    const int t_lo = m_lo / KV_BM;
    const int t_hi = m_hi > m_lo ? (m_hi + KV_BM - 1) / KV_BM : t_lo;

    float acc_dk[D / 8][4];
    float acc_dv[DV / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_dk[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_dv[j][e] = 0.f;

    for (int hg = 0; hg < G; ++hg) {
        const int h = hk * G + hg;
        for (int tile = t_lo; tile < t_hi; ++tile) {
            const int m0 = tile * KV_BM;
            __syncthreads();                 // the last tile's reads are done
            load_tile<D>(Qs, q + ((long long)b * Sq + m0) * H * D + h * D,
                         (long long)H * D, KV_BM, Sq - m0);
            load_tile<DV>(dOs,
                          dout + ((long long)b * Sq + m0) * H * DV + h * DV,
                          (long long)H * DV, KV_BM, Sq - m0);
            if (threadIdx.x < KV_BM) {
                const int row = m0 + threadIdx.x;
                const long long at = ((long long)b * Sq + row) * H + h;
                lse_s[threadIdx.x] = row < Sq ? lse[at] * LOG2E : 0.f;
                delta_s[threadIdx.x] = row < Sq ? delta[at] : 0.f;
            }
            __syncthreads();

            // S^T = K Q^T: this warp's 16 keys x KV_BM queries.
            float s[KV_BM / 8][4];
#pragma unroll
            for (int j = 0; j < KV_BM / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                uint32_t a[4];
                frag_a<L::LDK>(a, Ks, 16 * warp, 16 * kk, lane);
#pragma unroll
                for (int nb = 0; nb < KV_BM / 16; ++nb) {
                    uint32_t bq[4];
                    frag_b_nk<L::LDK>(bq, Qs, 16 * nb, 16 * kk, lane);
                    mma_16816(s[2 * nb], a, bq[0], bq[1]);
                    mma_16816(s[2 * nb + 1], a, bq[2], bq[3]);
                }
            }
            // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked
            // (also keys past Sk and queries past Sq, the tiles' zeros).
#pragma unroll
            for (int j = 0; j < KV_BM / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = key0 + ((e & 2) ? 8 : 0);
                    const int ql = 8 * j + 2 * t + (e & 1);
                    const int row = m0 + ql;
                    const bool ok = key < Sk && row < Sq &&
                        visible(mask_kind, window, q_offset + row, key);
                    s[j][e] = ok ? ex2(s[j][e] * scale_log2 - lse_s[ql]) : 0.f;
                }
            // dV += P^T dO.
#pragma unroll
            for (int kk = 0; kk < KV_BM / 16; ++kk) {
                uint32_t p[4];
                acc_to_a<KV_BM / 8>(p, s, kk);
#pragma unroll
                for (int nb = 0; nb < DV / 16; ++nb) {
                    uint32_t bo[4];
                    frag_b_kn<L::LDV>(bo, dOs, 16 * kk, 16 * nb, lane);
                    mma_16816(acc_dv[2 * nb], p, bo[0], bo[1]);
                    mma_16816(acc_dv[2 * nb + 1], p, bo[2], bo[3]);
                }
            }
            // dP^T = V dO^T.
            float dp[KV_BM / 8][4];
#pragma unroll
            for (int j = 0; j < KV_BM / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < DV / 16; ++kk) {
                uint32_t a[4];
                frag_a<L::LDV>(a, Vs, 16 * warp, 16 * kk, lane);
#pragma unroll
                for (int nb = 0; nb < KV_BM / 16; ++nb) {
                    uint32_t bo[4];
                    frag_b_nk<L::LDV>(bo, dOs, 16 * nb, 16 * kk, lane);
                    mma_16816(dp[2 * nb], a, bo[0], bo[1]);
                    mma_16816(dp[2 * nb + 1], a, bo[2], bo[3]);
                }
            }
            // dS^T = P^T (dP^T - delta), in place of P^T.
#pragma unroll
            for (int j = 0; j < KV_BM / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[j][e] *= dp[j][e] - delta_s[8 * j + 2 * t + (e & 1)];
            // dK += dS^T Q (scaled once, at the end).
#pragma unroll
            for (int kk = 0; kk < KV_BM / 16; ++kk) {
                uint32_t ds[4];
                acc_to_a<KV_BM / 8>(ds, s, kk);
#pragma unroll
                for (int nb = 0; nb < D / 16; ++nb) {
                    uint32_t bq[4];
                    frag_b_kn<L::LDK>(bq, Qs, 16 * kk, 16 * nb, lane);
                    mma_16816(acc_dk[2 * nb], ds, bq[0], bq[1]);
                    mma_16816(acc_dk[2 * nb + 1], ds, bq[2], bq[3]);
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= Sk) continue;
        bf16* krow = dk + ((long long)b * Sk + key) * KV * D + hk * D + 2 * t;
        bf16* vrow = dv + ((long long)b * Sk + key) * KV * DV + hk * DV + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(krow + 8 * j) = pack_bf16(
                acc_dk[j][2 * r] * scale, acc_dk[j][2 * r + 1] * scale);
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
            *reinterpret_cast<uint32_t*>(vrow + 8 * j) =
                pack_bf16(acc_dv[j][2 * r], acc_dv[j][2 * r + 1]);
    }
}

// --------------------------------------------------------------------- dQ
template <int D, int DV>
struct QLayout {
    static constexpr int LDK = D + PAD;
    static constexpr int LDV = DV + PAD;
    static constexpr int q_off = 0;                          // [Q_BM][LDK]
    static constexpr int do_off = q_off + Q_BM * LDK * 2;    // [Q_BM][LDV]
    static constexpr int k_off = do_off + Q_BM * LDV * 2;    // [Q_BN][LDK]
    static constexpr int v_off = k_off + Q_BN * LDK * 2;     // [Q_BN][LDV]
    static constexpr int bytes = v_off + Q_BN * LDV * 2;
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Sq, int Sk, int H, int KV, int mask_kind, int window,
                    int q_offset, float scale) {
    using L = QLayout<D, DV>;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
    bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);

    const int m0 = blockIdx.x * Q_BM;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (H / KV);
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    // This thread's two rows (accumulator rows g and g + 8 of its warp).
    const int row0 = m0 + 16 * warp + lane / 4;
    const float scale_log2 = scale * LOG2E;

    load_tile<D>(Qs, q + ((long long)b * Sq + m0) * H * D + h * D,
                 (long long)H * D, Q_BM, Sq - m0);
    load_tile<DV>(dOs, dout + ((long long)b * Sq + m0) * H * DV + h * DV,
                  (long long)H * DV, Q_BM, Sq - m0);
    float lse2[2];
    float dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const long long at = ((long long)b * Sq + row) * H + h;
        lse2[r] = row < Sq ? lse[at] * LOG2E : 0.f;
        dlt[r] = row < Sq ? delta[at] : 0.f;
    }

    // Key tiles that any row of this CTA can see (the forward's range).
    int n_lo = 0;
    int n_hi = Sk;
    if (mask_kind != MASK_NONE) {
        n_hi = min(Sk, q_offset + m0 + Q_BM);
        if (mask_kind == MASK_WINDOW) n_lo = max(0, q_offset + m0 - window + 1);
    }
    const int t_lo = n_lo / Q_BN;
    const int n_tiles = max(0, (n_hi + Q_BN - 1) / Q_BN - t_lo);

    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int i = 0; i < n_tiles; ++i) {
        const int n0 = (t_lo + i) * Q_BN;
        __syncthreads();                     // the last tile's reads are done
        load_tile<D>(Ks, k + ((long long)b * Sk + n0) * KV * D + hk * D,
                     (long long)KV * D, Q_BN, Sk - n0);
        load_tile<DV>(Vs, v + ((long long)b * Sk + n0) * KV * DV + hk * DV,
                      (long long)KV * DV, Q_BN, Sk - n0);
        __syncthreads();

        // S = Q K^T: this warp's 16 rows x Q_BN keys.
        float s[Q_BN / 8][4];
#pragma unroll
        for (int j = 0; j < Q_BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            frag_a<L::LDK>(a, Qs, 16 * warp, 16 * kk, lane);
#pragma unroll
            for (int nb = 0; nb < Q_BN / 16; ++nb) {
                uint32_t bk[4];
                frag_b_nk<L::LDK>(bk, Ks, 16 * nb, 16 * kk, lane);
                mma_16816(s[2 * nb], a, bk[0], bk[1]);
                mma_16816(s[2 * nb + 1], a, bk[2], bk[3]);
            }
        }
#pragma unroll
        for (int j = 0; j < Q_BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = row0 + ((e & 2) ? 8 : 0);
                const int key = n0 + 8 * j + 2 * t + (e & 1);
                const bool ok = row < Sq && key < Sk &&
                    visible(mask_kind, window, q_offset + row, key);
                s[j][e] = ok ? ex2(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
            }
        // dP = dO V^T.
        float dp[Q_BN / 8][4];
#pragma unroll
        for (int j = 0; j < Q_BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
            uint32_t a[4];
            frag_a<L::LDV>(a, dOs, 16 * warp, 16 * kk, lane);
#pragma unroll
            for (int nb = 0; nb < Q_BN / 16; ++nb) {
                uint32_t bv[4];
                frag_b_nk<L::LDV>(bv, Vs, 16 * nb, 16 * kk, lane);
                mma_16816(dp[2 * nb], a, bv[0], bv[1]);
                mma_16816(dp[2 * nb + 1], a, bv[2], bv[3]);
            }
        }
        // dS = P (dP - delta), then dQ += dS K (scaled once, at the end).
#pragma unroll
        for (int j = 0; j < Q_BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - dlt[e >> 1];
#pragma unroll
        for (int kk = 0; kk < Q_BN / 16; ++kk) {
            uint32_t ds[4];
            acc_to_a<Q_BN / 8>(ds, s, kk);
#pragma unroll
            for (int nb = 0; nb < D / 16; ++nb) {
                uint32_t bk[4];
                frag_b_kn<L::LDK>(bk, Ks, 16 * kk, 16 * nb, lane);
                mma_16816(acc[2 * nb], ds, bk[0], bk[1]);
                mma_16816(acc[2 * nb + 1], ds, bk[2], bk[3]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Sq) continue;
        bf16* qrow = dq + ((long long)b * Sq + row) * H * D + h * D + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(qrow + 8 * j) =
                pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
}

// ------------------------------------------------------------------- host
template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int KV, int mask_kind, int window,
                   int q_offset, float scale, cudaStream_t stream) {
    const long long rows = (long long)B * Sq * H;
    flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
        static_cast<float*>(delta), rows, DV);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    auto kv_kern = flash_bwd_dkdv_kernel<D, DV>;
    constexpr int kv_bytes = KvLayout<D, DV>::bytes;
    err = cudaFuncSetAttribute(kv_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_bytes);
    if (err != cudaSuccess) return err;
    dim3 kv_grid((Sk + KV_BN - 1) / KV_BN, KV, B);
    kv_kern<<<kv_grid, THREADS, kv_bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, KV,
        mask_kind, window, q_offset, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    auto q_kern = flash_bwd_dq_kernel<D, DV>;
    constexpr int q_bytes = QLayout<D, DV>::bytes;
    err = cudaFuncSetAttribute(q_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_bytes);
    if (err != cudaSuccess) return err;
    dim3 q_grid((Sq + Q_BM - 1) / Q_BM, H, B);
    q_kern<<<q_grid, THREADS, q_bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), Sq, Sk, H, KV, mask_kind, window, q_offset,
        scale);
    return cudaGetLastError();
}

}  // namespace

// Gradients of flash attention.  Sq, Sk and B must be positive (the
// wrapper answers the empty cases); delta is scratch of B * Sq * H floats.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int D, int Dv, int mask_kind, int window,
                                   int q_offset, float scale, int device,
                                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (D == 128 && Dv == 128)
        return (int)launch<128, 128>(q, k, v, out, dout, lse, delta, dq, dk,
                                     dv, B, Sq, Sk, H, KV, mask_kind, window,
                                     q_offset, scale, st);
    if (D == 64 && Dv == 64)
        return (int)launch<64, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                   B, Sq, Sk, H, KV, mask_kind, window,
                                   q_offset, scale, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
