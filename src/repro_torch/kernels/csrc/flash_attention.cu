// Flash attention forward (prefill) for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas, body _kernel): forward-only online-softmax GQA
// attention with a causal, sliding-window or no mask and a static q_offset.
// Scores are accumulated in fp32 and multiplied by `scale` in fp32; the
// running max m, sum l and output accumulator are fp32; a row that no key
// may attend to comes out 0 (the Pallas kernel's 1e-30 floor on l).
//
// What bounds it on the card: tensor-core operations.  At the prefill
// shapes of the serving path (B 4, S 1024, 32 heads of 128) the causal
// half of QK^T and PV is ~34 GFLOP against ~50 MB of Q/K/V/O traffic, far
// above the H100's ~295 FLOP/byte balance point.  What the design does
// about it: both products run on the tensor cores (WMMA bf16 16x16x16
// fragments, fp32 accumulation) from bf16 tiles staged in shared memory,
// and K/V tiles that the mask covers entirely are skipped, so the causal
// case does half the work of the full one.  This is the simple version:
// no wgmma, no TMA, no pipelining of the K/V loads, one query head per
// CTA (the G heads of a KV group re-read its K/V tiles, mostly from L2).
//
// Head dims (D, Dv): (64, 64), (128, 128), (64, 128), (128, 64) and
// (256, 256); at 256 the shared-memory tiles below take ~191 KB, inside
// the 227 KB opt-in at one CTA per SM.
//
// Layout: q [B, Sq, H, D], k [B, Sk, KV, D], v [B, Sk, KV, Dv], out
// [B, Sq, H, Dv], all contiguous.  Grid (ceil(Sq/64), H, B); a CTA of four
// warps owns 64 query rows (16 per warp) of one head and walks the K/V
// tiles of 64 keys its rows can see.  Ragged Sq/Sk edges are masked here
// (the Pallas version pads them outside the kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;                  // query rows per CTA
constexpr int BN = 64;                  // keys per K/V tile
constexpr int WARPS = 4;                // 16 query rows each
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;       // the Pallas kernel's mask value

enum MaskKind { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_WINDOW = 2 };

// Shared-memory layout.  Rows are padded (8 bf16 / 4 fp32) against bank
// conflicts; every section stays 32-byte aligned, as WMMA loads require.
template <int D, int DV>
struct Smem {
    static constexpr int LDK = D + 8;    // Q and K tiles, bf16
    static constexpr int LDV = DV + 8;   // V tile, bf16
    static constexpr int LDS = BN + 4;   // scores, fp32
    static constexpr int LDP = BN + 8;   // probabilities, bf16
    static constexpr int LDO = DV + 4;   // output accumulator, fp32
    static constexpr size_t q_off = 0;
    static constexpr size_t k_off = q_off + sizeof(bf16) * BM * LDK;
    static constexpr size_t v_off = k_off + sizeof(bf16) * BN * LDK;
    static constexpr size_t s_off = v_off + sizeof(bf16) * BN * LDV;
    static constexpr size_t p_off = s_off + sizeof(float) * BM * LDS;
    static constexpr size_t o_off = p_off + sizeof(bf16) * BM * LDP;
    static constexpr size_t corr_off = o_off + sizeof(float) * BM * LDO;
    static constexpr size_t l_off = corr_off + sizeof(float) * BM;
    static constexpr size_t bytes = l_off + sizeof(float) * BM;
};

// Copy `n_valid` rows of W bf16 (row `row0` on, `gstride` elements apart)
// into a 64-row shared tile with leading dimension `ld`; rows past n_valid
// are zero-filled so that masked products never meet stale data.
template <int W>
__device__ __forceinline__ void load_rows(bf16* smem, int ld, const bf16* gbase,
                                          long long gstride, int row0,
                                          int n_valid) {
    constexpr int VPR = W / 8;           // 16-byte vectors per row
    for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
        const int r = i / VPR;
        const int c = (i % VPR) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < n_valid) {
            val = *reinterpret_cast<const uint4*>(
                gbase + (long long)(row0 + r) * gstride + c);
        }
        *reinterpret_cast<uint4*>(smem + r * ld + c) = val;
    }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 int Sq, int Sk, int H, int KV, int mask_kind, int window,
                 int q_offset, float scale) {
    using L = Smem<D, DV>;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
    float* Ss = reinterpret_cast<float*>(smem + L::s_off);
    bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
    float* Os = reinterpret_cast<float*>(smem + L::o_off);
    float* corr_s = reinterpret_cast<float*>(smem + L::corr_off);
    float* l_s = reinterpret_cast<float*>(smem + L::l_off);

    const int m0 = blockIdx.x * BM;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (H / KV);
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    const bf16* qb = q + (long long)b * Sq * H * D + (long long)h * D;
    const bf16* kb = k + (long long)b * Sk * KV * D + (long long)hk * D;
    const bf16* vb = v + (long long)b * Sk * KV * DV + (long long)hk * DV;

    load_rows<D>(Qs, L::LDK, qb, (long long)H * D, m0, min(BM, Sq - m0));
    for (int i = threadIdx.x; i < BM * L::LDO; i += THREADS) Os[i] = 0.f;

    // Two lanes own one query row: lane/2 picks the row inside the warp's
    // 16, lane%2 the even or odd score columns.  Both keep the row's m, l.
    const int half = lane & 1;
    const int row = warp * 16 + (lane >> 1);
    const int q_pos = q_offset + m0 + row;
    float m_run = NEG_INF;
    float l_run = 0.f;

    // K/V tiles that any row of this CTA can see.
    int n_lo = 0;
    int n_hi = Sk;
    if (mask_kind != MASK_NONE) {
        n_hi = min(Sk, q_offset + m0 + BM);
        if (mask_kind == MASK_WINDOW) n_lo = max(0, q_offset + m0 - window + 1);
    }
    const int t_lo = n_lo / BN;
    const int t_hi = n_hi > 0 ? (n_hi + BN - 1) / BN : 0;
    __syncthreads();                     // Q tile and zeroed O are visible

    for (int t = t_lo; t < t_hi; ++t) {
        const int n0 = t * BN;
        __syncthreads();                 // every warp is done with the last tile
        load_rows<D>(Ks, L::LDK, kb, (long long)KV * D, n0, min(BN, Sk - n0));
        load_rows<DV>(Vs, L::LDV, vb, (long long)KV * DV, n0, min(BN, Sk - n0));
        __syncthreads();

        // S = Q K^T for this warp's 16 rows: 16 x 64, fp32.
        {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
            for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
            for (int kk = 0; kk < D; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
                wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDK + kk, L::LDK);
#pragma unroll
                for (int j = 0; j < BN / 16; ++j) {
                    // K^T as a col-major 16x16 operand: element (kk', n) at
                    // Ks[(16j + n) * LDK + kk + kk'].
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
                    wmma::load_matrix_sync(bk, Ks + j * 16 * L::LDK + kk, L::LDK);
                    wmma::mma_sync(acc[j], a, bk, acc[j]);
                }
            }
#pragma unroll
            for (int j = 0; j < BN / 16; ++j) {
                wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + j * 16, acc[j],
                                        L::LDS, wmma::mem_row_major);
            }
        }
        __syncwarp();

        // Online softmax on the row: masked scores are NEG_INF and their
        // probabilities exactly 0, as in the Pallas kernel.
        {
            const float* srow = Ss + row * L::LDS;
            float sv[BN / 2];
            uint32_t valid = 0u;
            float mx = NEG_INF;
#pragma unroll
            for (int c = 0; c < BN / 2; ++c) {
                const int col = 2 * c + half;
                const int kpos = n0 + col;
                bool ok = kpos < Sk;
                if (mask_kind == MASK_CAUSAL) {
                    ok = ok && kpos <= q_pos;
                } else if (mask_kind == MASK_WINDOW) {
                    ok = ok && kpos <= q_pos && kpos > q_pos - window;
                }
                const float s = ok ? srow[col] * scale : NEG_INF;
                valid |= (ok ? 1u : 0u) << c;
                sv[c] = s;
                mx = fmaxf(mx, s);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            const float m_new = fmaxf(m_run, mx);
            const float corr = __expf(m_run - m_new);
            float psum = 0.f;
            bf16* prow = Ps + row * L::LDP;
#pragma unroll
            for (int c = 0; c < BN / 2; ++c) {
                const float p = ((valid >> c) & 1u) ? __expf(sv[c] - m_new) : 0.f;
                psum += p;
                prow[2 * c + half] = __float2bfloat16(p);
            }
            psum += __shfl_xor_sync(0xffffffffu, psum, 1);
            l_run = l_run * corr + psum;
            m_run = m_new;
            if (half == 0) corr_s[row] = corr;
        }
        __syncwarp();

        // O = O * corr + P V for the warp's rows.
        for (int i = lane; i < 16 * DV; i += 32) {
            const int r = warp * 16 + i / DV;
            Os[r * L::LDO + i % DV] *= corr_s[r];
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < DV / 16; ++j) {
            float* optr = Os + warp * 16 * L::LDO + j * 16;
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
            wmma::load_matrix_sync(o, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
            for (int kk = 0; kk < BN; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
                wmma::load_matrix_sync(a, Ps + warp * 16 * L::LDP + kk, L::LDP);
                wmma::load_matrix_sync(bv, Vs + kk * L::LDV + j * 16, L::LDV);
                wmma::mma_sync(o, a, bv, o);
            }
            wmma::store_matrix_sync(optr, o, L::LDO, wmma::mem_row_major);
        }
        __syncwarp();
    }

    if (half == 0) l_s[row] = l_run;
    __syncwarp();
    for (int i = lane; i < 16 * (DV / 2); i += 32) {
        const int r = warp * 16 + i / (DV / 2);
        const int c = (i % (DV / 2)) * 2;
        if (m0 + r >= Sq) continue;
        const float denom = fmaxf(l_s[r], 1e-30f);
        const __nv_bfloat162 o2 = __floats2bfloat162_rn(
            Os[r * L::LDO + c] / denom, Os[r * L::LDO + c + 1] / denom);
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((long long)(b * Sq + m0 + r) * H + h) * DV + c) = o2;
    }
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int mask_kind,
                   int window, int q_offset, float scale, cudaStream_t stream) {
    auto kern = flash_fwd_kernel<D, DV>;
    const size_t bytes = Smem<D, DV>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BM - 1) / BM, H, B);
    kern<<<grid, THREADS, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H, KV,
        mask_kind, window, q_offset, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Sk, int H,
                                   int KV, int D, int Dv, int mask_kind,
                                   int window, int q_offset, float scale,
                                   int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (D == 128 && Dv == 128)
        return (int)launch<128, 128>(q, k, v, out, B, Sq, Sk, H, KV, mask_kind,
                                     window, q_offset, scale, st);
    if (D == 64 && Dv == 64)
        return (int)launch<64, 64>(q, k, v, out, B, Sq, Sk, H, KV, mask_kind,
                                   window, q_offset, scale, st);
    if (D == 128 && Dv == 64)
        return (int)launch<128, 64>(q, k, v, out, B, Sq, Sk, H, KV, mask_kind,
                                    window, q_offset, scale, st);
    if (D == 64 && Dv == 128)
        return (int)launch<64, 128>(q, k, v, out, B, Sq, Sk, H, KV, mask_kind,
                                    window, q_offset, scale, st);
    if (D == 256 && Dv == 256)   // recurrentgemma; ~191 KB of shared memory
        return (int)launch<256, 256>(q, k, v, out, B, Sq, Sk, H, KV, mask_kind,
                                     window, q_offset, scale, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
