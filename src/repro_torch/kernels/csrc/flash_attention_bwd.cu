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
// the caller's stream, no atomics, every sum in a fixed order, so two calls
// on one input give the same bits:
// 1. delta: lse log2(e) and delta of every (batch, head, query) row into
//    fp32 scratch [B, H, 2, Sq_pad] (Sq_pad: Sq rounded up to 64, the pad
//    rows 0), so that a step's 64 values are contiguous for TMA and every
//    row stride is a multiple of 16 bytes, as TMA requires.
// 2. dK/dV: one CTA per (batch, KV head, tile of 64 keys), key tile 0 (the
//    heaviest under a causal mask) launched first.  The (head, 64-query
//    tile) steps that the mask lets see one of its keys form one list; the
//    two warpgroups take them in turns, each holding its own fp32 dK and
//    dV for the CTA's 64 keys, and sum them through shared memory at the
//    end.  Per step: S^T = K Q^T and dP^T = V dO^T from shared memory, P^T
//    and dS^T on the accumulators, then dV += P^T dO and dK += dS^T Q with
//    P^T and dS^T as register A operands.
// 3. dQ: one CTA per (batch, head, 128 queries), the heaviest query tiles
//    first; each consumer warpgroup owns 64 rows and walks the 64-key
//    tiles the mask leaves visible: S = Q K^T, dP = dO V^T, dQ += dS K.
//
// What bounds it on the card: tensor-core operations.  At yi-6b's training
// shape (B 4, S 1024, 32 heads / 4 KV of 128, causal) the five products of
// the formula over the causal half are 86.0 GFLOP against ~40 MB of
// inputs and outputs; the split into a dK/dV and a dQ kernel performs
// seven (S and dP once in each), 120 GFLOP.  Folding dQ into the dK/dV
// pass would save two products but, without atomics, needs fp32 dQ
// partials per key tile: 4.5-8.5x dQ's 67 MB in fp32 at that shape,
// written and read again, more time than the two products take.  What the
// design does about the operations:
// - Every product runs on wgmma, fed by TMA through mbarrier rings.  dK/dV
//   loads K and V once; step i's Q, dO, lse and delta go to stage
//   i % STAGES, so each warpgroup owns the stages of its parity and one
//   of its threads keeps them loaded STAGES / 2 steps ahead.  dQ loads Q
//   and dO once; a producer warpgroup (one thread) keeps a ring of K and
//   V tiles full for both consumers, which free each stage through an
//   "empty" mbarrier.  Q and dO are read K-major for S^T and dP^T and
//   MN-major for dK and dV, from the same swizzled tile.
// - Registers: a dK/dV thread holds fp32 dK, dV, S^T and dP^T (192 at D
//   128); the kernel runs 256 threads so that ptxas may give it 231+.  A
//   producer warpgroup beside them (384 threads) caps every thread at 168,
//   and setmaxnreg did not lift that cap for ptxas's allocation (CUDA
//   12.9: the same 920 bytes of spills and serialized wgmma with the
//   consumers raised to 208, 240 or 256 as without it); dQ fits in 168.
// - The mask is evaluated, by selects, only on tiles that cross its edge
//   or the ragged end of Sq or Sk; a row with no visible key (lse -1e30)
//   lies only in such tiles, so its P is 0 before it can overflow.
// - dK/dV uses 64-key CTAs with two warpgroups rather than 128-key ones:
//   at yi-6b's shape its 256 CTAs leave a heaviest CTA near the average
//   per SM, where 128 CTAs of 128 keys would leave one twice the average.
// - dK, dV and dQ leave through a swizzled staging tile and TMA stores,
//   which clip the ragged edge.
// Left for later: overlapping one step's softmax with the next step's
// products inside a warpgroup, persistent CTAs.
//
// Head dims (D, Dv): (64, 64) and (128, 128) by the kernels above; (256,
// 256), recurrentgemma-2b's local attention, by two kernels of their own
// (flash_bwd_dkdv_wide_kernel, flash_bwd_dq_wide_kernel, below the dQ
// kernel) whose two warpgroups share each step, since a thread of the
// split design would need 320 registers there.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int BN = 64;               // keys per dK/dV CTA and per dQ stage
constexpr int BM = 64;               // queries per dK/dV step, per dQ warpgroup
constexpr int Q_BM = 128;            // queries per dQ CTA
constexpr int BOX = 64;              // TMA box width: 64 bf16 = 128 bytes
constexpr int STAGES = 4;            // ring depth of both product kernels
// dK/dV: two warpgroups, each loading its own steps (it owns every other
// stage of the ring).  dQ: two consumer warpgroups, then a producer
// warpgroup of which one thread issues every copy.
constexpr int KV_THREADS = 256;
constexpr int Q_THREADS = 384;
static_assert(STAGES % 2 == 0, "each dK/dV warpgroup owns STAGES / 2 stages");
constexpr float LOG2E = 1.4426950408889634f;
// A wait on a ring stage lasts at most a few steps' work: trap after ~2^22
// polls (well under a second) instead of the default minutes.
constexpr uint32_t POLLS = 1u << 22;

enum MaskKind { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_WINDOW = 2 };

// Whether the query at position qpos (q_offset included) sees `key`;
// without branches, so that an edge tile masks by selects.
__device__ __forceinline__ bool visible(int mask_kind, int window, int qpos,
                                        int key) {
    return (mask_kind == MASK_NONE) |
           ((key <= qpos) & ((mask_kind != MASK_WINDOW) | (key > qpos - window)));
}

// Whether a BM x BN tile (queries from m0, keys from n0) holds a pair that
// the mask hides or that lies past Sq or Sk: only such tiles are masked.
__device__ __forceinline__ bool edge_tile(int m0, int n0, int Sq, int Sk,
                                          int mask_kind, int window,
                                          int q_offset) {
    return m0 + BM > Sq || n0 + BN > Sk ||
           (mask_kind != MASK_NONE && n0 + BN - 1 > q_offset + m0) ||
           (mask_kind == MASK_WINDOW && n0 <= q_offset + m0 + BM - 1 - window);
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// A warpgroup's 64 x W fp32 accumulator (warp w rows 16w .. 16w + 15) as
// bf16 into W / 64 boxes of [64][64], `box_bytes` apart, with TMA's
// 128-byte swizzle: 16-byte chunk c of row r lies at chunk c ^ (r % 8).
template <int W>
__device__ __forceinline__ void stage_bf16(void* tile, int box_bytes,
                                           const float (&acc)[W / 2],
                                           int warp, int lane) {
    unsigned char* base = static_cast<unsigned char*>(tile);
    const int g = lane / 4;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = 16 * warp + g + 8 * r;
            const int off = (j / 8) * box_bytes + row * 128 +
                            (((j % 8) ^ g) << 4) + 4 * (lane % 4);
            *reinterpret_cast<uint32_t*>(base + off) =
                pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
}

// ------------------------------------------------------------------ delta
// Dv / 8 threads per (batch, query, head) row, 8 columns each; writes
// stats[b, h, 0, q] = lse log2(e) and stats[b, h, 1, q] = delta, zeros for
// the pad rows Sq <= q < Sq_pad.
template <int DV>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ out,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ stats, int B, int Sq, int Sq_pad,
                       int H) {
    constexpr int LANES = DV / 8;            // divides 32: a row is in one warp
    const long long rows = (long long)B * Sq_pad * H;
    const long long row =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
    const int c = (threadIdx.x % LANES) * 8;
    const int h = (int)(row % H);
    const int q = (int)((row / H) % Sq_pad);
    const int b = (int)(row / ((long long)H * Sq_pad));
    const bool live = row < rows && q < Sq;
    const long long at = ((long long)b * Sq + q) * H + h;
    float acc = 0.f;
    if (live) {
        const uint4 o = *reinterpret_cast<const uint4*>(out + at * DV + c);
        const uint4 d = *reinterpret_cast<const uint4*>(dout + at * DV + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 df = __bfloat1622float2(d2[e]);
            acc += of.x * df.x + of.y * df.y;
        }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (row < rows && c == 0) {
        float* st = stats + (((long long)b * H + h) * 2) * Sq_pad + q;
        st[0] = live ? lse[at] * LOG2E : 0.f;
        st[Sq_pad] = acc;
    }
}

// ------------------------------------------------------------------ dK/dV
// Shared memory, 1024-byte aligned sections: K and V of the CTA's keys,
// the ring's Q and dO stages, its stats stages ([2][BM] fp32), then the
// mbarriers (K/V's and one per stage).  Mirrored by smem_bytes in
// kernels/flash_attention_bwd.py.
template <int D, int DV>
struct KvLayout {
    static constexpr uint32_t k_bytes = BN * D * 2;
    static constexpr uint32_t v_bytes = BN * DV * 2;
    static constexpr uint32_t q_bytes = BM * D * 2;
    static constexpr uint32_t do_bytes = BM * DV * 2;
    static constexpr uint32_t st_bytes = 2 * BM * 4;
    static constexpr uint32_t k_off = 0;
    static constexpr uint32_t v_off = k_off + k_bytes;
    static constexpr uint32_t q_off = v_off + v_bytes;
    static constexpr uint32_t do_off = q_off + STAGES * q_bytes;
    static constexpr uint32_t st_off = do_off + STAGES * do_bytes;
    static constexpr uint32_t bar_off = st_off + STAGES * st_bytes;
    static constexpr uint32_t bytes = bar_off + 8 * (1 + STAGES) + 1024;
    static constexpr uint32_t stage_tx = q_bytes + do_bytes + st_bytes;
    // The epilogue hands one fp32 accumulator per warpgroup over through
    // the ring's Q and dO stages.
    static_assert((D / 2 + DV / 2) * 128 * 4 <= STAGES * (q_bytes + do_bytes),
                  "exchange does not fit the ring");
};

template <int D, int DV>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tst,
                      const __grid_constant__ CUtensorMap tdk,
                      const __grid_constant__ CUtensorMap tdv, int Sq, int Sk,
                      int H, int KV, int mask_kind, int window, int q_offset,
                      float scale) {
    using L = KvLayout<D, DV>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
    bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
    bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
    float* Sts = reinterpret_cast<float*>(smem + L::st_off);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
    uint64_t* kv_full = bars;
    uint64_t* full = bars + 1;                 // [STAGES]

    const int hk = blockIdx.x;
    const int b = blockIdx.y;
    const int n0 = blockIdx.z * BN;            // key tile 0 first
    const int G = H / KV;
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int ct = tid % 128;

    // Query rows [m_lo, m_hi) that can see a key of this tile; the steps
    // are its query tiles for each of the G heads, head-major.
    int m_lo = 0;
    int m_hi = Sq;
    if (mask_kind != MASK_NONE) {
        m_lo = max(0, n0 - q_offset);
        if (mask_kind == MASK_WINDOW)
            m_hi = min(Sq, n0 + BN - 1 + window - q_offset);
    }
    const int t_lo = m_lo / BM;
    const int n_qt = m_hi > m_lo ? (m_hi + BM - 1) / BM - t_lo : 0;
    const int n_steps = G * n_qt;

    if (tid == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
        fence_barrier_init();
    }
    __syncthreads();

    // Step i (head i / n_qt of the group, query tile t_lo + i % n_qt) into
    // ring stage i % STAGES.
    auto load_step = [&](int i) {
        const int s = i % STAGES;
        const int h = hk * G + i / n_qt;
        const int m0 = (t_lo + i % n_qt) * BM;
        mbar_arrive_expect_tx(full + s, L::stage_tx);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c)
            tma_load_4d(Qs + s * BM * D + c * BM * BOX, &tq, full + s,
                        c * BOX, h, m0, b);
#pragma unroll
        for (int c = 0; c < DV / BOX; ++c)
            tma_load_4d(dOs + s * BM * DV + c * BM * BOX, &tdo, full + s,
                        c * BOX, h, m0, b);
        tma_load_4d(Sts + s * 2 * BM, &tst, full + s, m0, 0, h, b);
    };
    // Warpgroup w computes the steps w, w + 2, w + 4, ... and one of its
    // threads loads them, STAGES / 2 ahead: the warpgroup owns the stages
    // of its parity, so the two never wait on each other.
    if (ct == 0) {
        if (wg == 0) {
            mbar_arrive_expect_tx(kv_full, L::k_bytes + L::v_bytes);
#pragma unroll
            for (int c = 0; c < D / BOX; ++c)
                tma_load_4d(Ks + c * BN * BOX, &tk, kv_full, c * BOX, hk, n0,
                            b);
#pragma unroll
            for (int c = 0; c < DV / BOX; ++c)
                tma_load_4d(Vs + c * BN * BOX, &tv, kv_full, c * BOX, hk, n0,
                            b);
        }
        for (int i = wg; i < min(n_steps, STAGES); i += 2) load_step(i);
    }

    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const float scale_log2 = scale * LOG2E;
    // This thread's two keys (accumulator rows) and first query column.
    const int key0 = n0 + 16 * warp + lane / 4;
    const int col_in = 2 * (lane % 4);

    float dk[D / 2];
    float dv[DV / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;

    const uint64_t k_desc = desc_sw128(Ks, 0, 1024);
    const uint64_t v_desc = desc_sw128(Vs, 0, 1024);
    mbar_wait(kv_full, 0, POLLS);
    for (int i = wg; i < n_steps; i += 2) {
        const int s = i % STAGES;
        const uint32_t parity = (i / STAGES) & 1;
        const int m0 = (t_lo + i % n_qt) * BM;
        const bf16* q_st = Qs + s * BM * D;
        const bf16* do_st = dOs + s * BM * DV;
        const float* lse_st = Sts + s * 2 * BM;
        const float* dlt_st = lse_st + BM;
        mbar_wait(full + s, parity, POLLS);

        // S^T = K Q^T and dP^T = V dO^T: keys x queries, 64 x 64.
        float st[BM / 2];
        float dpt[BM / 2];
        wgmma_fence();
        wgmma_ss_tiles<D>(st, per_step(k_desc), BN * BOX * 2,
                          desc_sw128(q_st, 0, 1024), BM * BOX * 2);
        wgmma_commit();
        wgmma_ss_tiles<DV>(dpt, per_step(v_desc), BN * BOX * 2,
                           desc_sw128(do_st, 0, 1024), BM * BOX * 2);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<BM / 2>(st);

        // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked.
        const bool edge =
            edge_tile(m0, n0, Sq, Sk, mask_kind, window, q_offset);
#pragma unroll
        for (int x = 0; x < BM / 2; ++x) {
            const int col = 8 * (x / 4) + col_in + (x & 1);
            float p = ex2(st[x] * scale_log2 - lse_st[col]);
            if (edge) {
                const int key = key0 + ((x & 2) ? 8 : 0);
                const int row = m0 + col;
                const bool ok = (key < Sk) & (row < Sq) &
                    visible(mask_kind, window, q_offset + row, key);
                p = ok ? p : 0.f;
            }
            st[x] = p;
        }
        wgmma_wait<0>();
        fence_regs<BM / 2>(dpt);
        // dS^T = P^T (dP^T - delta), in place of dP^T.
#pragma unroll
        for (int x = 0; x < BM / 2; ++x) {
            const int col = 8 * (x / 4) + col_in + (x & 1);
            dpt[x] = st[x] * (dpt[x] - dlt_st[col]);
        }
        uint32_t pa[BM / 16][4];
        uint32_t dsa[BM / 16][4];
        to_a<BM>(pa, st);
        to_a<BM>(dsa, dpt);

        // dV += P^T dO and dK += dS^T Q: dO and Q are [queries, width]
        // with the width contiguous, MN-major B operands; atoms of 64
        // columns are one box (BM rows) apart.
        fence_regs<DV / 2>(dv);
        fence_regs<D / 2>(dk);
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
            fence_regs<4>(pa[kk]);
            fence_regs<4>(dsa[kk]);
        }
        const uint64_t do_mn = desc_sw128(do_st, BM * BOX * 2, 1024);
        const uint64_t q_mn = desc_sw128(q_st, BM * BOX * 2, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
            wgmma_rs<DV>(dv, pa[kk], desc_at(do_mn, kk * 16 * BOX * 2));
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
            wgmma_rs<D>(dk, dsa[kk], desc_at(q_mn, kk * 16 * BOX * 2));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<DV / 2>(dv);
        fence_regs<D / 2>(dk);
        // Every warp of this warpgroup is done with stage s: refill it.
        named_barrier_sync(1 + wg, 128);
        if (ct == 0 && i + STAGES < n_steps) load_step(i + STAGES);
    }

    // Epilogue.  Both warpgroups are done with the ring; warpgroup 0 hands
    // its dV to warpgroup 1 and takes warpgroup 1's dK through it, so that
    // each sums one gradient (warpgroup 0's part + warpgroup 1's), stages
    // it as bf16 where K or V lay, and stores it with TMA.
    float* xch = reinterpret_cast<float*>(smem + L::q_off);
    __syncthreads();
    if (wg == 0) {
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) xch[i * 128 + ct] = dv[i];
    } else {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) xch[(DV / 2 + i) * 128 + ct] = dk[i];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i)
            dk[i] = (dk[i] + xch[(DV / 2 + i) * 128 + ct]) * scale;
        stage_bf16<D>(Ks, BN * BOX * 2, dk, warp, lane);
    } else {
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) dv[i] = xch[i * 128 + ct] + dv[i];
        stage_bf16<DV>(Vs, BN * BOX * 2, dv, warp, lane);
    }
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    if (ct == 0) {
        if (wg == 0) {
#pragma unroll
            for (int c = 0; c < D / BOX; ++c)
                tma_store_4d(&tdk, Ks + c * BN * BOX, c * BOX, hk, n0, b);
        } else {
#pragma unroll
            for (int c = 0; c < DV / BOX; ++c)
                tma_store_4d(&tdv, Vs + c * BN * BOX, c * BOX, hk, n0, b);
        }
        bulk_commit();
        bulk_wait_read<0>();
    }
}

// --------------------------------------------------------------------- dQ
// Shared memory: Q and dO of the CTA's 128 rows, the ring's K and V
// stages, then the mbarriers.  Mirrored by smem_bytes in
// kernels/flash_attention_bwd.py.
template <int D, int DV>
struct QLayout {
    static constexpr uint32_t q_bytes = Q_BM * D * 2;
    static constexpr uint32_t do_bytes = Q_BM * DV * 2;
    static constexpr uint32_t k_bytes = BN * D * 2;
    static constexpr uint32_t v_bytes = BN * DV * 2;
    static constexpr uint32_t q_off = 0;
    static constexpr uint32_t do_off = q_off + q_bytes;
    static constexpr uint32_t k_off = do_off + do_bytes;
    static constexpr uint32_t v_off = k_off + STAGES * k_bytes;
    static constexpr uint32_t bar_off = v_off + STAGES * v_bytes;
    static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D, int DV>
__global__ void __launch_bounds__(Q_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdq,
                    const float* __restrict__ stats, int Sq, int Sq_pad,
                    int Sk, int H, int KV, int mask_kind, int window,
                    int q_offset, float scale) {
    using L = QLayout<D, DV>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
    bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
    uint64_t* q_full = bars;
    uint64_t* full = bars + 1;                 // [STAGES]
    uint64_t* empty = bars + 1 + STAGES;       // [STAGES]

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int m0 = (gridDim.z - 1 - blockIdx.z) * Q_BM;   // heaviest first
    const int hk = h / (H / KV);
    const int tid = threadIdx.x;
    const int wg = tid / 128;

    // Key tiles that any row of this CTA can see (the forward's range).
    int n_lo = 0;
    int n_hi = Sk;
    if (mask_kind != MASK_NONE) {
        n_hi = min(Sk, q_offset + m0 + Q_BM);
        if (mask_kind == MASK_WINDOW) n_lo = max(0, q_offset + m0 - window + 1);
    }
    const int t_lo = n_lo / BN;
    const int n_tiles = max(0, (n_hi + BN - 1) / BN - t_lo);

    if (tid == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 8);           // every consumer warp
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ------------------------------------------------------ producer
        if (tid == 256 && n_tiles > 0) {
            mbar_arrive_expect_tx(q_full, L::q_bytes + L::do_bytes);
#pragma unroll
            for (int c = 0; c < D / BOX; ++c)
                tma_load_4d(Qs + c * Q_BM * BOX, &tq, q_full, c * BOX, h, m0, b);
#pragma unroll
            for (int c = 0; c < DV / BOX; ++c)
                tma_load_4d(dOs + c * Q_BM * BOX, &tdo, q_full, c * BOX, h, m0,
                            b);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % STAGES;
                if (i >= STAGES)
                    mbar_wait(empty + s, ((i / STAGES) - 1) & 1, POLLS);
                const int n0 = (t_lo + i) * BN;
                mbar_arrive_expect_tx(full + s, L::k_bytes + L::v_bytes);
#pragma unroll
                for (int c = 0; c < D / BOX; ++c)
                    tma_load_4d(Ks + s * BN * D + c * BN * BOX, &tk, full + s,
                                c * BOX, hk, n0, b);
#pragma unroll
                for (int c = 0; c < DV / BOX; ++c)
                    tma_load_4d(Vs + s * BN * DV + c * BN * BOX, &tv, full + s,
                                c * BOX, hk, n0, b);
            }
        }
        return;
    }

    // ------------------------------------------------------- consumers
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const float scale_log2 = scale * LOG2E;
    const int m0w = m0 + BM * wg;              // this warpgroup's 64 rows
    const int row0 = m0w + 16 * warp + lane / 4;
    const int col_in = 2 * (lane % 4);
    const bool live = m0w < Sq;
    const float* st_h = stats + ((long long)b * H + h) * 2 * Sq_pad;
    float lse2[2];
    float dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        lse2[r] = row < Sq ? st_h[row] : 0.f;
        dlt[r] = row < Sq ? st_h[Sq_pad + row] : 0.f;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    // This warpgroup's rows of Q and dO, box 0.
    const uint64_t q_desc = desc_sw128(Qs + wg * BM * BOX, 0, 1024);
    const uint64_t do_desc = desc_sw128(dOs + wg * BM * BOX, 0, 1024);

    if (n_tiles > 0) mbar_wait(q_full, 0, POLLS);
    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t parity = (i / STAGES) & 1;
        const int n0 = (t_lo + i) * BN;
        // Whether any of this warpgroup's rows sees a key of the tile.
        bool sees = live;
        if (mask_kind != MASK_NONE) sees = sees && n0 <= q_offset + m0w + BM - 1;
        if (mask_kind == MASK_WINDOW)
            sees = sees && n0 + BN - 1 > q_offset + m0w - window;
        const bf16* k_st = Ks + s * BN * D;
        const bf16* v_st = Vs + s * BN * DV;
        mbar_wait(full + s, parity, POLLS);
        if (sees) {
            float sc[BN / 2];
            float dp[BN / 2];
            wgmma_fence();
            wgmma_ss_tiles<D>(sc, per_step(q_desc), Q_BM * BOX * 2,
                              desc_sw128(k_st, 0, 1024), BN * BOX * 2);
            wgmma_commit();
            wgmma_ss_tiles<DV>(dp, per_step(do_desc), Q_BM * BOX * 2,
                               desc_sw128(v_st, 0, 1024), BN * BOX * 2);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs<BN / 2>(sc);
            const bool edge =
                edge_tile(m0w, n0, Sq, Sk, mask_kind, window, q_offset);
#pragma unroll
            for (int x = 0; x < BN / 2; ++x) {
                const int r = (x >> 1) & 1;
                float p = ex2(sc[x] * scale_log2 - lse2[r]);
                if (edge) {
                    const int key = n0 + 8 * (x / 4) + col_in + (x & 1);
                    const int row = row0 + 8 * r;
                    const bool ok = (key < Sk) & (row < Sq) &
                        visible(mask_kind, window, q_offset + row, key);
                    p = ok ? p : 0.f;
                }
                sc[x] = p;
            }
            wgmma_wait<0>();
            fence_regs<BN / 2>(dp);
#pragma unroll
            for (int x = 0; x < BN / 2; ++x)
                dp[x] = sc[x] * (dp[x] - dlt[(x >> 1) & 1]);
            uint32_t dsa[BN / 16][4];
            to_a<BN>(dsa, dp);
            // dQ += dS K: K is [keys, D] with D contiguous, an MN-major B
            // operand; atoms of 64 columns are one box (BN rows) apart.
            fence_regs<D / 2>(dq);
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) fence_regs<4>(dsa[kk]);
            const uint64_t k_mn = desc_sw128(k_st, BN * BOX * 2, 1024);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk)
                wgmma_rs<D>(dq, dsa[kk], desc_at(k_mn, kk * 16 * BOX * 2));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<D / 2>(dq);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);   // the stage is free again
    }

    // Epilogue: scale dQ, stage it as bf16 over this warpgroup's own rows
    // of Q (no other warpgroup reads them) and store it with TMA.
    if (!live) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] *= scale;
    bf16* stage = Qs + wg * BM * BOX;
    stage_bf16<D>(stage, Q_BM * BOX * 2, dq, warp, lane);
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    if (tid % 128 == 0) {
#pragma unroll
        for (int c = 0; c < D / BOX; ++c)
            tma_store_4d(&tdq, stage + c * Q_BM * BOX, c * BOX, h, m0w, b);
        bulk_commit();
        bulk_wait_read<0>();
    }
}

// ------------------------------------------------- (256, 256): dK/dV
// At D = Dv = 256 the split-step design above fits neither registers nor
// shared memory: a thread of it holds dK and dV (256 fp32) beside S^T and
// dP^T, and K, V and a four-stage ring of Q and dO take 323 KB.  Here the
// two warpgroups of a CTA work on the same step instead: warpgroup 0 forms
// S^T = K Q^T and P^T, hands P^T (fp32) to warpgroup 1 through shared
// memory and accumulates dV += P^T dO; warpgroup 1 forms dP^T = V dO^T,
// then dS^T from P^T, and accumulates dK += dS^T Q.  Both run the same
// wgmma sequence on other operands, so each thread holds one 64 x 256
// accumulator (128 fp32) and one 64 x 64 product (32).  The ring has two
// stages of Q, dO, lse and delta; thread 0 refills the stage of step
// i - 1 at step i's barrier, where both warpgroups are done with it.  P^T
// is double buffered by step parity, so one barrier a step orders its
// writes and reads.  Under MQA one CTA per (KV head, 64 keys) leaves most
// SMs idle (64 CTAs at recurrentgemma-2b's training shape, key tile 0
// walking 160 steps), so a CTA takes a slice of its group's heads instead
// (`splits` slices, chosen by the wrapper so that the heaviest CTA walks
// no more steps than the average SM): each slice writes fp32 parts of dK
// and dV, and flash_bwd_dkdv_reduce_kernel sums them in slice order (one
// slice included).  Mirrored by smem_bytes and wide_splits in
// kernels/flash_attention_bwd.py.
constexpr int WIDE_STAGES = 2;       // ring depth of both (256, 256) kernels

template <int D>
struct KvWideLayout {
    static constexpr uint32_t k_bytes = BN * D * 2;
    static constexpr uint32_t q_bytes = BM * D * 2;
    static constexpr uint32_t st_bytes = 2 * BM * 4;
    static constexpr uint32_t p_bytes = BN * BM * 4;
    static constexpr uint32_t k_off = 0;
    static constexpr uint32_t v_off = k_off + k_bytes;
    static constexpr uint32_t q_off = v_off + k_bytes;
    static constexpr uint32_t do_off = q_off + WIDE_STAGES * q_bytes;
    static constexpr uint32_t st_off = do_off + WIDE_STAGES * q_bytes;
    static constexpr uint32_t p_off = st_off + WIDE_STAGES * st_bytes;
    static constexpr uint32_t bar_off = p_off + 2 * p_bytes;
    static constexpr uint32_t bytes = bar_off + 8 * (1 + WIDE_STAGES) + 1024;
    static constexpr uint32_t stage_tx = 2 * q_bytes + st_bytes;
};
static_assert(KvWideLayout<256>::bytes <= 232448, "dK/dV (256, 256) fits");

template <int D>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dkdv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tst,
                           float* __restrict__ part, int splits, int Sq,
                           int Sk, int H, int KV, int mask_kind, int window,
                           int q_offset, float scale) {
    using L = KvWideLayout<D>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
    bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
    bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
    float* Sts = reinterpret_cast<float*>(smem + L::st_off);
    float* Ps = reinterpret_cast<float*>(smem + L::p_off);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
    uint64_t* kv_full = bars;
    uint64_t* full = bars + 1;                 // [WIDE_STAGES]

    const int hk = blockIdx.x / splits;
    const int split = blockIdx.x % splits;     // slice of the group's heads
    const int b = blockIdx.y;
    const int n0 = blockIdx.z * BN;            // key tile 0 first
    const int G = H / KV;
    const int g_per = (G + splits - 1) / splits;
    const int g_lo = split * g_per;
    const int n_heads = max(0, min(G, g_lo + g_per) - g_lo);
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int ct = tid % 128;

    // The steps, as in flash_bwd_dkdv_kernel: the query tiles that can see
    // a key of this tile, for each head of this CTA's slice, head-major.
    int m_lo = 0;
    int m_hi = Sq;
    if (mask_kind != MASK_NONE) {
        m_lo = max(0, n0 - q_offset);
        if (mask_kind == MASK_WINDOW)
            m_hi = min(Sq, n0 + BN - 1 + window - q_offset);
    }
    const int t_lo = m_lo / BM;
    const int n_qt = m_hi > m_lo ? (m_hi + BM - 1) / BM - t_lo : 0;
    const int n_steps = n_heads * n_qt;

    if (tid == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < WIDE_STAGES; ++s) mbar_init(full + s, 1);
        fence_barrier_init();
    }
    __syncthreads();

    auto load_step = [&](int i) {
        const int s = i % WIDE_STAGES;
        const int h = hk * G + g_lo + i / n_qt;
        const int m0 = (t_lo + i % n_qt) * BM;
        mbar_arrive_expect_tx(full + s, L::stage_tx);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c) {
            tma_load_4d(Qs + s * BM * D + c * BM * BOX, &tq, full + s,
                        c * BOX, h, m0, b);
            tma_load_4d(dOs + s * BM * D + c * BM * BOX, &tdo, full + s,
                        c * BOX, h, m0, b);
        }
        tma_load_4d(Sts + s * 2 * BM, &tst, full + s, m0, 0, h, b);
    };
    if (tid == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::k_bytes);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c) {
            tma_load_4d(Ks + c * BN * BOX, &tk, kv_full, c * BOX, hk, n0, b);
            tma_load_4d(Vs + c * BN * BOX, &tv, kv_full, c * BOX, hk, n0, b);
        }
        for (int i = 0; i < min(n_steps, WIDE_STAGES); ++i) load_step(i);
    }

    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const float scale_log2 = scale * LOG2E;
    const int key0 = n0 + 16 * warp + lane / 4;
    const int col_in = 2 * (lane % 4);

    // dV (warpgroup 0) or dK (warpgroup 1), 64 keys x D.
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // The first product's A: K (S^T = K Q^T) or V (dP^T = V dO^T).
    const uint64_t a_desc = desc_sw128(wg == 0 ? Ks : Vs, 0, 1024);
    mbar_wait(kv_full, 0, POLLS);
    for (int i = 0; i < n_steps; ++i) {
        const int s = i % WIDE_STAGES;
        const uint32_t parity = (i / WIDE_STAGES) & 1;
        const int m0 = (t_lo + i % n_qt) * BM;
        const bf16* q_st = Qs + s * BM * D;
        const bf16* do_st = dOs + s * BM * D;
        const float* lse_st = Sts + s * 2 * BM;
        const float* dlt_st = lse_st + BM;
        float* p_st = Ps + (i % 2) * BN * BM;
        mbar_wait(full + s, parity, POLLS);

        // S^T or dP^T: keys x queries, 64 x 64.
        float x[BM / 2];
        wgmma_fence();
        wgmma_ss_tiles<D>(x, per_step(a_desc), BN * BOX * 2,
                          desc_sw128(wg == 0 ? q_st : do_st, 0, 1024),
                          BM * BOX * 2);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BM / 2>(x);
        if (wg == 0) {
            // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked;
            // warpgroup 1 reads it in this thread's accumulator order.
            const bool edge =
                edge_tile(m0, n0, Sq, Sk, mask_kind, window, q_offset);
#pragma unroll
            for (int j = 0; j < BM / 2; ++j) {
                const int col = 8 * (j / 4) + col_in + (j & 1);
                float p = ex2(x[j] * scale_log2 - lse_st[col]);
                if (edge) {
                    const int key = key0 + ((j & 2) ? 8 : 0);
                    const int row = m0 + col;
                    const bool ok = (key < Sk) & (row < Sq) &
                        visible(mask_kind, window, q_offset + row, key);
                    p = ok ? p : 0.f;
                }
                x[j] = p;
                p_st[j * 128 + ct] = p;
            }
        }
        // P^T of step i is in place, and both warpgroups are done with
        // step i - 1's stage: refill it with step i + 1.
        named_barrier_sync(1, KV_THREADS);
        if (tid == 0 && i >= 1 && i + 1 < n_steps) load_step(i + 1);
        if (wg == 1) {
            // dS^T = P^T (dP^T - delta), in place of dP^T.
#pragma unroll
            for (int j = 0; j < BM / 2; ++j) {
                const int col = 8 * (j / 4) + col_in + (j & 1);
                x[j] = p_st[j * 128 + ct] * (x[j] - dlt_st[col]);
            }
        }
        uint32_t xa[BM / 16][4];
        to_a<BM>(xa, x);

        // dV += P^T dO or dK += dS^T Q: dO and Q are [queries, width]
        // with the width contiguous, MN-major B operands.
        fence_regs<D / 2>(acc);
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) fence_regs<4>(xa[kk]);
        const uint64_t b_mn =
            desc_sw128(wg == 0 ? do_st : q_st, BM * BOX * 2, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
            wgmma_rs<D>(acc, xa[kk], desc_at(b_mn, kk * 16 * BOX * 2));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(acc);
    }

    // This slice's fp32 part of dK or dV into part[wg == 0 ? 1 : 0, split,
    // b, key, hk, :] ([2, splits, B, Sk, KV, D]), summed over the slices
    // (and dK scaled) by flash_bwd_dkdv_reduce_kernel.
    const long long n = (long long)gridDim.y * Sk * KV * D;
    float* out = part + ((wg == 0 ? (long long)splits : 0) + split) * n +
                 (long long)b * Sk * KV * D + hk * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int key = key0 + 8 * r;
            if (key < Sk)
                *reinterpret_cast<float2*>(
                    out + (long long)key * KV * D + 8 * j + col_in) =
                    make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
}

// The slices' fp32 parts of dK and dV ([2, splits, n], n = B Sk KV D)
// summed in slice order, dK scaled, into the bf16 gradients; four
// elements a thread.
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_reduce_kernel(const float* __restrict__ part,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             long long n, int splits, float scale) {
    const long long i =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    if (i >= 2 * n) return;
    const int which = i >= n;                  // 0: dK, 1: dV
    const long long e = i - which * n;
    const float* p = part + (long long)which * splits * n + e;
    float4 s = *reinterpret_cast<const float4*>(p);
    for (int k = 1; k < splits; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(p + k * n);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
    }
    const float f = which ? 1.f : scale;
    uint2 o;
    o.x = pack_bf16(s.x * f, s.y * f);
    o.y = pack_bf16(s.z * f, s.w * f);
    *reinterpret_cast<uint2*>((which ? dv : dk) + e) = o;
}

// ---------------------------------------------------- (256, 256): dQ
// One CTA per (batch, head, 64 queries), 256 threads, no producer
// warpgroup: warpgroup 0 forms S = Q K^T and P, which it hands to
// warpgroup 1 (fp32) through shared memory; warpgroup 1 forms dP = dO V^T
// and dS, which it stages as a bf16 wgmma operand; then each warpgroup
// accumulates its half of dQ's columns, dQ[:, 128 w ..] += dS K[:, 128 w
// ..], from shared memory (64 fp32 a thread).  Q and dO load once; K and
// V through a two-stage ring that thread 0 refills as in the dK/dV kernel.
// Two barriers a key tile: P in place, then dS.  Mirrored by smem_bytes
// and dq_tiles_wide in kernels/flash_attention_bwd.py.
template <int D>
struct QWideLayout {
    static constexpr uint32_t q_bytes = BM * D * 2;
    static constexpr uint32_t k_bytes = BN * D * 2;
    static constexpr uint32_t ds_bytes = BM * BN * 2;
    static constexpr uint32_t p_bytes = BM * BN * 4;
    static constexpr uint32_t q_off = 0;
    static constexpr uint32_t do_off = q_off + q_bytes;
    static constexpr uint32_t k_off = do_off + q_bytes;
    static constexpr uint32_t v_off = k_off + WIDE_STAGES * k_bytes;
    static constexpr uint32_t ds_off = v_off + WIDE_STAGES * k_bytes;
    static constexpr uint32_t p_off = ds_off + ds_bytes;
    static constexpr uint32_t bar_off = p_off + p_bytes;
    static constexpr uint32_t bytes = bar_off + 8 * (1 + WIDE_STAGES) + 1024;
};
static_assert(QWideLayout<256>::bytes <= 232448, "dQ (256, 256) fits");

template <int D>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdq,
                         const float* __restrict__ stats, int Sq, int Sq_pad,
                         int Sk, int H, int KV, int mask_kind, int window,
                         int q_offset, float scale) {
    using L = QWideLayout<D>;
    constexpr int HALF = D / 2;                // dQ columns a warpgroup
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
    bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
    bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds_off);
    float* Ps = reinterpret_cast<float*>(smem + L::p_off);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
    uint64_t* q_full = bars;
    uint64_t* full = bars + 1;                 // [WIDE_STAGES]

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int m0 = (gridDim.z - 1 - blockIdx.z) * BM;    // heaviest first
    const int hk = h / (H / KV);
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int ct = tid % 128;

    // Key tiles that a row of this CTA sees (every tile of the range holds
    // a visible pair).
    int n_lo = 0;
    int n_hi = Sk;
    if (mask_kind != MASK_NONE) {
        n_hi = min(Sk, q_offset + min(m0 + BM, Sq));
        if (mask_kind == MASK_WINDOW) n_lo = max(0, q_offset + m0 - window + 1);
    }
    const int t_lo = n_lo / BN;
    const int n_tiles = n_hi > n_lo ? (n_hi + BN - 1) / BN - t_lo : 0;

    if (tid == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < WIDE_STAGES; ++s) mbar_init(full + s, 1);
        fence_barrier_init();
    }
    __syncthreads();

    auto load_tile = [&](int i) {
        const int s = i % WIDE_STAGES;
        const int n0 = (t_lo + i) * BN;
        mbar_arrive_expect_tx(full + s, 2 * L::k_bytes);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c) {
            tma_load_4d(Ks + s * BN * D + c * BN * BOX, &tk, full + s,
                        c * BOX, hk, n0, b);
            tma_load_4d(Vs + s * BN * D + c * BN * BOX, &tv, full + s,
                        c * BOX, hk, n0, b);
        }
    };
    if (tid == 0 && n_tiles > 0) {
        mbar_arrive_expect_tx(q_full, 2 * L::q_bytes);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c) {
            tma_load_4d(Qs + c * BM * BOX, &tq, q_full, c * BOX, h, m0, b);
            tma_load_4d(dOs + c * BM * BOX, &tdo, q_full, c * BOX, h, m0, b);
        }
        for (int i = 0; i < min(n_tiles, WIDE_STAGES); ++i) load_tile(i);
    }

    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const float scale_log2 = scale * LOG2E;
    const int row0 = m0 + 16 * warp + lane / 4;
    const int col_in = 2 * (lane % 4);
    const float* st_h = stats + ((long long)b * H + h) * 2 * Sq_pad;
    float lse2[2];
    float dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        lse2[r] = row < Sq ? st_h[row] : 0.f;
        dlt[r] = row < Sq ? st_h[Sq_pad + row] : 0.f;
    }

    float acc[HALF / 2];
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) acc[i] = 0.f;
    // The first product's A: Q (S = Q K^T) or dO (dP = dO V^T).
    const uint64_t a_desc = desc_sw128(wg == 0 ? Qs : dOs, 0, 1024);
    const uint64_t ds_desc = desc_sw128(dSs, 0, 1024);

    if (n_tiles > 0) mbar_wait(q_full, 0, POLLS);
    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % WIDE_STAGES;
        const uint32_t parity = (i / WIDE_STAGES) & 1;
        const int n0 = (t_lo + i) * BN;
        const bf16* k_st = Ks + s * BN * D;
        const bf16* v_st = Vs + s * BN * D;
        mbar_wait(full + s, parity, POLLS);

        // S or dP: queries x keys, 64 x 64.
        float x[BN / 2];
        wgmma_fence();
        wgmma_ss_tiles<D>(x, per_step(a_desc), BM * BOX * 2,
                          desc_sw128(wg == 0 ? k_st : v_st, 0, 1024),
                          BN * BOX * 2);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BN / 2>(x);
        if (wg == 0) {
            const bool edge =
                edge_tile(m0, n0, Sq, Sk, mask_kind, window, q_offset);
#pragma unroll
            for (int j = 0; j < BN / 2; ++j) {
                const int r = (j >> 1) & 1;
                float p = ex2(x[j] * scale_log2 - lse2[r]);
                if (edge) {
                    const int key = n0 + 8 * (j / 4) + col_in + (j & 1);
                    const int row = row0 + 8 * r;
                    const bool ok = (key < Sk) & (row < Sq) &
                        visible(mask_kind, window, q_offset + row, key);
                    p = ok ? p : 0.f;
                }
                Ps[j * 128 + ct] = p;
            }
        }
        // P of tile i is in place, and both warpgroups are done with tile
        // i - 1's stage: refill it with tile i + 1.
        named_barrier_sync(1, KV_THREADS);
        if (tid == 0 && i >= 1 && i + 1 < n_tiles) load_tile(i + 1);
        if (wg == 1) {
            // dS = P (dP - delta), as bf16 into a K-major wgmma tile.
#pragma unroll
            for (int j = 0; j < BN / 2; ++j)
                x[j] = Ps[j * 128 + ct] * (x[j] - dlt[(j >> 1) & 1]);
            stage_bf16<BN>(dSs, BM * BOX * 2, x, warp, lane);
            fence_proxy_async();
        }
        named_barrier_sync(1, KV_THREADS);

        // dQ[:, half] += dS K[:, half]: K is [keys, D] with D contiguous, an
        // MN-major B operand; this warpgroup's columns start at box
        // HALF / 64 w.
        fence_regs<HALF / 2>(acc);
        const uint64_t k_mn =
            desc_sw128(k_st + wg * (HALF / BOX) * BN * BOX, BN * BOX * 2, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
            wgmma_ss<HALF, 0, 1>(acc, desc_at(ds_desc, kk * 32),
                                 desc_at(k_mn, kk * 16 * BOX * 2), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<HALF / 2>(acc);
    }

    // Epilogue: scale this warpgroup's columns of dQ, stage them as bf16
    // over its half of Q (warpgroup 0 last read Q before the last tile's
    // first barrier) and store them with TMA.
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) acc[i] *= scale;
    bf16* stage = Qs + wg * (HALF / BOX) * BM * BOX;
    stage_bf16<HALF>(stage, BM * BOX * 2, acc, warp, lane);
    fence_proxy_async();
    named_barrier_sync(2 + wg, 128);
    if (ct == 0) {
#pragma unroll
        for (int c = 0; c < HALF / BOX; ++c)
            tma_store_4d(&tdq, stage + c * BM * BOX,
                         (wg * (HALF / BOX) + c) * BOX, h, m0, b);
        bulk_commit();
        bulk_wait_read<0>();
    }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// Rank-4 map over a contiguous tensor of dims {d0, d1, d2, d3} (innermost
// first) with boxes `box`; boxes past the edge read as zeros and are
// clipped when stored.
cudaError_t make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                     int elem, const cuuint64_t (&dims)[4],
                     const cuuint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t strides[3] = {dims[0] * elem, dims[0] * dims[1] * elem,
                                   dims[0] * dims[1] * dims[2] * elem};
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    const CUresult r = encode(
        map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 [batch, seq, heads, width] tensor in boxes of 64 columns x `rows`
// positions of one head, 128-byte swizzled.
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, int width, int heads,
                     int seq, int batch, int rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                                (cuuint64_t)seq, (cuuint64_t)batch};
    const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
    return make_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dims, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The delta pass of either design: lse log2(e) and delta into stats.
template <int DV>
cudaError_t launch_delta(const void* out, const void* dout, const void* lse,
                         void* stats, int B, int Sq, int Sq_pad, int H,
                         cudaStream_t stream) {
    const long long threads = (long long)B * Sq_pad * H * (DV / 8);
    flash_bwd_delta_kernel<DV><<<(unsigned)((threads + 255) / 256), 256, 0,
                                 stream>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<float*>(stats), B, Sq,
        Sq_pad, H);
    return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* stats, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int KV, int mask_kind, int window,
                   int q_offset, float scale, cudaStream_t stream) {
    const int Sq_pad = (Sq + BM - 1) / BM * BM;
    cudaError_t err =
        launch_delta<DV>(out, dout, lse, stats, B, Sq, Sq_pad, H, stream);
    if (err != cudaSuccess) return err;

    CUtensorMap tq, tdo, tk, tv, tst, tdk, tdv, tq2, tdo2, tdq;
    const cuuint64_t st_dims[4] = {(cuuint64_t)Sq_pad, 2, (cuuint64_t)H,
                                   (cuuint64_t)B};
    const cuuint32_t st_box[4] = {BM, 2, 1, 1};
    err = bf16_map(&tq, q, D, H, Sq, B, BM);
    if (err == cudaSuccess) err = bf16_map(&tdo, dout, DV, H, Sq, B, BM);
    if (err == cudaSuccess) err = bf16_map(&tk, k, D, KV, Sk, B, BN);
    if (err == cudaSuccess) err = bf16_map(&tv, v, DV, KV, Sk, B, BN);
    if (err == cudaSuccess)
        err = make_map(&tst, stats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                       st_dims, st_box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess) err = bf16_map(&tdk, dk, D, KV, Sk, B, BN);
    if (err == cudaSuccess) err = bf16_map(&tdv, dv, DV, KV, Sk, B, BN);
    if (err == cudaSuccess) err = bf16_map(&tq2, q, D, H, Sq, B, Q_BM);
    if (err == cudaSuccess) err = bf16_map(&tdo2, dout, DV, H, Sq, B, Q_BM);
    if (err == cudaSuccess) err = bf16_map(&tdq, dq, D, H, Sq, B, BM);
    if (err != cudaSuccess) return err;

    auto kv_kern = flash_bwd_dkdv_kernel<D, DV>;
    constexpr int kv_bytes = KvLayout<D, DV>::bytes;
    err = cudaFuncSetAttribute(kv_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_bytes);
    if (err != cudaSuccess) return err;
    dim3 kv_grid(KV, B, (Sk + BN - 1) / BN);
    kv_kern<<<kv_grid, KV_THREADS, kv_bytes, stream>>>(
        tq, tdo, tk, tv, tst, tdk, tdv, Sq, Sk, H, KV, mask_kind, window,
        q_offset, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    auto q_kern = flash_bwd_dq_kernel<D, DV>;
    constexpr int q_bytes = QLayout<D, DV>::bytes;
    err = cudaFuncSetAttribute(q_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_bytes);
    if (err != cudaSuccess) return err;
    dim3 q_grid(H, B, (Sq + Q_BM - 1) / Q_BM);
    q_kern<<<q_grid, Q_THREADS, q_bytes, stream>>>(
        tq2, tdo2, tk, tv, tdq, static_cast<const float*>(stats), Sq, Sq_pad,
        Sk, H, KV, mask_kind, window, q_offset, scale);
    return cudaGetLastError();
}

// The (256, 256) pair: the delta pass, then the two kernels whose
// warpgroups share each step, with the sum of the dK/dV slices' parts
// between them.
template <int D>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* stats, void* dq, void* dk, void* dv, void* part,
                        int splits, int B, int Sq, int Sk, int H, int KV,
                        int mask_kind, int window, int q_offset, float scale,
                        cudaStream_t stream) {
    const int Sq_pad = (Sq + BM - 1) / BM * BM;
    cudaError_t err =
        launch_delta<D>(out, dout, lse, stats, B, Sq, Sq_pad, H, stream);
    if (err != cudaSuccess) return err;

    CUtensorMap tq, tdo, tk, tv, tst, tdq;
    const cuuint64_t st_dims[4] = {(cuuint64_t)Sq_pad, 2, (cuuint64_t)H,
                                   (cuuint64_t)B};
    const cuuint32_t st_box[4] = {BM, 2, 1, 1};
    err = bf16_map(&tq, q, D, H, Sq, B, BM);
    if (err == cudaSuccess) err = bf16_map(&tdo, dout, D, H, Sq, B, BM);
    if (err == cudaSuccess) err = bf16_map(&tk, k, D, KV, Sk, B, BN);
    if (err == cudaSuccess) err = bf16_map(&tv, v, D, KV, Sk, B, BN);
    if (err == cudaSuccess)
        err = make_map(&tst, stats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                       st_dims, st_box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess) err = bf16_map(&tdq, dq, D, H, Sq, B, BM);
    if (err != cudaSuccess) return err;

    auto kv_kern = flash_bwd_dkdv_wide_kernel<D>;
    constexpr int kv_bytes = KvWideLayout<D>::bytes;
    err = cudaFuncSetAttribute(kv_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_bytes);
    if (err != cudaSuccess) return err;
    kv_kern<<<dim3(KV * splits, B, (Sk + BN - 1) / BN), KV_THREADS,
              kv_bytes, stream>>>(tq, tdo, tk, tv, tst,
                                  static_cast<float*>(part), splits, Sq, Sk,
                                  H, KV, mask_kind, window, q_offset, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long n = (long long)B * Sk * KV * D;
    flash_bwd_dkdv_reduce_kernel<<<(unsigned)((2 * n / 4 + 255) / 256), 256,
                                   0, stream>>>(
        static_cast<const float*>(part), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), n, splits, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    auto q_kern = flash_bwd_dq_wide_kernel<D>;
    constexpr int q_bytes = QWideLayout<D>::bytes;
    err = cudaFuncSetAttribute(q_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_bytes);
    if (err != cudaSuccess) return err;
    q_kern<<<dim3(H, B, (Sq + BM - 1) / BM), KV_THREADS, q_bytes, stream>>>(
        tq, tdo, tk, tv, tdq, static_cast<const float*>(stats), Sq, Sq_pad,
        Sk, H, KV, mask_kind, window, q_offset, scale);
    return cudaGetLastError();
}

}  // namespace

// Gradients of flash attention.  Sq, Sk and B must be positive (the
// wrapper answers the empty cases); stats is fp32 scratch [B, H, 2,
// Sq_pad] with Sq_pad = Sq rounded up to a multiple of 64.  At (256, 256)
// the dK/dV kernel takes each KV group's heads in `splits` slices, one
// CTA each, and part is fp32 scratch [2, splits, B, Sk, KV, 256] for
// their parts (unused by the other pairs).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* stats, void* dq, void* dk, void* dv,
                                   void* part, int splits, int B, int Sq,
                                   int Sk, int H, int KV, int D, int Dv,
                                   int mask_kind, int window, int q_offset,
                                   float scale, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (D == 128 && Dv == 128)
        return (int)launch<128, 128>(q, k, v, out, dout, lse, stats, dq, dk,
                                     dv, B, Sq, Sk, H, KV, mask_kind, window,
                                     q_offset, scale, st);
    if (D == 64 && Dv == 64)
        return (int)launch<64, 64>(q, k, v, out, dout, lse, stats, dq, dk, dv,
                                   B, Sq, Sk, H, KV, mask_kind, window,
                                   q_offset, scale, st);
    if (D == 256 && Dv == 256) {  // recurrentgemma's local attention
        if (splits < 1 || part == nullptr)
            return (int)cudaErrorInvalidValue;
        return (int)launch_wide<256>(q, k, v, out, dout, lse, stats, dq, dk,
                                     dv, part, splits, B, Sq, Sk, H, KV,
                                     mask_kind, window, q_offset, scale, st);
    }
    return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the dK/dV kernel (kernel 0) or the dQ kernel
// (kernel 1) for a head-dim pair (at (256, 256) the wide kernels'); -1 for
// a pair the backward is not built for.
extern "C" long flash_attention_bwd_smem_bytes(int D, int Dv, int kernel) {
    if (D == 128 && Dv == 128)
        return kernel == 0 ? (long)KvLayout<128, 128>::bytes
                           : (long)QLayout<128, 128>::bytes;
    if (D == 64 && Dv == 64)
        return kernel == 0 ? (long)KvLayout<64, 64>::bytes
                           : (long)QLayout<64, 64>::bytes;
    if (D == 256 && Dv == 256)
        return kernel == 0 ? (long)KvWideLayout<256>::bytes
                           : (long)QWideLayout<256>::bytes;
    return -1;
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
