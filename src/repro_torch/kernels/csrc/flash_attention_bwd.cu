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
// Head dims (D, Dv): (64, 64), (128, 128) and (128, 64) (minicpm3-4b's
// MLA, qk 96 zero-padded to 128) by the kernels above, and the reduced
// configs' (32, 32) and (64, 32) (reduced MLA, qk 48 padded to 64) by
// the same kernels on tiles of (64, 64) (tile_width): their tensor maps
// are 32 columns wide, so the 64-column boxes load zeros past column 32
// (Q, K, V and dO alike), the products give zeros there, and the stores
// of dQ, dK and dV clip the box to the tensor; the delta pass reads out
// and dout at their true width.  (256, 256),
// recurrentgemma-2b's local attention, and (192, 128), deepseek-v2-lite's
// MLA, by two kernels of their own (flash_bwd_dkdv_wide_kernel,
// flash_bwd_dq_wide_kernel, below the dQ kernel) whose two warpgroups
// share each step, since a thread of the split design would need 320 (at
// (256, 256)) or ~256 (at (192, 128)) registers there, and (192, 128)'s
// split dQ tiles 245,760 B of shared memory.

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
// The width of the product kernels' tiles for a head dim: whole boxes; a
// dim under one box takes one, zero-filled past the tensor by its map.
constexpr int tile_width(int d) { return d < BOX ? BOX : d; }
constexpr float LOG2E = 1.4426950408889634f;
// A wait on a ring stage lasts at most a few steps' work: trap after ~2^22
// polls (well under a second) instead of the default minutes.
constexpr uint32_t POLLS = 1u << 22;

enum MaskKind { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_WINDOW = 2 };

// A compile-time int as a value, to instantiate a generic lambda per role.
template <int V>
struct Int {
    static constexpr int value = V;
};

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

// ------------------------------------------- wide pairs: dK/dV
// At D = Dv = 256 the split-step design above fits neither registers nor
// shared memory: a thread of it holds dK and dV (256 fp32) beside S^T and
// dP^T, and K, V and a four-stage ring of Q and dO take 323 KB.  At (192,
// 128) a thread of it would hold 96 + 64 fp32 of dK and dV beside S^T,
// dP^T and their bf16 fragments, about 256 registers.  Here the
// two warpgroups of a CTA work on the same steps instead: warpgroup 0
// forms S^T = K Q^T and P^T, hands P^T (bf16, the values its own dV
// product takes) to warpgroup 1 through shared memory and accumulates dV
// += P^T dO; warpgroup 1 forms dP^T = V dO^T, then dS^T from P^T, and
// accumulates dK += dS^T Q.  Each thread holds one 64 x D accumulator
// (128 fp32 at D 256; at (192, 128) warpgroup 0's dV uses the first 64 of
// its 96) and one 64 x 64 product (32).  S^T and dK run over D, dP^T and
// dV over Dv.  The ring has WKV_STAGES stages of Q, dO, lse and delta
// (64.5 KB each at (256, 256), a third does not fit beside K and V; 40.5
// KB at (192, 128)).
//
// What bounds it: the data the ring brings in.  Timed alone, the first
// design's loads took 0.078 of its 0.135 ms at recurrentgemma-2b's
// training shape (359 MB into the SMs, ~35 GB/s an SM), its products
// with the ring 0.097, the rest being the exponentials and dS^T behind a
// CTA-wide barrier a step.  Here the loop runs at the pace of its
// products with the ring: the elementwise work hides behind the other
// warpgroup's products.  Four stages of 32 queries loaded faster, but
// their 64 x 32 products ran slower.  What the design does:
// - No CTA-wide barrier in the loop: mbarriers decouple the warpgroups.
//   P^T goes through HANDOFF buffers behind full and empty mbarriers
//   (each warp arrives once); each stage's two halves have empty
//   mbarriers of their own, which both warpgroups arrive on when done
//   with the half: dO (warpgroup 1's dP^T, warpgroup 0's dV) frees before
//   Q and the stats (warpgroup 0's S^T and lse, warpgroup 1's dS^T and
//   dK), and each half is refilled as soon as it is free, dO by a thread
//   of warpgroup 0 and Q by one of warpgroup 1.
// - Each warpgroup issues a step's first product before it waits on the
//   previous step's accumulation, so its two products run back to back.
// - Under MQA one CTA per (KV head, 64 keys) leaves most SMs idle (64 CTAs
//   at recurrentgemma-2b's training shape, key tile 0 walking 160 steps),
//   so a CTA takes a slice of its group's heads instead (`splits` slices,
//   chosen by the wrapper so that the heaviest CTA walks no more steps
//   than the average SM): each slice writes fp32 parts of dK and dV, and
//   flash_bwd_dkdv_reduce_kernel sums them in slice order.  At one slice
//   (G 1: deepseek-v2-lite's MLA, whose rope key is expanded over the
//   heads) the CTA stages the bf16 gradients where K and V lay and stores
//   them by TMA (the ONE instantiation); the parts and the fourth launch
//   took 0.046 ms and more of 0.376 ms at its training shape (H100 at 700
//   W).  Summed inside a thread block cluster of the slices
//   instead, through distributed shared memory, the sum took longer than
//   the parts and the fourth launch, and clusters of 5 CTAs of this size
//   fit only 22 at once on 132 SMs.
// Mirrored by smem_bytes, wide_splits and slice_heads in
// kernels/flash_attention_bwd.py.
constexpr int WKV_STAGES = 2;        // ring depth of the wide dK/dV kernel
constexpr int HANDOFF = 2;           // P^T buffers between the warpgroups

// Variants of the wide kernels that tools/flash_bwd_time.py --variants
// times (built with -DFLASH_BWD_VARIANT=n; their gradients are wrong): 1
// loads only, 2 products only (no exponential, mask or hand-off), 3 the
// hand-off without its waits (each warpgroup takes its own product as P;
// the dQ kernel hands nothing over, so it runs in full), 4 no sum (no
// fp32 parts stored, no fourth launch).
#ifndef FLASH_BWD_VARIANT
#define FLASH_BWD_VARIANT 0
#endif
constexpr int VARIANT = FLASH_BWD_VARIANT;
constexpr bool V_PRODUCTS = VARIANT != 1;
constexpr bool V_SOFTMAX = VARIANT == 0 || VARIANT >= 3;
constexpr bool V_HANDOFF = VARIANT == 0 || VARIANT == 4;
constexpr bool V_SUM = VARIANT != 4;

template <int D, int DV>
struct KvWideLayout {
    static constexpr uint32_t k_bytes = BN * D * 2;
    static constexpr uint32_t v_bytes = BN * DV * 2;
    static constexpr uint32_t q_bytes = BM * D * 2;
    static constexpr uint32_t do_bytes = BM * DV * 2;
    static constexpr uint32_t st_bytes = 2 * BM * 4;
    static constexpr uint32_t p_bytes = BN * BM * 2;     // bf16 P^T
    static constexpr uint32_t k_off = 0;
    static constexpr uint32_t v_off = k_off + k_bytes;
    static constexpr uint32_t q_off = v_off + v_bytes;
    static constexpr uint32_t do_off = q_off + WKV_STAGES * q_bytes;
    static constexpr uint32_t st_off = do_off + WKV_STAGES * do_bytes;
    static constexpr uint32_t p_off = st_off + WKV_STAGES * st_bytes;
    static constexpr uint32_t bar_off = p_off + HANDOFF * p_bytes;
    // K/V's; per stage: full, Q's empty, dO's empty; per buffer: P's full
    // and empty
    static constexpr int n_bars = 1 + 3 * WKV_STAGES + 2 * HANDOFF;
    static constexpr uint32_t bytes = bar_off + 8 * n_bars + 1024;
    static constexpr uint32_t stage_tx = q_bytes + do_bytes + st_bytes;
};
static_assert(KvWideLayout<256, 256>::bytes <= 232448, "dK/dV (256, 256) fits");
static_assert(KvWideLayout<192, 128>::bytes <= 232448, "dK/dV (192, 128) fits");

// ONE: the grid takes each group's heads in one slice (splits == 1), and
// the CTA stores the bf16 gradients itself instead of fp32 parts.
template <int D, int DV, bool ONE>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dkdv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tst,
                           const __grid_constant__ CUtensorMap tdk,
                           const __grid_constant__ CUtensorMap tdv,
                           float* __restrict__ part, int splits, int Sq,
                           int Sk, int H, int KV, int mask_kind, int window,
                           int q_offset, float scale) {
    using L = KvWideLayout<D, DV>;
    constexpr int BOXES = D / BOX;
    constexpr int VBOXES = DV / BOX;
    static_assert(D >= DV, "K's boxes cover V's");
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
    bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
    bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
    float* Sts = reinterpret_cast<float*>(smem + L::st_off);
    uint32_t* Ps = reinterpret_cast<uint32_t*>(smem + L::p_off);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
    uint64_t* kv_full = bars;
    uint64_t* full = bars + 1;                 // [WKV_STAGES] each
    uint64_t* q_empty = full + WKV_STAGES;
    uint64_t* do_empty = q_empty + WKV_STAGES;
    uint64_t* p_full = do_empty + WKV_STAGES;  // [HANDOFF] each
    uint64_t* p_empty = p_full + HANDOFF;

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
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;

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
        for (int s = 0; s < WKV_STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(q_empty + s, 8);          // every warp of both groups
            mbar_init(do_empty + s, 8);
        }
        for (int s = 0; s < HANDOFF; ++s) {
            mbar_init(p_full + s, 4);           // every warp of one group
            mbar_init(p_empty + s, 4);
        }
        fence_barrier_init();
    }
    __syncthreads();

    // Step i's dO, behind the expected bytes of its whole stage, and its Q
    // and stats; the two halves may come in either order.
    auto load_do = [&](int i) {
        const int s = i % WKV_STAGES;
        const int h = hk * G + g_lo + i / n_qt;
        const int m0 = (t_lo + i % n_qt) * BM;
        mbar_arrive_expect_tx(full + s, L::stage_tx);
#pragma unroll
        for (int c = 0; c < VBOXES; ++c)
            tma_load_4d(dOs + s * BM * DV + c * BM * BOX, &tdo, full + s,
                        c * BOX, h, m0, b);
    };
    auto load_q = [&](int i) {
        const int s = i % WKV_STAGES;
        const int h = hk * G + g_lo + i / n_qt;
        const int m0 = (t_lo + i % n_qt) * BM;
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
            tma_load_4d(Qs + s * BM * D + c * BM * BOX, &tq, full + s,
                        c * BOX, h, m0, b);
        tma_load_4d(Sts + s * 2 * BM, &tst, full + s, m0, 0, h, b);
    };
    if (tid == 0) {
        mbar_arrive_expect_tx(kv_full, L::k_bytes + L::v_bytes);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) {
            tma_load_4d(Ks + c * BN * BOX, &tk, kv_full, c * BOX, hk, n0, b);
            if (c < VBOXES)
                tma_load_4d(Vs + c * BN * BOX, &tv, kv_full, c * BOX, hk, n0,
                            b);
        }
        for (int i = 0; i < min(n_steps, WKV_STAGES); ++i) {
            load_do(i);
            load_q(i);
        }
    }

    const float scale_log2 = scale * LOG2E;
    const int key0 = n0 + 16 * warp + lane / 4;
    const int col_in = 2 * (lane % 4);

    mbar_wait(kv_full, 0, POLLS);
    // Warpgroup 0 forms S^T over D and P^T and accumulates dV (64 keys x
    // Dv); warpgroup 1 forms dP^T over Dv and dS^T and accumulates dK (64
    // keys x D).  Each runs the loop of its own role (WG fixed at compile
    // time), so that no wgmma lies behind a branch on the warpgroup:
    // products of two widths behind such a branch made ptxas serialize
    // every wgmma of the kernel (C7520).
    auto role = [&](auto wg_tag) {
        constexpr int WG = decltype(wg_tag)::value;
        constexpr int W = WG == 0 ? DV : D;      // accumulator columns
        constexpr int DEPTH = WG == 0 ? D : DV;  // first product's depth
        float acc[W / 2];
#pragma unroll
        for (int j = 0; j < W / 2; ++j) acc[j] = 0.f;
        // The first product's A: K (S^T = K Q^T) or V (dP^T = V dO^T).
        const uint64_t a_desc = desc_sw128(WG == 0 ? Ks : Vs, 0, 1024);
        // A fragments of P^T or dS^T, read by the step's second product
        // until the next step's wait.
        uint32_t xa[BM / 16][4];
        for (int i = 0; i < n_steps; ++i) {
            const int s = i % WKV_STAGES;
            const uint32_t parity = (i / WKV_STAGES) & 1;
            const int hb = i % HANDOFF;
            const uint32_t hparity = (i / HANDOFF) & 1;
            const int m0 = (t_lo + i % n_qt) * BM;
            const bf16* q_st = Qs + s * BM * D;
            const bf16* do_st = dOs + s * BM * DV;
            const float* lse_st = Sts + s * 2 * BM;
            const float* dlt_st = lse_st + BM;
            uint32_t* p_st = Ps + hb * (BN * BM / 2);
            mbar_wait(full + s, parity, POLLS);
            __syncwarp();

            // S^T or dP^T: keys x queries, 64 x 64; the wait also retires
            // the previous step's dV or dK product.
            float x[BM / 2];
            if constexpr (V_PRODUCTS) {
                wgmma_fence();
                wgmma_ss_tiles<DEPTH>(
                    x, per_step(a_desc), BN * BOX * 2,
                    desc_sw128(WG == 0 ? q_st : do_st, 0, 1024),
                    BM * BOX * 2);
                wgmma_commit();
                wgmma_wait<0>();
            } else {
#pragma unroll
                for (int j = 0; j < BM / 2; ++j) x[j] = 0.f;
            }
            fence_regs<BM / 2>(x);
            fence_regs<W / 2>(acc);
            __syncwarp();
            // The stage of step i - 1, whose halves this step frees.
            const int sp = (i + WKV_STAGES - 1) % WKV_STAGES;
            const uint32_t was = ((i - 1) / WKV_STAGES) & 1;
            const bool refill = i >= 1 && i - 1 + WKV_STAGES < n_steps;
            if constexpr (WG == 0) {
                // dV of step i - 1 is done, and warpgroup 1 took its dP^T
                // before P^T: dO's half of that stage is free.
                if (i >= 1) {
                    if (lane == 0) mbar_arrive(do_empty + sp);
                    if (ct == 0 && refill) {
                        mbar_wait(do_empty + sp, was, POLLS);
                        load_do(i - 1 + WKV_STAGES);
                    }
                }
                // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where
                // masked.
                if constexpr (V_SOFTMAX) {
                    const bool edge = edge_tile(m0, n0, Sq, Sk, mask_kind,
                                                window, q_offset);
#pragma unroll
                    for (int j = 0; j < BM / 2; ++j) {
                        const int col = 8 * (j / 4) + col_in + (j & 1);
                        float p = ex2(x[j] * scale_log2 - lse_st[col]);
                        if (edge) {
                            const int key = key0 + ((j & 2) ? 8 : 0);
                            const int row = m0 + col;
                            const bool ok = (key < Sk) & (row < Sq) &
                                visible(mask_kind, window, q_offset + row,
                                        key);
                            p = ok ? p : 0.f;
                        }
                        x[j] = p;
                    }
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(q_empty + s);   // S^T, lse read
                to_a<BM>(xa, x);
                // P^T to warpgroup 1, each thread's pairs in its own
                // column.
                if constexpr (V_HANDOFF) {
                    if (i >= HANDOFF)
                        mbar_wait(p_empty + hb, hparity ^ 1, POLLS);
#pragma unroll
                    for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            p_st[(4 * kk + e) * 128 + ct] = xa[kk][e];
                    __syncwarp();
                    if (lane == 0) mbar_arrive(p_full + hb);
                }
            } else {
                // dO of step i is read: its half of the stage is free for
                // this warpgroup.  dK of step i - 1 is done: Q's half of
                // that stage too, and warpgroup 0 read it before it
                // handed over P^T.
                if (lane == 0) mbar_arrive(do_empty + s);
                if (i >= 1) {
                    if (lane == 0) mbar_arrive(q_empty + sp);
                    if (ct == 0 && refill) {
                        mbar_wait(q_empty + sp, was, POLLS);
                        load_q(i - 1 + WKV_STAGES);
                    }
                }
                // dS^T = P^T (dP^T - delta), in place of dP^T.
                if constexpr (V_SOFTMAX) {
                    if constexpr (V_HANDOFF)
                        mbar_wait(p_full + hb, hparity, POLLS);
#pragma unroll
                    for (int j = 0; j < BM / 4; ++j) {
                        const float2 p =
                            V_HANDOFF ? unpack_bf16(p_st[j * 128 + ct])
                                      : make_float2(x[2 * j], x[2 * j + 1]);
                        const int col = 8 * (j / 2) + col_in;
                        x[2 * j] = p.x * (x[2 * j] - dlt_st[col]);
                        x[2 * j + 1] = p.y * (x[2 * j + 1] - dlt_st[col + 1]);
                    }
                    if constexpr (V_HANDOFF) {
                        __syncwarp();
                        if (lane == 0) mbar_arrive(p_empty + hb);
                    }
                }
                to_a<BM>(xa, x);
            }

            // dV += P^T dO or dK += dS^T Q: dO and Q are [queries, width]
            // with the width contiguous, MN-major B operands.  Not waited
            // on here: the next step's first product goes in behind it.
            if constexpr (V_PRODUCTS) {
                __syncwarp();
#pragma unroll
                for (int kk = 0; kk < BM / 16; ++kk) fence_regs<4>(xa[kk]);
                const uint64_t b_mn =
                    desc_sw128(WG == 0 ? do_st : q_st, BM * BOX * 2, 1024);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BM / 16; ++kk)
                    wgmma_rs<W>(acc, xa[kk], desc_at(b_mn, kk * 16 * BOX * 2));
                wgmma_commit();
            }
        }
        wgmma_wait<0>();
        fence_regs<W / 2>(acc);

        if constexpr (ONE) {
            // One slice (G 1, as MLA's expanded heads are): the bf16
            // gradient, dK scaled with the reduction's arithmetic (so the
            // same bits), staged where V (dV) or K (dK) lay once both
            // warpgroups are done with them, and stored by TMA.
            if constexpr (WG == 1) {
#pragma unroll
                for (int j = 0; j < W / 2; ++j) acc[j] *= scale;
            }
            named_barrier_sync(1, KV_THREADS);
            bf16* tile = WG == 0 ? Vs : Ks;
            stage_bf16<W>(tile, BN * BOX * 2, acc, warp, lane);
            fence_proxy_async();
            named_barrier_sync(2 + WG, 128);
            if (ct == 0) {
#pragma unroll
                for (int c = 0; c < W / BOX; ++c)
                    tma_store_4d(WG == 0 ? &tdv : &tdk, tile + c * BN * BOX,
                                 c * BOX, hk, n0, b);
                bulk_commit();
                bulk_wait_read<0>();
            }
            return;
        }
        // This slice's fp32 part of dK or dV: part holds the dK parts
        // [splits, B, Sk, KV, D], then the dV parts [splits, B, Sk, KV,
        // DV], summed over the slices (and dK scaled) by
        // flash_bwd_dkdv_reduce_kernel.
        const long long nk = (long long)gridDim.y * Sk * KV * D;
        const long long nw = (long long)gridDim.y * Sk * KV * W;
        float* out = part + (WG == 0 ? splits * nk : 0) + split * nw +
                     ((long long)b * Sk * KV + hk) * W;
#pragma unroll
        for (int j = 0; j < W / 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int key = key0 + 8 * r;
                if (V_SUM && key < Sk)
                    *reinterpret_cast<float2*>(
                        out + (long long)key * KV * W + 8 * j + col_in) =
                        make_float2(acc[4 * j + 2 * r],
                                    acc[4 * j + 2 * r + 1]);
            }
    };
    if (wg == 0) role(Int<0>{});
    else role(Int<1>{});
}

// The slices' fp32 parts of dK and dV ([splits, nk] then [splits, nv],
// nk = B Sk KV D, nv = B Sk KV Dv) summed in slice order, dK scaled, into
// the bf16 gradients; four elements a thread.
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_reduce_kernel(const float* __restrict__ part,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             long long nk, long long nv, int splits,
                             float scale) {
    const long long i =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    if (i >= nk + nv) return;
    const int which = i >= nk;                 // 0: dK, 1: dV
    const long long e = i - which * nk;
    const long long n = which ? nv : nk;
    const float* p = part + (long long)which * splits * nk + e;
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

// ------------------------------------------------- wide pairs: dQ
// One CTA per (batch, head, 64 queries), 256 threads.  The two
// warpgroups split each 64-key tile: warpgroup w takes keys 32w .. 32w +
// 31 and computes, for all 64 queries, S = Q K_w^T (over D), P, dP = dO
// V_w^T (over Dv), dS and dQ_w += dS K_w (dS from registers, 64 x D fp32
// a thread).  So
// neither waits for the other inside the loop, each one's exponentials
// run while the other's products do, and no P or dS passes between them;
// the two dQ_w are summed once at the end, warpgroup 0's plus warpgroup
// 1's.
//
// What bounds it: the K/V ring.  Timed alone, the first design's loads
// took 0.055 of its 0.107 ms: a key tile's K and V are 64 KB, two such
// stages fit beside Q and dO, and a stage was refilled only once its
// tile was done.  What the design does about it:
// - K and V have rings of their own: V (read only by dP) WQ_V_STAGES
//   deep, K (read by S and by dQ) WQ_K_STAGES deep, each refilled by one
//   thread as soon as both warpgroups have released it, so V is loaded
//   about a tile and a half ahead and K two.
// - Each warpgroup issues the next tile's S and dP before it waits on
//   this tile's dQ product.
// Tried and dropped: each warpgroup forming all 64 keys of S or dP and
// handing P and dS to the other (as the dK/dV kernel does) behind
// mbarriers, with Q and dO in registers and a three-stage ring, took
// 0.125 ms, 0.028 ms more than without its hand-offs; K and V multicast
// to the 5 heads of a cluster moved nothing (the time follows the bytes
// each SM takes in, not those L2 serves) and left 22 of 132 SMs idle.
// Mirrored by smem_bytes and dq_tiles_wide in
// kernels/flash_attention_bwd.py.
constexpr int WQ_K_STAGES = 3;       // K ring of the wide dQ kernel
constexpr int WQ_V_STAGES = 2;       // V ring of the wide dQ kernel

template <int D, int DV>
struct QWideLayout {
    static constexpr uint32_t q_bytes = BM * D * 2;
    static constexpr uint32_t do_bytes = BM * DV * 2;
    static constexpr uint32_t k_bytes = BN * D * 2;      // K of a tile
    static constexpr uint32_t v_bytes = BN * DV * 2;     // V of a tile
    static constexpr uint32_t q_off = 0;
    static constexpr uint32_t do_off = q_off + q_bytes;
    static constexpr uint32_t k_off = do_off + do_bytes;
    static constexpr uint32_t v_off = k_off + WQ_K_STAGES * k_bytes;
    static constexpr uint32_t bar_off = v_off + WQ_V_STAGES * v_bytes;
    // Q/dO's; per K stage full and empty; per V stage full and empty.
    static constexpr int n_bars = 1 + 2 * WQ_K_STAGES + 2 * WQ_V_STAGES;
    static constexpr uint32_t bytes = bar_off + 8 * n_bars + 1024;
    // After the loop, warpgroup 1's fp32 dQ lies over the K stages.
    static_assert(BM * D * 4 <= WQ_K_STAGES * k_bytes, "dQ part fits K's ring");
};
static_assert(QWideLayout<256, 256>::bytes <= 232448, "dQ (256, 256) fits");
static_assert(QWideLayout<192, 128>::bytes <= 232448, "dQ (192, 128) fits");

template <int D, int DV>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdq,
                         const float* __restrict__ stats, int Sq, int Sq_pad,
                         int Sk, int H, int KV, int mask_kind, int window,
                         int q_offset, float scale) {
    using L = QWideLayout<D, DV>;
    constexpr int KW = BN / 2;                 // keys a warpgroup
    constexpr int BOXES = D / BOX;
    constexpr int VBOXES = DV / BOX;
    static_assert(D >= DV, "Q's boxes cover dO's");
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
    bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
    uint64_t* q_full = bars;
    uint64_t* k_full = bars + 1;                    // [WQ_K_STAGES] each
    uint64_t* k_empty = k_full + WQ_K_STAGES;
    uint64_t* v_full = k_empty + WQ_K_STAGES;       // [WQ_V_STAGES] each
    uint64_t* v_empty = v_full + WQ_V_STAGES;

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int m0 = (gridDim.z - 1 - blockIdx.z) * BM;    // heaviest first
    const int hk = h / (H / KV);
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int ct = tid % 128;
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;

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
        for (int s = 0; s < WQ_K_STAGES; ++s) {
            mbar_init(k_full + s, 1);
            mbar_init(k_empty + s, 8);          // every warp of both groups
        }
        for (int s = 0; s < WQ_V_STAGES; ++s) {
            mbar_init(v_full + s, 1);
            mbar_init(v_empty + s, 8);
        }
        fence_barrier_init();
    }
    __syncthreads();

    auto load_k = [&](int i) {
        const int s = i % WQ_K_STAGES;
        mbar_arrive_expect_tx(k_full + s, L::k_bytes);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
            tma_load_4d(Ks + s * BN * D + c * BN * BOX, &tk, k_full + s,
                        c * BOX, hk, (t_lo + i) * BN, b);
    };
    auto load_v = [&](int i) {
        const int s = i % WQ_V_STAGES;
        mbar_arrive_expect_tx(v_full + s, L::v_bytes);
#pragma unroll
        for (int c = 0; c < VBOXES; ++c)
            tma_load_4d(Vs + s * BN * DV + c * BN * BOX, &tv, v_full + s,
                        c * BOX, hk, (t_lo + i) * BN, b);
    };
    if (tid == 0 && n_tiles > 0) {
        mbar_arrive_expect_tx(q_full, L::q_bytes + L::do_bytes);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) {
            tma_load_4d(Qs + c * BM * BOX, &tq, q_full, c * BOX, h, m0, b);
            if (c < VBOXES)
                tma_load_4d(dOs + c * BM * BOX, &tdo, q_full, c * BOX, h, m0,
                            b);
        }
        for (int i = 0; i < min(n_tiles, WQ_K_STAGES); ++i) load_k(i);
        for (int i = 0; i < min(n_tiles, WQ_V_STAGES); ++i) load_v(i);
    }

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

    // dQ over this warpgroup's keys, 64 queries x D.
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // The zeros are in place before the first product is issued: a write
    // of an accumulator while a product is in flight makes ptxas
    // serialize the kernel's wgmma.
    fence_regs<D / 2>(acc);
    const uint64_t q_desc = desc_sw128(Qs, 0, 1024);
    const uint64_t do_desc = desc_sw128(dOs, 0, 1024);
    // This warpgroup's 32 keys start 32 rows (4 KB) into each box of K/V.
    const uint32_t key_off = wg * KW * 128;

    // S = Q K_w^T and dP = dO V_w^T of tile i (64 x 32 each), written only
    // by the products (a write of an accumulator in flight would serialize
    // them).
    float s_acc[KW / 2];
    float dp_acc[KW / 2];
    auto first = [&](int i) {
        const int ks = i % WQ_K_STAGES;
        const int vs = i % WQ_V_STAGES;
        mbar_wait(k_full + ks, (i / WQ_K_STAGES) & 1, POLLS);
        mbar_wait(v_full + vs, (i / WQ_V_STAGES) & 1, POLLS);
        __syncwarp();
        wgmma_fence();
        wgmma_ss_tiles<D, KW>(
            s_acc, per_step(q_desc), BM * BOX * 2,
            desc_at(desc_sw128(Ks + ks * BN * D, 0, 1024), key_off),
            BN * BOX * 2);
        wgmma_commit();
        wgmma_ss_tiles<DV, KW>(
            dp_acc, per_step(do_desc), BM * BOX * 2,
            desc_at(desc_sw128(Vs + vs * BN * DV, 0, 1024), key_off),
            BN * BOX * 2);
        wgmma_commit();
    };
    if (n_tiles > 0) mbar_wait(q_full, 0, POLLS);
    if (V_PRODUCTS && n_tiles > 0) first(0);
    // dS as A fragments, read by tile i's dQ product until the next wait.
    uint32_t dsa[KW / 16][4];
    for (int i = 0; i < n_tiles; ++i) {
        const int ks = i % WQ_K_STAGES;
        const int vs = i % WQ_V_STAGES;
        const int n0 = (t_lo + i) * BN;
        const int key0 = n0 + wg * KW;
        float p[KW / 2];
        float ds[KW / 2];
        if constexpr (V_PRODUCTS) {
            // S of tile i is done (issued before its dP and the previous
            // tile's dQ product).
            if (i == 0) wgmma_wait<1>();
            else wgmma_wait<2>();
            fence_regs<KW / 2>(s_acc);
#pragma unroll
            for (int j = 0; j < KW / 2; ++j) p[j] = s_acc[j];
        } else {
            mbar_wait(k_full + ks, (i / WQ_K_STAGES) & 1, POLLS);
            mbar_wait(v_full + vs, (i / WQ_V_STAGES) & 1, POLLS);
#pragma unroll
            for (int j = 0; j < KW / 2; ++j) p[j] = 0.f;
        }
        // P = exp2(S scale log2(e) - lse log2(e)), 0 where masked.
        if constexpr (V_SOFTMAX) {
            const bool edge =
                edge_tile(m0, n0, Sq, Sk, mask_kind, window, q_offset);
#pragma unroll
            for (int j = 0; j < KW / 2; ++j) {
                const int r = (j >> 1) & 1;
                float v = ex2(p[j] * scale_log2 - lse2[r]);
                if (edge) {
                    const int key = key0 + 8 * (j / 4) + col_in + (j & 1);
                    const int row = row0 + 8 * r;
                    const bool ok = (key < Sk) & (row < Sq) &
                        visible(mask_kind, window, q_offset + row, key);
                    v = ok ? v : 0.f;
                }
                p[j] = v;
            }
        }
        // dP of tile i and the previous tile's dQ product are done: V's
        // stage of tile i and K's of tile i - 1 are free for this
        // warpgroup; one thread refills them with tiles i + WQ_V_STAGES
        // and i - 1 + WQ_K_STAGES once the other warpgroup is done too.
        if constexpr (V_PRODUCTS) {
            wgmma_wait<0>();
            fence_regs<KW / 2>(dp_acc);
            fence_regs<D / 2>(acc);
#pragma unroll
            for (int j = 0; j < KW / 2; ++j) ds[j] = dp_acc[j];
        } else {
#pragma unroll
            for (int j = 0; j < KW / 2; ++j) ds[j] = 0.f;
        }
        __syncwarp();
        if (lane == 0) {
            mbar_arrive(v_empty + vs);
            if (i >= 1) mbar_arrive(k_empty + (i - 1) % WQ_K_STAGES);
        }
        if (tid == 0) {
            if (i + WQ_V_STAGES < n_tiles) {
                mbar_wait(v_empty + vs, (i / WQ_V_STAGES) & 1, POLLS);
                load_v(i + WQ_V_STAGES);
            }
            if (i >= 1 && i - 1 + WQ_K_STAGES < n_tiles) {
                mbar_wait(k_empty + (i - 1) % WQ_K_STAGES,
                          ((i - 1) / WQ_K_STAGES) & 1, POLLS);
                load_k(i - 1 + WQ_K_STAGES);
            }
        }
        // dS = P (dP - delta), as A fragments.
        if constexpr (V_SOFTMAX) {
#pragma unroll
            for (int j = 0; j < KW / 2; ++j)
                ds[j] = p[j] * (ds[j] - dlt[(j >> 1) & 1]);
        }
        to_a<KW>(dsa, ds);
        // The next tile's S and dP go in before this tile's dQ product.
        if (V_PRODUCTS && i + 1 < n_tiles) first(i + 1);
        // dQ += dS K_w: K is [keys, D] with D contiguous, an MN-major B
        // operand; this warpgroup's keys start 32 rows into each box.
        if constexpr (V_PRODUCTS) {
            __syncwarp();
#pragma unroll
            for (int kk = 0; kk < KW / 16; ++kk) fence_regs<4>(dsa[kk]);
            const uint64_t k_mn = desc_at(
                desc_sw128(Ks + ks * BN * D, BN * BOX * 2, 1024), key_off);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KW / 16; ++kk)
                wgmma_rs<D>(acc, dsa[kk], desc_at(k_mn, kk * 16 * BOX * 2));
            wgmma_commit();
        }
    }
    wgmma_wait<0>();
    fence_regs<D / 2>(acc);

    // Epilogue: warpgroup 1 hands its dQ (fp32 pairs [pair][thread]) over
    // the K stages to warpgroup 0, which adds it to its own, scales, stages
    // the sum as bf16 over Q and stores it with TMA.
    __syncthreads();
    float2* part = reinterpret_cast<float2*>(smem + L::k_off);
    if (wg == 1) {
#pragma unroll
        for (int j = 0; j < D / 4; ++j)
            part[j * 128 + ct] = make_float2(acc[2 * j], acc[2 * j + 1]);
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
        for (int j = 0; j < D / 4; ++j) {
            const float2 o = part[j * 128 + ct];
            acc[2 * j] = (acc[2 * j] + o.x) * scale;
            acc[2 * j + 1] = (acc[2 * j + 1] + o.y) * scale;
        }
        stage_bf16<D>(Qs, BM * BOX * 2, acc, warp, lane);
        fence_proxy_async();
        named_barrier_sync(1, 128);
        if (ct == 0) {
#pragma unroll
            for (int c = 0; c < BOXES; ++c)
                tma_store_4d(&tdq, Qs + c * BM * BOX, c * BOX, h, m0, b);
            bulk_commit();
            bulk_wait_read<0>();
        }
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

// (D, Dv) are the tensors' head dims; the product kernels run on tiles of
// tile_width(D) and tile_width(Dv) columns.
template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* stats, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int KV, int mask_kind, int window,
                   int q_offset, float scale, cudaStream_t stream) {
    constexpr int TD = tile_width(D), TDV = tile_width(DV);
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

    auto kv_kern = flash_bwd_dkdv_kernel<TD, TDV>;
    constexpr int kv_bytes = KvLayout<TD, TDV>::bytes;
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

    auto q_kern = flash_bwd_dq_kernel<TD, TDV>;
    constexpr int q_bytes = QLayout<TD, TDV>::bytes;
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

// The wide pairs ((256, 256) and (192, 128)): the delta pass, then the
// two kernels whose warpgroups share each step, with the sum of the dK/dV
// slices' parts between them.
template <int D, int DV>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* stats, void* dq, void* dk, void* dv, void* part,
                        int splits, int B, int Sq, int Sk, int H, int KV,
                        int mask_kind, int window, int q_offset, float scale,
                        cudaStream_t stream) {
    const int Sq_pad = (Sq + BM - 1) / BM * BM;
    cudaError_t err =
        launch_delta<DV>(out, dout, lse, stats, B, Sq, Sq_pad, H, stream);
    if (err != cudaSuccess) return err;

    CUtensorMap tq, tdo, tk, tv, tst, tdq, tdk, tdv;
    const cuuint64_t st_dims[4] = {(cuuint64_t)Sq_pad, 2, (cuuint64_t)H,
                                   (cuuint64_t)B};
    const cuuint32_t st_box[4] = {BM, 2, 1, 1};
    err = bf16_map(&tq, q, D, H, Sq, B, BM);
    if (err == cudaSuccess) err = bf16_map(&tdk, dk, D, KV, Sk, B, BN);
    if (err == cudaSuccess) err = bf16_map(&tdv, dv, DV, KV, Sk, B, BN);
    if (err == cudaSuccess) err = bf16_map(&tdo, dout, DV, H, Sq, B, BM);
    if (err == cudaSuccess) err = bf16_map(&tk, k, D, KV, Sk, B, BN);
    if (err == cudaSuccess) err = bf16_map(&tv, v, DV, KV, Sk, B, BN);
    if (err == cudaSuccess)
        err = make_map(&tst, stats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                       st_dims, st_box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess) err = bf16_map(&tdq, dq, D, H, Sq, B, BM);
    if (err != cudaSuccess) return err;

    // One slice stores the bf16 gradients itself; more write fp32 parts.
    auto kv_kern = splits == 1 ? flash_bwd_dkdv_wide_kernel<D, DV, true>
                               : flash_bwd_dkdv_wide_kernel<D, DV, false>;
    constexpr int kv_bytes = KvWideLayout<D, DV>::bytes;
    err = cudaFuncSetAttribute(kv_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_bytes);
    if (err != cudaSuccess) return err;
    kv_kern<<<dim3(KV * splits, B, (Sk + BN - 1) / BN), KV_THREADS,
              kv_bytes, stream>>>(tq, tdo, tk, tv, tst, tdk, tdv,
                                  static_cast<float*>(part), splits, Sq, Sk,
                                  H, KV, mask_kind, window, q_offset, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (V_SUM && splits > 1) {
        const long long nk = (long long)B * Sk * KV * D;
        const long long nv = (long long)B * Sk * KV * DV;
        flash_bwd_dkdv_reduce_kernel<<<(unsigned)(((nk + nv) / 4 + 255) /
                                                  256),
                                       256, 0, stream>>>(
            static_cast<const float*>(part), static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), nk, nv, splits, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }

    auto q_kern = flash_bwd_dq_wide_kernel<D, DV>;
    constexpr int q_bytes = QWideLayout<D, DV>::bytes;
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
// Sq_pad] with Sq_pad = Sq rounded up to a multiple of 64.  The pairs
// (D, Dv): the split kernels take (64, 64), (128, 128) and (128, 64)
// (minicpm3-4b's qk 96 zero-padded to 128, v 64), and the reduced
// configs' (32, 32) and (64, 32) on (64, 64) tiles; the wide kernels take
// (256, 256) (recurrentgemma-2b's local attention) and (192, 128)
// (deepseek-v2-lite's MLA), WIDE_PAIRS in kernels/flash_attention_bwd.py.
// There the dK/dV kernel takes each KV group's heads in `splits` slices,
// one CTA each, and part is fp32 scratch for their parts: [splits, B, Sk,
// KV, D] of dK, then [splits, B, Sk, KV, Dv] of dV (unused by the split
// pairs and at one slice, where it may be null).
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
    if (D == 128 && Dv == 64)
        return (int)launch<128, 64>(q, k, v, out, dout, lse, stats, dq, dk,
                                    dv, B, Sq, Sk, H, KV, mask_kind, window,
                                    q_offset, scale, st);
    if (D == 32 && Dv == 32)
        return (int)launch<32, 32>(q, k, v, out, dout, lse, stats, dq, dk, dv,
                                   B, Sq, Sk, H, KV, mask_kind, window,
                                   q_offset, scale, st);
    if (D == 64 && Dv == 32)
        return (int)launch<64, 32>(q, k, v, out, dout, lse, stats, dq, dk, dv,
                                   B, Sq, Sk, H, KV, mask_kind, window,
                                   q_offset, scale, st);
    const bool wide = (D == 256 && Dv == 256) || (D == 192 && Dv == 128);
    if (!wide) return (int)cudaErrorInvalidValue;
    if (splits < 1 || (splits > 1 && part == nullptr))
        return (int)cudaErrorInvalidValue;
    if (D == 256)
        return (int)launch_wide<256, 256>(q, k, v, out, dout, lse, stats, dq,
                                          dk, dv, part, splits, B, Sq, Sk, H,
                                          KV, mask_kind, window, q_offset,
                                          scale, st);
    return (int)launch_wide<192, 128>(q, k, v, out, dout, lse, stats, dq, dk,
                                      dv, part, splits, B, Sq, Sk, H, KV,
                                      mask_kind, window, q_offset, scale, st);
}

// Dynamic shared memory of the dK/dV kernel (kernel 0) or the dQ kernel
// (kernel 1) for a head-dim pair (the wide kernels' at the wide pairs); -1
// for a pair the backward is not built for.
extern "C" long flash_attention_bwd_smem_bytes(int D, int Dv, int kernel) {
    if (D == 128 && Dv == 128)
        return kernel == 0 ? (long)KvLayout<128, 128>::bytes
                           : (long)QLayout<128, 128>::bytes;
    if ((D == 64 && Dv == 64) || (D == 32 && Dv == 32) ||
        (D == 64 && Dv == 32))       // the last two on (64, 64) tiles
        return kernel == 0 ? (long)KvLayout<64, 64>::bytes
                           : (long)QLayout<64, 64>::bytes;
    if (D == 128 && Dv == 64)
        return kernel == 0 ? (long)KvLayout<128, 64>::bytes
                           : (long)QLayout<128, 64>::bytes;
    if (D == 256 && Dv == 256)
        return kernel == 0 ? (long)KvWideLayout<256, 256>::bytes
                           : (long)QWideLayout<256, 256>::bytes;
    if (D == 192 && Dv == 128)
        return kernel == 0 ? (long)KvWideLayout<192, 128>::bytes
                           : (long)QWideLayout<192, 128>::bytes;
    return -1;
}

namespace {

// CTAs of one kernel an SM holds at its dynamic shared memory.
template <typename Kernel>
cudaError_t ctas_an_sm(Kernel kern, int bytes, int* out) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern,
                                                         KV_THREADS, bytes);
}

}  // namespace

// How many CTAs of the wide dK/dV kernel (kernel 0) or dQ kernel (kernel
// 1) of a wide pair an SM holds at once, into *out
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the dK/dV kernel's two
// instantiations take the same shared memory.
extern "C" int flash_attention_bwd_wide_ctas(int D, int Dv, int kernel,
                                             int* out, int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (kernel != 0 && kernel != 1) return (int)cudaErrorInvalidValue;
    if (D == 256 && Dv == 256)
        return (int)(kernel == 0
                         ? ctas_an_sm(flash_bwd_dkdv_wide_kernel<256, 256, false>,
                                      KvWideLayout<256, 256>::bytes, out)
                         : ctas_an_sm(flash_bwd_dq_wide_kernel<256, 256>,
                                      QWideLayout<256, 256>::bytes, out));
    if (D == 192 && Dv == 128)
        return (int)(kernel == 0
                         ? ctas_an_sm(flash_bwd_dkdv_wide_kernel<192, 128, true>,
                                      KvWideLayout<192, 128>::bytes, out)
                         : ctas_an_sm(flash_bwd_dq_wide_kernel<192, 128>,
                                      QWideLayout<192, 128>::bytes, out));
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
