// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_pallas,
// body _kernel).  Per chunk of Q steps of one (batch, head):
//   cum   = cumsum(dt * A)                          (within the chunk)
//   L     = (C B^T) o exp(cum_t - cum_s) o dt_s     for s <= t, else 0
//   y     = L x + exp(cum_t) * (C state^T)
//   state = state * exp(cum_Q) + sum_s exp(cum_Q - cum_s) dt_s x_s (x) B_s
// with the fp32 [P, N] state carried from chunk to chunk.  B and C of head
// h are those of group h / (H / G), as in the Pallas kernel's index map.
// Unlike the Pallas kernel (which starts from zeros and leaves a resumed
// scan to XLA), the CTA loads an optional initial state: it costs nothing.
//
// What bounds it on the card: at the serving path's prefill shape (B 4,
// S 1024, 80 heads of P 64, N 128, G 1, chunk 128) the call moves ~98 MB
// (x and y 41.9 MB each, the fp32 state 10.5 MB, B/C/dt 3.4 MB), ~29 us at
// 3.35 TB/s, and the four products are ~20 GFLOP (the lower triangle of
// C B^T only), ~20 us at the bf16 tensor-core rate: bytes bind, but only
// just, so the products must run on the tensor cores and the loads must
// overlap them.  With G = 1 every head's CTA also reads the same B and C
// again from L2 (168 MB at the serving shape).
//
// What the design does about it: one CTA per (batch, head) -- 320 at the
// serving shape, one per SM at a time -- walks the chunks in order (the
// loop takes the place of the Pallas kernel's sequential grid axis), so
// no state goes to device memory between chunks.  Inside the CTA:
//   * the four products run on the tensor cores, mma.sync m16n8k16 with
//     bf16 operands from shared memory by ldmatrix and fp32 accumulators.
//     A warp forms a 16-row tile of y as exp(cum_t) (C state^T) in its
//     accumulator, then for each 16-wide block of s <= t computes C B^T,
//     turns that accumulator into L in registers (exp() only where s <= t:
//     a masked, positive difference would give inf, and inf * 0 is NaN)
//     and feeds it, packed to bf16, as the A fragment of L x.  L never
//     goes to shared memory; blocks above the diagonal are neither
//     computed nor read;
//   * the fp32 state lives in registers, as the accumulator of
//     (x o w)^T B (w_s = exp(cum_Q - cum_s) dt_s, applied to x's fragments
//     as they are loaded by ldmatrix.trans): each warp holds a 16-row strip
//     of P and a run of N.  Each chunk it is scaled by exp(cum_Q), the
//     product is added, and a bf16 copy goes to shared memory for the next
//     chunk's C state^T, after a barrier that ends this chunk's reads;
//   * the next chunk's x, B, C (bf16) and dt are loaded into the second of
//     two staging buffers while this chunk computes;
//   * every warp computes the chunk's cumsum itself (shuffle scans) and
//     writes the same values, so no warp waits for another's;
//   * y leaves through a per-warp staging tile as 16-byte rows.
// The kernel is compiled twice from this source.  At mamba2-2.7b's head
// (chunk 128, P 64, N 128, 16-byte aligned) the sizes are compile-time:
// every loop unrolls, C's fragments stay in registers, x, B and C arrive by
// TMA (one thread, three boxes a chunk), and the triangle is shared out
// evenly: warps k and k + 4 (one SM sub-partition) hold row tiles k and
// 7 - k, and warp k computes the first 4 - k blocks of tile 7 - k and hands
// the partial sum over (5 blocks each against 4, instead of 8 against 1);
// the next block's C B^T is issued before this block's L is formed.  Any
// other shape takes its sizes at run time, loads by cp.async (or plain
// loads where rows are not whole 16-byte pieces) and gives warp w the row
// tiles w and 15 - w (w < 4) or 11 - w and w + 4.  Ragged Q, P and N are
// padded to multiples of 16 with zeros in shared memory (written once,
// never overwritten; the TMA boxes are as wide as the padded rows and read
// zeros past the tensor), dt = 0 on padded rows.
//
// Layout: x [B, S, H, P] bf16, dt [B, S, H] fp32, A [H] fp32, Bm and Cm
// [B, S, G, N] bf16, h0 (optional) and state [B, H, P, N] fp32, y
// [B, S, H, P] bf16, all contiguous.  Grid (H, B), 256 threads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 256;              // 16 row tiles: two per warp
constexpr int MAX_P = 128;              // y accumulator: 16 n8 tiles of P
constexpr int MAX_ST = 16;              // state n8 tiles per warp (64 floats)
constexpr int PAD = 8;                  // bf16 row padding: conflict-free ldmatrix
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t MAX_SMEM = 232448;     // an H100 CTA's dynamic shared memory
// mamba2-2.7b's head (chunk 128, P 64, N 128): the kernel is also compiled
// with these sizes fixed, so that every loop unrolls and C's fragments
// stay in registers; any other shape takes the sizes at run time.
constexpr int FQ = 128, FP = 64, FN = 128;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory, in bytes.  Two staging buffers, each x [Qp][Pp+8], B and
// C [Qp][Np+8] bf16 and dt [Qp] fp32; then the bf16 copy of the state
// [Pp][Np+8]; cum and w [Qp] fp32 (log2 units); the fp32 partial y tiles
// that warps hand to their partners [WARPS/2][16 Pp] (the fixed-shape
// kernel); each warp's bf16 y tile on its way out [WARPS][16][Pp+8]; the
// stages' two mbarriers (the fixed-shape kernel's TMA loads).
// repro_torch/kernels/ssd_scan.py: smem_bytes mirrors `bytes`.
struct Layout {
    int Qp, Pp, Np, ldx, ldb;           // padded sizes, bf16 row strides
    int x, bm, cm, dt, stage;           // offsets within a stage, its size
    int st, cum, w, xch, ys, bars, bytes;
    __host__ __device__ constexpr Layout(int Q, int P, int N)
        : Qp(round16(Q)), Pp(round16(P)), Np(round16(N)), ldx(Pp + PAD),
          ldb(Np + PAD), x(0), bm(2 * Qp * ldx), cm(bm + 2 * Qp * ldb),
          dt(cm + 2 * Qp * ldb), stage(dt + 4 * Qp), st(2 * stage),
          cum(st + 2 * Pp * ldb), w(cum + 4 * Qp), xch(w + 4 * Qp),
          ys(xch + 4 * (WARPS / 2) * 16 * Pp), bars(ys + 2 * WARPS * 16 * ldx),
          bytes(bars + 16) {}
};

// The state's warp tiling: warps in a grid of wm (over P's 16-row tiles,
// a power of two) by WARPS / wm (over N's n8 tiles, nw each, nw even).
// repro_torch/kernels/ssd_scan.py: state_tiles_per_warp mirrors nw.
struct Tiling {
    int wm, nw;
    __host__ __device__ constexpr Tiling(int Pp, int Np) : wm(1), nw(0) {
        while (wm < Pp / 16) wm *= 2;
        const int wn = wm <= WARPS ? WARPS / wm : 1;
        nw = (Np / 8 + wn - 1) / wn;
        nw += nw % 2;
    }
    __host__ __device__ constexpr bool fits() const { return wm <= WARPS && nw <= MAX_ST; }
    // Every warp holds nw tiles of the state and no tile lies past it.
    __host__ __device__ constexpr bool exact(int Pp, int Np) const {
        return wm == Pp / 16 && (WARPS / wm) * nw == Np / 8;
    }
};

struct Args {
    const bf16* x;
    const float* dt;
    const float* A;
    const bf16* Bm;
    const bf16* Cm;
    const float* h0;
    bf16* y;
    float* state;
    int S, H, P, G, N, Q;
    int vec;                            // rows are whole 16-byte pieces
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// A bf16 pair scaled by (w.x, w.y), rounded back to bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float2 w) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
    return pack_bf16(f.x * w.x, f.y * w.y);
}

// Start the TMA copies of chunk rows [t0, t0 + Q) of x, B and C into one
// stage (the fixed-shape kernel; one thread).  Each box is as wide as the
// padded shared-memory row, so the pad columns arrive as the map's
// out-of-bounds zeros.
__device__ __forceinline__ void tma_chunk(const Layout& lay, unsigned char* stage,
                                          uint64_t* bar, const CUtensorMap* tx,
                                          const CUtensorMap* tb, const CUtensorMap* tc,
                                          int b, int h, int g, int t0) {
    hopper::mbar_arrive_expect_tx(bar, 2 * lay.Qp * (lay.ldx + 2 * lay.ldb));
    hopper::tma_load_4d(stage + lay.x, tx, bar, 0, h, t0, b);
    hopper::tma_load_4d(stage + lay.bm, tb, bar, 0, g, t0, b);
    hopper::tma_load_4d(stage + lay.cm, tc, bar, 0, g, t0, b);
}

// Named barrier `id` over `threads` threads: wait for all, or only arrive.
__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(hopper::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src))
                 : "memory");
}

// rows x width bf16 from global rows `stride` elements apart into shared
// rows `ld` apart: 16-byte cp.async where the rows allow it, else plain
// loads (they land before the barrier that ends the chunk all the same).
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src,
                                          long long stride, int rows, int width,
                                          bool vec) {
    if (vec) {
        const int per = width / 8;
        for (int i = threadIdx.x; i < rows * per; i += THREADS) {
            const int r = i / per, c = (i % per) * 8;
            hopper::cp_async16(dst + r * ld + c, src + r * stride + c);
        }
    } else {
        for (int i = threadIdx.x; i < rows * width; i += THREADS) {
            const int r = i / width, c = i % width;
            dst[r * ld + c] = src[r * stride + c];
        }
    }
}

// Start the copies of chunk rows [t0, t0 + Q) of (b, h) into one stage.
__device__ __forceinline__ void load_chunk(const Args& a, const Layout& lay, int Q, int P,
                                           int N, unsigned char* stage, int b, int h,
                                           int g, int t0) {
    const long long row0 = (long long)b * a.S + t0;
    copy_rows(reinterpret_cast<bf16*>(stage + lay.x), lay.ldx,
              a.x + (row0 * a.H + h) * P, (long long)a.H * P, Q, P, a.vec);
    copy_rows(reinterpret_cast<bf16*>(stage + lay.bm), lay.ldb,
              a.Bm + (row0 * a.G + g) * N, (long long)a.G * N, Q, N, a.vec);
    copy_rows(reinterpret_cast<bf16*>(stage + lay.cm), lay.ldb,
              a.Cm + (row0 * a.G + g) * N, (long long)a.G * N, Q, N, a.vec);
    float* dts = reinterpret_cast<float*>(stage + lay.dt);
    for (int q = threadIdx.x; q < Q; q += THREADS)
        cp_async4(dts + q, a.dt + (row0 + q) * a.H + h);
}

// The bf16 copy of a warp's state tiles (the first `tiles` of st), rows
// 16 sm .. 16 sm + 15 and n8 tiles sn0 .., for the next chunk's C state^T.
template <int ST>
__device__ __forceinline__ void write_state(const float (&st)[ST][4], bf16* Sts,
                                            int ld, int sm, int sn0, int tiles) {
    const int gr = threadIdx.x % 32 / 4, qc = threadIdx.x % 4;
#pragma unroll
    for (int j = 0; j < ST; ++j) {
        if (j >= tiles) break;
        bf16* row = Sts + (sm * 16 + gr) * ld + (sn0 + j) * 8 + 2 * qc;
        *reinterpret_cast<uint32_t*>(row) = pack_bf16(st[j][0], st[j][1]);
        *reinterpret_cast<uint32_t*>(row + 8 * ld) = pack_bf16(st[j][2], st[j][3]);
    }
}

// FIXED: Q, P and N are mamba2-2.7b's (FQ, FP, FN), known at compile time,
// and x, B and C arrive by TMA through the maps tx, tb, tc; otherwise the
// sizes are read from the arguments, the loads are cp.async (or plain)
// and the maps are not read.  One source for both.
template <bool FIXED>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(Args a, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc) {
    const int h = blockIdx.x, b = blockIdx.y;
    const int g = h / (a.H / a.G);
    const int P = FIXED ? FP : a.P, N = FIXED ? FN : a.N, Q = FIXED ? FQ : a.Q;
    constexpr Layout FL(FQ, FP, FN);
    const Layout lay = FIXED ? FL : Layout(Q, P, N);
    const int Qp = lay.Qp, Pp = lay.Pp, Np = lay.Np, LDX = lay.ldx, LDB = lay.ldb;
    // Register arrays: y's n8 tiles, the state's n8 tiles, C's k16 fragments.
    constexpr int PT = FIXED ? FP / 8 : MAX_P / 8;
    constexpr Tiling FT(FP, FN);
    constexpr int ST = FIXED ? FT.nw : MAX_ST;
    constexpr bool EXACT = FIXED && FT.exact(FP, FN);
    constexpr int CF = FIXED ? FN / 16 : 1;
    constexpr int PER = (FIXED ? FQ : MAX_Q) / 32;      // cumsum rows per lane
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int gr = lane / 4, qc = lane % 4;          // mma fragment row, column pair
    const float a2 = a.A[h] * LOG2E;

    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Sts = reinterpret_cast<bf16*>(smem + lay.st);
    float* cw = reinterpret_cast<float*>(smem + lay.cum);
    float* ww = reinterpret_cast<float*>(smem + lay.w);
    bf16* ys = reinterpret_cast<bf16*>(smem + lay.ys) + warp * 16 * LDX;

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
    auto load = [&](int chunk) {
        unsigned char* stage = smem + (chunk % 2) * lay.stage;
        if constexpr (FIXED) {
            if (tid == 0) tma_chunk(lay, stage, &bars[chunk % 2], &tx, &tb, &tc, b, h, g, chunk * Q);
            float* dts = reinterpret_cast<float*>(stage + lay.dt);
            const long long row0 = (long long)b * a.S + (long long)chunk * Q;
            if (tid < Q) cp_async4(dts + tid, a.dt + (row0 + tid) * a.H + h);
        } else {
            load_chunk(a, lay, Q, P, N, stage, b, h, g, chunk * Q);
        }
    };
    if constexpr (FIXED) {
        // TMA fills every byte of x, B and C, pads included.
        if (tid == 0) {
            hopper::mbar_init(&bars[0], 1);
            hopper::mbar_init(&bars[1], 1);
            hopper::fence_barrier_init();
        }
    } else {
        // Zeros everywhere: the padding (rows past Q, columns past P and N,
        // dt on padded rows) is never written again.
        for (int i = tid; i < lay.bytes / 16; i += THREADS)
            reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    load(0);

    // This warp's part of the state: P rows 16 sm .. 16 sm + 15, n8 tiles
    // sn0 .. sn0 + nw - 1 (those below Np / 8).
    const Tiling til(Pp, Np);
    const int sm = warp % til.wm;
    const int sn0 = (warp / til.wm) * til.nw;
    const bool owns_state = EXACT || sm < Pp / 16;
    const int tiles = EXACT ? ST : min(til.nw, Np / 8 - sn0);
    float st[ST][4];
    const long long sbase = ((long long)b * a.H + h) * P * N;
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int p = sm * 16 + gr + (e / 2) * 8;
            const int n = (sn0 + j) * 8 + 2 * qc + e % 2;
            st[j][e] = a.h0 && owns_state && j < tiles && p < P && n < N
                ? a.h0[sbase + (long long)p * N + n] : 0.f;
        }

    if (owns_state) write_state(st, Sts, LDB, sm, sn0, tiles);
    hopper::cp_async_wait_all();
    __syncthreads();

    const int nc = a.S / Q;
    for (int c = 0; c < nc; ++c) {
        unsigned char* cur = smem + (c % 2) * lay.stage;
        if constexpr (FIXED) hopper::mbar_wait(&bars[c % 2], (c / 2) & 1);
        if (c + 1 < nc) load(c + 1);
        const bf16* Xs = reinterpret_cast<const bf16*>(cur + lay.x);
        const bf16* Bs = reinterpret_cast<const bf16*>(cur + lay.bm);
        const bf16* Cs = reinterpret_cast<const bf16*>(cur + lay.cm);
        const float* dts = reinterpret_cast<const float*>(cur + lay.dt);

        // -- cum (log2 units) and w: rows lane + 32 i, a shuffle scan per i
        // (independent), carried across i.  Every warp computes them and
        // writes the same values, so none waits for another ---------------
        float total = 0.f;
        {
            float cum[PER];
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const int q = lane + 32 * i;
                cum[i] = q < Qp ? dts[q] * a2 : 0.f;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const float v = __shfl_up_sync(0xffffffffu, cum[i], o);
                    if (lane >= o) cum[i] += v;
                }
            }
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const float run = __shfl_sync(0xffffffffu, cum[i], 31);
                cum[i] += total;
                total += run;
            }
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const int q = lane + 32 * i;
                if (q < Qp) {
                    cw[q] = cum[i];
                    ww[q] = exp2f(total - cum[i]) * dts[q];
                }
            }
            __syncwarp();
        }

        // -- y = exp(cum_t) (C state^T) + L x, per 16-row tile -------------
        // acc = [exp(cum_t) C state^T if inter] + L x over the 16-wide blocks
        // [sb0, sb1) of s, for rows t0 .. t0 + 15 of tile rt.
        auto tile = [&](float (&acc)[PT][4], int rt, int sb0, int sb1, bool inter) {
            const int t0 = rt * 16;
            const bf16* crow = Cs + (t0 + (lane % 8) + ((lane / 8) % 2) * 8) * LDB + (lane / 16) * 8;
            uint32_t cf[CF][4];              // C's A fragments, k16 slices of N
            if constexpr (FIXED) {
#pragma unroll
                for (int kk = 0; kk < CF; ++kk) hopper::ldmatrix_x4(cf[kk], crow + kk * 16);
            }
            auto c_frag = [&](uint32_t (&af)[4], int kk) {
                if constexpr (FIXED) {
#pragma unroll
                    for (int i = 0; i < 4; ++i) af[i] = cf[kk][i];
                } else {
                    hopper::ldmatrix_x4(af, crow + kk * 16);
                }
            };
#pragma unroll
            for (int j = 0; j < PT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
            const float ct[2] = {cw[t0 + gr], cw[t0 + gr + 8]};
            if (inter) {
#pragma unroll
                for (int kk = 0; kk < Np / 16; ++kk) {
                    uint32_t af[4];
                    c_frag(af, kk);
#pragma unroll
                    for (int j2 = 0; j2 < PT / 2; ++j2) {
                        if (j2 >= Pp / 16) break;
                        uint32_t bf[4];
                        hopper::ldmatrix_x4(bf, Sts + (j2 * 16 + (lane % 8) + (lane / 16) * 8) * LDB
                                                    + kk * 16 + ((lane / 8) % 2) * 8);
                        hopper::mma_16816(acc[2 * j2], af, bf[0], bf[1]);
                        hopper::mma_16816(acc[2 * j2 + 1], af, bf[2], bf[3]);
                    }
                }
                const float et[2] = {exp2f(ct[0]), exp2f(ct[1])};
#pragma unroll
                for (int j = 0; j < PT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] *= et[e / 2];
            }

            // C B^T of the 16-wide block sb of s, in two chains (even and
            // odd k16 slices); l_x adds them.
            auto cb_block = [&](float (&cb)[4][4], int sb) {
                const bf16* brow = Bs + (sb * 16 + (lane % 8) + (lane / 16) * 8) * LDB
                                   + ((lane / 8) % 2) * 8;
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e) cb[i][e] = 0.f;
#pragma unroll
                for (int kk = 0; kk < Np / 16; kk += 2) {
                    uint32_t af[4], bf[4];
                    c_frag(af, kk);
                    hopper::ldmatrix_x4(bf, brow + kk * 16);
                    hopper::mma_16816(cb[0], af, bf[0], bf[1]);
                    hopper::mma_16816(cb[1], af, bf[2], bf[3]);
                    if (kk + 1 < Np / 16) {
                        uint32_t af1[4], bf1[4];
                        c_frag(af1, kk + 1);
                        hopper::ldmatrix_x4(bf1, brow + (kk + 1) * 16);
                        hopper::mma_16816(cb[2], af1, bf1[0], bf1[1]);
                        hopper::mma_16816(cb[3], af1, bf1[2], bf1[3]);
                    }
                }
            };
            // L of block sb in registers, then acc += L x: the two n8 tiles
            // of C B^T are the two column halves of L's A fragment for
            // k = s0 .. s0 + 15.
            auto l_x = [&](float (&cb)[4][4], int sb) {
                const int s0 = sb * 16;
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    const int s = s0 + nt * 8 + 2 * qc;
                    const float2 cs = *reinterpret_cast<const float2*>(cw + s);
                    const float2 ds = *reinterpret_cast<const float2*>(dts + s);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int t = t0 + gr + (e / 2) * 8;
                        const float c_s = e % 2 ? cs.y : cs.x, d_s = e % 2 ? ds.y : ds.x;
                        const float v = cb[nt][e] + cb[2 + nt][e];
                        cb[nt][e] = s + e % 2 <= t ? v * exp2f(ct[e / 2] - c_s) * d_s : 0.f;
                    }
                }
                const uint32_t la[4] = {pack_bf16(cb[0][0], cb[0][1]), pack_bf16(cb[0][2], cb[0][3]),
                                        pack_bf16(cb[1][0], cb[1][1]), pack_bf16(cb[1][2], cb[1][3])};
#pragma unroll
                for (int j2 = 0; j2 < PT / 2; ++j2) {
                    if (j2 >= Pp / 16) break;
                    uint32_t bf[4];
                    hopper::ldmatrix_x4_trans(bf, Xs + (s0 + (lane % 8) + ((lane / 8) % 2) * 8) * LDX
                                                      + j2 * 16 + (lane / 16) * 8);
                    hopper::mma_16816(acc[2 * j2], la, bf[0], bf[1]);
                    hopper::mma_16816(acc[2 * j2 + 1], la, bf[2], bf[3]);
                }
            };
            if constexpr (FIXED) {
                // Block sb + 1's products are issued before block sb's L is
                // formed, so the tensor cores run while the exponentials
                // are taken (the generic kernel has no registers to spare).
                float cur[4][4], nxt[4][4];
                if (sb0 < sb1) cb_block(cur, sb0);
                for (int sb = sb0; sb < sb1; ++sb) {
                    if (sb + 1 < sb1) cb_block(nxt, sb + 1);
                    l_x(cur, sb);
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int e = 0; e < 4; ++e) cur[i][e] = nxt[i][e];
                }
            } else {
                for (int sb = sb0; sb < sb1; ++sb) {
                    float cb[4][4];
                    cb_block(cb, sb);
                    l_x(cb, sb);
                }
            }
        };

        // y rows t0 .. t0 + 15 of tile rt (those below Q) from acc: through
        // the warp's staging tile as 16-byte rows where P allows, else
        // element by element.
        auto store_y = [&](const float (&acc)[PT][4], int rt) {
            const int t0 = rt * 16;
            const long long yrow = ((long long)b * a.S + (long long)c * Q + t0) * a.H + h;
            if (FIXED || a.vec) {
#pragma unroll
                for (int j = 0; j < PT; ++j) {
                    if (j >= Pp / 8) break;
                    bf16* row = ys + gr * LDX + j * 8 + 2 * qc;
                    *reinterpret_cast<uint32_t*>(row) = pack_bf16(acc[j][0], acc[j][1]);
                    *reinterpret_cast<uint32_t*>(row + 8 * LDX) = pack_bf16(acc[j][2], acc[j][3]);
                }
                __syncwarp();
                const int per = P / 8;
                for (int i = lane; i < 16 * per; i += 32) {
                    const int r = i / per, c8 = (i % per) * 8;
                    if (t0 + r < Q)
                        *reinterpret_cast<uint4*>(a.y + (yrow + (long long)r * a.H) * P + c8) =
                            *reinterpret_cast<const uint4*>(ys + r * LDX + c8);
                }
                __syncwarp();
            } else {
#pragma unroll
                for (int j = 0; j < PT; ++j) {
                    if (j >= Pp / 8) break;
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int t = gr + half * 8, p = j * 8 + 2 * qc;
                        if (t0 + t >= Q || p >= P) continue;
                        bf16* dst = a.y + (yrow + (long long)t * a.H) * P + p;
                        dst[0] = __float2bfloat16(acc[j][2 * half]);
                        if (p + 1 < P) dst[1] = __float2bfloat16(acc[j][2 * half + 1]);
                    }
                }
            }
        };

        float acc[PT][4];
        if constexpr (FIXED) {
            // Eight row tiles: warps k and k + 4 (one SM sub-partition) share
            // tiles k (k + 1 blocks of s) and T = 7 - k (8 - k blocks).  Warp
            // k takes the first 4 - k blocks of T and hands its partial sum
            // (fragment order, lane-contiguous) to warp k + 4 under a named
            // barrier of the two warps; 5 blocks against 4.
            const int k = warp % 4, T = 7 - k, m = 4 - k;
            float* xch = reinterpret_cast<float*>(smem + lay.xch) + k * PT * 4 * 32;
            if (warp < 4) {
                tile(acc, T, 0, m, false);
#pragma unroll
                for (int j = 0; j < PT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) xch[(j * 4 + e) * 32 + lane] = acc[j][e];
                __threadfence_block();
                bar_arrive(1 + k, 64);
                tile(acc, k, 0, k + 1, true);
                store_y(acc, k);
            } else {
                tile(acc, T, m, T + 1, true);
                bar_sync(1 + k, 64);
#pragma unroll
                for (int j = 0; j < PT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] += xch[(j * 4 + e) * 32 + lane];
                store_y(acc, T);
            }
        } else {
            // Warp w takes tiles w and 15 - w if w < 4, else 11 - w and w + 4:
            // tiles k and 7 - k share an SM sub-partition.
            const int base = warp < 4 ? warp : 11 - warp;
#pragma unroll 1
            for (int r = 0; r < 2; ++r) {
                const int rt = r == 0 ? base : 15 - base;
                if (rt >= Qp / 16) continue;
                tile(acc, rt, 0, rt + 1, true);
                store_y(acc, rt);
            }
        }

        // -- state = state exp(cum_Q) + (x o w)^T B, in registers ----------
        if (owns_state) {
            const float decay = exp2f(total);
#pragma unroll
            for (int j = 0; j < ST; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) st[j][e] *= decay;
#pragma unroll
            for (int kk = 0; kk < Qp / 16; ++kk) {
                const int k0 = kk * 16;
                uint32_t af[4];
                hopper::ldmatrix_x4_trans(af, Xs + (k0 + (lane % 8) + (lane / 16) * 8) * LDX
                                                  + sm * 16 + ((lane / 8) % 2) * 8);
                const float2 w0 = *reinterpret_cast<const float2*>(ww + k0 + 2 * qc);
                const float2 w8 = *reinterpret_cast<const float2*>(ww + k0 + 8 + 2 * qc);
                af[0] = scale_bf16x2(af[0], w0);
                af[1] = scale_bf16x2(af[1], w0);
                af[2] = scale_bf16x2(af[2], w8);
                af[3] = scale_bf16x2(af[3], w8);
#pragma unroll
                for (int j2 = 0; j2 < ST / 2; ++j2) {
                    if (2 * j2 >= tiles) break;
                    uint32_t bf[4];
                    hopper::ldmatrix_x4_trans(bf, Bs + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * LDB
                                                      + (sn0 + 2 * j2) * 8 + (lane / 16) * 8);
                    hopper::mma_16816(st[2 * j2], af, bf[0], bf[1]);
                    hopper::mma_16816(st[2 * j2 + 1], af, bf[2], bf[3]);
                }
            }
        }
        __syncthreads();                 // every read of the entering state is done
        if (owns_state) write_state(st, Sts, LDB, sm, sn0, tiles);
        hopper::cp_async_wait_all();
        __syncthreads();                 // the next chunk and its state are in place
    }

    if (owns_state) {
#pragma unroll
        for (int j = 0; j < ST; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int p = sm * 16 + gr + (e / 2) * 8;
                const int n = (sn0 + j) * 8 + 2 * qc + e % 2;
                if (j < tiles && p < P && n < N) a.state[sbase + (long long)p * N + n] = st[j][e];
            }
    }
}

bool takes(int Q, int P, int N) {
    return Q > 0 && P > 0 && N > 0 && round16(Q) <= MAX_Q && round16(P) <= MAX_P &&
           Tiling(round16(P), round16(N)).fits() && (size_t)Layout(Q, P, N).bytes <= MAX_SMEM;
}

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

// Rank-4 map over a contiguous [batch, seq, heads, width] bf16 tensor:
// boxes of `rows` positions of one head, `box` columns wide (past `width`
// the box reads zeros), unswizzled.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int width, int heads,
                     int seq, int batch, int box, int rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t e = sizeof(bf16);
    const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                                (cuuint64_t)seq, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {width * e, (cuuint64_t)heads * width * e,
                                   (cuuint64_t)seq * heads * width * e};
    const cuuint32_t boxes[4] = {(cuuint32_t)box, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
        strides, boxes, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" long ssd_scan_smem_bytes(int Q, int P, int N) {
    return (long)Layout(Q, P, N).bytes;
}

extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* h0,
                            void* y, void* state, int B, int S, int H, int P,
                            int G, int N, int Q, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (S % Q || G <= 0 || H % G || !takes(Q, P, N)) return (int)cudaErrorInvalidValue;
    const int bytes = Layout(Q, P, N).bytes;
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const bool vec = P % 8 == 0 && N % 8 == 0 && aligned(x) && aligned(Bm) && aligned(Cm);
    const bool fixed = vec && Q == FQ && P == FP && N == FN;
    const auto kernel = fixed ? ssd_scan_kernel<true> : ssd_scan_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap tx{}, tb{}, tc{};
    if (fixed) {
        const Layout lay(Q, P, N);
        err = make_map(&tx, x, P, H, S, B, lay.ldx, Q);
        if (err == cudaSuccess) err = make_map(&tb, Bm, N, G, S, B, lay.ldb, Q);
        if (err == cudaSuccess) err = make_map(&tc, Cm, N, G, S, B, lay.ldb, Q);
        if (err != cudaSuccess) return (int)err;
    }
    Args a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const bf16*>(Bm),
           static_cast<const bf16*>(Cm), static_cast<const float*>(h0),
           static_cast<bf16*>(y), static_cast<float*>(state), S, H, P, G, N, Q, vec};
    kernel<<<dim3(H, B), THREADS, bytes, reinterpret_cast<cudaStream_t>(stream)>>>(a, tx, tb, tc);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
