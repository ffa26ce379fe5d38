// Mamba-2 SSD (state-space duality) scan backward for Hopper (sm_90a).
//
// Replaces the backward of repro/kernels/ops.py's ssd (XLA autodiff of
// _ssd_chunked_xla; there is no Pallas kernel for it).  Given the forward's
// inputs, dy and (optional) the final state's cotangent dhT, per chunk c of
// Q steps of one (batch, head), with cum_t = sum_{s<=t} dt_s A (within the
// chunk, total = cum_{Q-1}), h_c the state entering the chunk and dh the
// gradient of the state leaving it:
//   dh_c  = exp(total) dh + sum_t exp(cum_t) dy_t (x) C_t
//   u_s   = sum_{t>=s} (C_t . B_s) exp(cum_t - cum_s) dy_t
//           + exp(total - cum_s) dh B_s;       dx_s = dt_s u_s
//   Z[t,s]= (dy_t . x_s) exp(cum_t - cum_s) dt_s                 (s <= t)
//   dB_s  = sum_{t>=s} Z[t,s] C_t + exp(total - cum_s) dt_s x_s dh
//   dC_t  = sum_{s<=t} Z[t,s] B_s + exp(cum_t) dy_t h_c
//   da_s  = sum_{t>=s} (C_t . dC'_t - B_t . dB'_t)
//           + exp(total) <dh, h_c> + sum_{t<s} F_t
//   ddt_s = x_s . u_s + A da_s;  dA = sum dt_s da_s
// where dB' and dC' leave out the diagonal (Z[s,s]) and dC' keeps the h_c
// term, dB' drops the dh term, and F_t = dt_t x_t . (exp(total - cum_t)
// dh B_t).  (C . dC - B . dB summed from s to the chunk's end is the
// gradient of dt_s A; written this way no two terms cancel: the diagonal
// of Z appears in both dots and the F terms of rows t >= s in both the
// total's gradient and the rows', which under strong decay left only
// rounding noise, amplified by A, in ddt and dA.)  The triangle parts of
// C_t . dC'_t and B_t . dB'_t are the row and column sums of Z o (C B^T)
// off the diagonal; the h_c part is dy_t . (C_t h_c^T) exp(cum_t).  dB and
// dC of a group sum its heads'; dA sums batch and chunks.
//
// What bounds it on the card: at mamba2-2.7b's training shape (B 4, S 1024,
// 80 heads of P 64, N 128, G 1, chunk 128) the inputs and gradients are
// ~133 MB, ~40 us at 3.35 TB/s; the products the gradients need are 32.5
// GFLOP, ~33 us at the bf16 tensor-core rate.  A first design (one CTA per
// (batch, head, chunk), mma.sync on 16 x 16 triangle blocks, per-head fp32
// dB/dC partials summed by a reduction kernel, fp32 state scratch) ran
// ~25x above that; its chunk kernel was held back by neither its partials'
// stores nor mostly its products (without the triangles it ran 31%
// faster, without the state products 8%), but by one CTA an SM waiting on
// ~160 KB of loads with nothing to hide them, and its partials took a
// 0.12 ms reduction.
//
// What this design does about it: three CUDA kernels on one stream, no
// atomics (two launches give the same bits).
//   * ssd_bwd_walk_kernel, grid (H, B, 2): z = 0 walks the chunks forward
//     and writes the state entering each chunk, z = 1 walks them in reverse
//     from dhT and writes dh, the gradient of the state leaving each chunk
//     (and dh_0 to d(initial_state)), both as bf16 [B, H, nc, P64, Np]
//     (what the chunk pass feeds its products; half the bytes of fp32).
//     Both carry their [P, N] state in fp32 registers, tiled as the forward
//     tiles its state (Tiling), and add each chunk's (U o w)^T V on mma.sync
//     m16n8k16 with U o w rounded to bf16.  z = 0 also writes each chunk's
//     dt and cum (log2 units) as fp32 [B, H, nc, 2, Q64] for the chunk pass.
//   * ssd_bwd_chunk_kernel<TP, TN>, grid (G x slices, nc, B), 256 threads
//     (two warpgroups, each with its own registers up to 255): one CTA per
//     (batch, chunk, group, slice of R consecutive heads of the group; the
//     wrapper's plan picks R to fill the card: 20 at the training shape,
//     128 CTAs in one wave on 132 SMs).  It loads the chunk's B and C once
//     by TMA and forms C B^T once on wgmma (as B C^T: rows s, columns t;
//     the blocks with t >= s in bf16 in shared memory, each thread's own
//     accumulator values, so no barrier guards them; in fp32 they would
//     not fit at the training shape, and their rounding before the decay
//     is most of dA's error against fp32).  Each head's h_c, dh,
//     dt and cum arrive by TMA in a ring of two stages, its x and dy by TMA
//     into one buffer, issued as soon as the previous head's Z^T is formed
//     (its last reader), so loads run under the products.  Warpgroup w owns
//     rows 64w .. 64w + 63 of the chunk (padded to 64 with zeros; at a chunk
//     of 64 or less the second warpgroup returns, except at P = N = 128
//     where both take the rows and split dB's and dC's columns).  Per head,
//     on wgmma with fp32 accumulators, both warpgroups running the same
//     sequence (the chunk's whole tiles, the blocks the mask empties as
//     zeros, so no wgmma sits on a divergent path):
//       u  = e^(total - cum) (B dh^T) [then F]  + L'^T dy  [then dx, g],
//            L' = (C B^T o decay) as bf16 register A operands;
//       v  = C h^T [dotted with dy: the h_c part of the rows' dots],
//       dC += (dy o e^cum) h,   dB += (x o e^(total - cum) dt) dh,
//       Z^T = x dy^T (once), scaled in its accumulator (2^ of the masked
//            exponent only where the mask keeps the entry), its row and
//            column sums with C B^T off the diagonal, into its own bf16
//            tile;
//       dB += Z^T C and dC += Z B, both operands from shared memory (Z as
//            the MN-major view of Z^T), while warpgroup 0 sums the column
//            sums and warp 0 forms da by a reverse scan, ddt and the
//            chunk's part of dA.
//     dB and dC stay in the warpgroups' fp32 accumulators over the slice's
//     heads: 2 x 64 floats a thread at N 128, the reason Z B and Z^T C are
//     formed per head instead of once on Z summed over the heads (that
//     would hold Z's sum beside them too).  At the end the CTA writes one
//     fp32 dB and dC partial per head slice ([B, S, G x slices, N]).  What
//     the head loop derives from the thread's index, the layout and the
//     tiles' addresses it rebuilds in every head (opaque_int, opaque,
//     per_step): hoisted out of the loop they took the registers the
//     accumulators need and spilled.  Shared memory at the training shape:
//     B, C 64 KB, C B^T 24 KB, x and dy 32 KB, Z^T 32 KB, two stages of
//     33 KB, rows 6 KB: 225 KB.
//   * ssd_bwd_reduce_kernel sums each group's slices (dB, dC, in slice
//     order, to bf16) and dA over batch and chunks, in a fixed order.
//
// Layout: x, dy, dx [B, S, H, P] bf16; dt, ddt [B, S, H] fp32; A, dA [H]
// fp32; Bm, Cm, dB, dC [B, S, G, N] bf16; h0, dhT, dh0 [B, H, P, N] fp32
// (optional); all contiguous.  The kernels take chunks of at most 128 rows
// whose shared memory fits (the wrapper runs a longer chunk as equal
// sub-chunks: the same function).
// Ragged Q, P and N are padded with zeros: to 16 in the walks, to 64 in the
// chunk pass (TMA fills rows and columns past the tensor with zeros; where
// a row stride is no multiple of 16 bytes, x, dy, B and C are read with
// plain loads into the same swizzled tiles).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 128;              // the kernels' chunk: two 64-row tiles
constexpr int MAX_P = 128;              // u and v: two 64-column halves
constexpr int MAX_N = 128;              // dB and dC accumulators: 128 columns
constexpr int MAX_ST = 16;              // walk state n8 tiles per warp
constexpr int PAD = 8;                  // walk staging rows: conflict-free ldmatrix
constexpr int PER = MAX_Q / 32;         // cumsum rows per lane
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;        // an H100 CTA's dynamic shared memory
constexpr int STAGES = 2;               // the chunk kernel's ring of per-head loads
// A wait on a ring stage lasts at most a few heads' work: trap after ~2^24
// polls (seconds) instead of the default minutes.
constexpr uint32_t POLLS = 1u << 24;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int round64(int v) { return (v + 63) / 64 * 64; }
__host__ __device__ constexpr int round1024(int v) { return (v + 1023) / 1024 * 1024; }

// Walk kernel's shared memory, in bytes: two staging buffers, each U
// [Qp][Pp+8] and V [Qp][Np+8] bf16 and dt [Qp] fp32; then cum and the rows'
// weights [Qp] fp32.  repro_torch/kernels/ssd_scan_bwd.py: smem_bytes
// mirrors `bytes`.
struct WalkLayout {
    int Qp, Pp, Np, ldu, ldv;
    int u, v, dt, stage, cum, w, bytes;
    __host__ __device__ constexpr WalkLayout(int Q, int P, int N)
        : Qp(round16(Q)), Pp(round16(P)), Np(round16(N)), ldu(Pp + PAD),
          ldv(Np + PAD), u(0), v(2 * Qp * ldu), dt(v + 2 * Qp * ldv),
          stage(dt + 4 * Qp), cum(2 * stage), w(cum + 4 * Qp), bytes(w + 4 * Qp) {}
};

// Chunk kernel's shared memory, in bytes, each tile bf16 as boxes of
// [rows][64] with TMA's 128-byte swizzle: B and C [Q64][N64]; C B^T's
// blocks with t >= s (T (T + 1) / 2 blocks of 64 x 64, T = Q64 / 64, in
// accumulator order); the head's x and dy [Q64][P64]; Z^T [Q64][Q64];
// STAGES ring stages, each h_c and dh [P64][N64] and dt and cum [2][Q64]
// fp32; the rows' -row sums, F, g and h_c terms [4][Q64] and the warps'
// column sums [WARPS][Q64] (fp32); one fp32 per warp; four mbarriers; 1024
// bytes to align the start.  repro_torch/kernels/ssd_scan_bwd.py:
// smem_bytes mirrors `bytes`.
struct ChunkLayout {
    int Q64, P64, N64, T, bm, cm, cb, x, dy, zs, stage, hs, dhs, dtc, stage_bytes;
    int rows, cols, red, bar, bytes;
    __host__ __device__ constexpr ChunkLayout(int Q, int P, int N)
        : Q64(round64(Q)), P64(round64(P)), N64(round64(N)), T(Q64 / 64),
          bm(0), cm(bm + 2 * Q64 * N64), cb(cm + 2 * Q64 * N64),
          x(cb + 4096 * T * (T + 1)), dy(x + 2 * Q64 * P64), zs(dy + 2 * Q64 * P64),
          stage(zs + 2 * Q64 * Q64), hs(0), dhs(hs + 2 * P64 * N64), dtc(dhs + 2 * P64 * N64),
          stage_bytes(round1024(dtc + 8 * Q64)),
          rows(stage + STAGES * stage_bytes), cols(rows + 16 * Q64),
          red(cols + 32 * Q64), bar(red + 4 * WARPS), bytes(bar + 32 + 1024) {}
};
// The largest padded chunks the kernel takes fit their ring; a chunk of
// 128 at P and N of 128 does not, takes() refuses it, and the wrapper runs
// it as two chunks of 64.
static_assert(ChunkLayout(128, 64, 128).bytes <= MAX_SMEM &&
                  ChunkLayout(128, 128, 64).bytes <= MAX_SMEM &&
                  ChunkLayout(64, 128, 128).bytes <= MAX_SMEM,
              "two ring stages fit every chunk the kernel takes");

// The walk state's warp tiling, the forward's: warps in a grid of wm (over
// P's 16-row tiles, a power of two) by WARPS / wm (over N's n8 tiles, nw
// each, nw even).  repro_torch/kernels/ssd_scan.py: state_tiles_per_warp
// mirrors nw.
struct Tiling {
    int wm, nw;
    __host__ __device__ constexpr Tiling(int Pp, int Np) : wm(1), nw(0) {
        while (wm < Pp / 16) wm *= 2;
        const int wn = wm <= WARPS ? WARPS / wm : 1;
        nw = (Np / 8 + wn - 1) / wn;
        nw += nw % 2;
    }
};

struct Args {
    const bf16* x;
    const bf16* dy;
    const bf16* Bm;
    const bf16* Cm;
    const float* dt;
    const float* A;
    const float* dhT;                   // optional
    const float* h0;                    // optional
    bf16* states;                       // [B, H, nc, P64, Np]
    bf16* dstates;                      // [B, H, nc, P64, Np]
    float* dtc;                         // [B, H, nc, 2, Q64]
    float* pdB;                         // [B, S, G x slices, N]
    float* pdC;                         // [B, S, G x slices, N]
    float* pdA;                         // [B, H, nc]
    bf16* dx;
    float* ddt;
    float* dA;
    bf16* dB;
    bf16* dC;
    float* dh0;                         // optional
    int B, S, H, P, G, N, Q, nc;
    int R, n_sl;                        // heads per slice, slices per group
    int vec;                            // x, dy, B, C rows are whole 16-byte pieces
    int exact;                          // Q, P and N are multiples of 16
};

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// A bf16 pair scaled by (w.x, w.y), rounded back to bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float2 w) {
    const float2 f = unpack_bf16(v);
    return pack_bf16(f.x * w.x, f.y * w.y);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src))
                 : "memory");
}

// rows x width bf16 from global rows `stride` elements apart into shared
// rows `ld` apart: 16-byte cp.async where the rows allow it, else plain
// loads (they land before the barrier that follows all the same).
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src,
                                          long long stride, int rows, int width,
                                          bool vec) {
    if (vec) {
        const int per = width / 8;
        for (int i = threadIdx.x; i < rows * per; i += THREADS) {
            const int r = i / per, c = (i % per) * 8;
            cp_async16(dst + r * ld + c, src + r * stride + c);
        }
    } else {
        for (int i = threadIdx.x; i < rows * width; i += THREADS) {
            const int r = i / width, c = i % width;
            dst[r * ld + c] = src[r * stride + c];
        }
    }
}

__device__ __forceinline__ void copy_dt(float* dst, const float* src, int H, int rows) {
    for (int q = threadIdx.x; q < rows; q += THREADS) cp_async4(dst + q, src + (long long)q * H);
}

// Inclusive cumsum of dt * a2 over the chunk's Qp rows (log2 units), by one
// warp: rows lane + 32 i, a shuffle scan per i, carried across i.  Writes
// cum[q] and returns the chunk's total; cum[i] past Qp holds the total.
__device__ __forceinline__ float chunk_cumsum(const float* dts, float a2, int Qp, float* cum_out,
                                              float (&cum)[PER]) {
    const int lane = threadIdx.x % 32;
    float total = 0.f;
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
        if (q < Qp) cum_out[q] = cum[i];
    }
    return total;
}

// Sum over the four lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

// Byte offset of element (row, col) of a tile of [rows][64] bf16 boxes
// `box` bytes apart, 128-byte swizzled as TMA writes it: 16-byte chunk c of
// row r lies at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t sw_off(int row, int col, uint32_t box) {
    return (col / 64) * box + row * 128 + ((((col % 64) / 8) ^ (row % 8)) << 4) + (col % 8) * 2;
}

// The dots of a 64 x W accumulator's two rows of this thread (row_a and
// row_a + 8) with the same rows of a swizzled bf16 tile; every lane of a
// quad gets its rows' sums.
template <int W>
__device__ __forceinline__ void row_dots(const float (&acc)[W / 2], const unsigned char* tile,
                                         uint32_t box, int row_a, int lane, float (&out)[2]) {
    const int qc = lane % 4;
    out[0] = out[1] = 0.f;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const float2 m = unpack_bf16(*reinterpret_cast<const uint32_t*>(
                tile + sw_off(row_a + 8 * half, 8 * j + 2 * qc, box)));
            out[half] += m.x * acc[4 * j + 2 * half] + m.y * acc[4 * j + 2 * half + 1];
        }
    out[0] = quad_sum(out[0]);
    out[1] = quad_sum(out[1]);
}

// The A fragment of k16 slice kk of a swizzled tile's rows r0 .. r0 + 15
// (this warp's rows of its warpgroup's 64), each row scaled by its weight
// (w0 for row r0 + lane / 4, w8 eight rows further) and rounded to bf16.
__device__ __forceinline__ void scaled_a(uint32_t (&af)[4], const unsigned char* tile,
                                         uint32_t box, int r0, int kk, int lane, float w0, float w8) {
    const int row = r0 + (lane % 8) + ((lane / 8) % 2) * 8;
    ldmatrix_x4(af, tile + sw_off(row, 16 * kk + (lane / 16) * 8, box));
    af[0] = scale_bf16x2(af[0], make_float2(w0, w0));
    af[1] = scale_bf16x2(af[1], make_float2(w8, w8));
    af[2] = scale_bf16x2(af[2], make_float2(w0, w0));
    af[3] = scale_bf16x2(af[3], make_float2(w8, w8));
}

// rows x width of a bf16 global tensor (rows `stride` elements apart) into
// a swizzled tile of `tile_rows` rows and W columns, zeros past them, by
// the first `nthr` threads.
__device__ __forceinline__ void load_tile(unsigned char* tile, uint32_t box, int tile_rows, int W,
                                          const bf16* src, long long stride, int rows, int width,
                                          int nthr) {
    const int pieces = W / 8;
    for (int i = threadIdx.x; i < tile_rows * pieces; i += nthr) {
        const int r = i / pieces, c8 = (i % pieces) * 8;
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int col = c8 + 2 * e;
            const bf16* p = src + r * stride + col;
            const float lo = r < rows && col < width ? __bfloat162float(p[0]) : 0.f;
            const float hi = r < rows && col + 1 < width ? __bfloat162float(p[1]) : 0.f;
            w[e] = pack_bf16(lo, hi);      // bf16 values: exact
        }
        *reinterpret_cast<uint4*>(tile + sw_off(r, c8, box)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// 2^x by the special-function unit (relative error ~2^-22, results below
// 2^-126 flushed to 0): each masked decay is rounded to bf16 or multiplies
// a sum that is.
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// `p`, opaque to the compiler, so that descriptors built from it inside the
// head loop are built there and not hoisted out of it into registers.
__device__ __forceinline__ unsigned char* opaque(unsigned char* p) {
    asm volatile("" : "+l"(p));
    return p;
}

// The same for an index: the shared-memory offsets a thread derives from it
// in the head loop (dozens of them, the same in every head) are computed
// there, not kept in registers across it.
__device__ __forceinline__ int opaque_int(int v) {
    asm volatile("" : "+r"(v));
    return v;
}

// Keeps the compiler from moving shared-memory loads across it: bounds how
// many a long unrolled loop holds in registers at once.
__device__ __forceinline__ void compiler_barrier() { asm volatile("" ::: "memory"); }

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
}

// ------------------------------------------------------------------- walks
// z = 0: the state entering each chunk, forward from h0 (and each chunk's
// dt and cum); z = 1: dh, the gradient of the state leaving each chunk, in
// reverse from dhT.
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_walk_kernel(Args a) {
    const int h = blockIdx.x, b = blockIdx.y, dir = blockIdx.z;
    const int g = h / (a.H / a.G);
    const int P = a.P, N = a.N, Q = a.Q, nc = a.nc;
    const WalkLayout lay(Q, P, N);
    const int Qp = lay.Qp, Pp = lay.Pp, Np = lay.Np, LDU = lay.ldu, LDV = lay.ldv;
    const int P64 = round64(P), Q64 = round64(Q);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int gr = lane / 4, qc = lane % 4;
    const float a2 = a.A[h] * LOG2E;
    const bf16* U = dir ? a.dy : a.x;   // [B, S, H, P]
    const bf16* V = dir ? a.Cm : a.Bm;  // [B, S, G, N]

    extern __shared__ __align__(128) unsigned char smem[];
    float* cw = reinterpret_cast<float*>(smem + lay.cum);
    float* ww = reinterpret_cast<float*>(smem + lay.w);
    if (!a.exact) {
        // Zeros: the padding (rows past Q, columns past P and N, dt on
        // padded rows) is never written again.
        for (int i = tid; i < lay.bytes / 16; i += THREADS)
            reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
        __syncthreads();
    }
    auto load = [&](int k) {
        const int c = dir ? nc - 1 - k : k;
        unsigned char* stage = smem + (k % 2) * lay.stage;
        const long long row0 = (long long)b * a.S + (long long)c * Q;
        copy_rows(reinterpret_cast<bf16*>(stage + lay.u), LDU, U + (row0 * a.H + h) * P,
                  (long long)a.H * P, Q, P, a.vec);
        copy_rows(reinterpret_cast<bf16*>(stage + lay.v), LDV, V + (row0 * a.G + g) * N,
                  (long long)a.G * N, Q, N, a.vec);
        copy_dt(reinterpret_cast<float*>(stage + lay.dt), a.dt + row0 * a.H + h, a.H, Q);
    };
    load(0);

    // This warp's part of the state: rows 16 sm .. 16 sm + 15, n8 tiles
    // sn0 .. sn0 + tiles - 1.
    const Tiling til(Pp, Np);
    const int sm = warp % til.wm;
    const int sn0 = (warp / til.wm) * til.nw;
    const bool owns = sm < Pp / 16 && sn0 < Np / 8;
    const int tiles = owns ? min(til.nw, Np / 8 - sn0) : 0;
    float st[MAX_ST][4];
    const float* init = dir ? a.dhT : a.h0;
    const long long sbase = ((long long)b * a.H + h) * P * N;
#pragma unroll
    for (int j = 0; j < MAX_ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int p = sm * 16 + gr + (e / 2) * 8;
            const int n = (sn0 + j) * 8 + 2 * qc + e % 2;
            st[j][e] = init && j < tiles && p < P && n < N ? init[sbase + (long long)p * N + n] : 0.f;
        }
    // The bf16 scratch: [P64][Np] per chunk; rows past Pp stay the
    // wrapper's zeros.
    bf16* out = dir ? a.dstates : a.states;
    const long long slot0 = ((long long)b * a.H + h) * nc;
    auto store = [&](int c) {
        bf16* o = out + (slot0 + c) * P64 * Np;
#pragma unroll
        for (int j = 0; j < MAX_ST; ++j) {
            if (j >= tiles) break;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int p = sm * 16 + gr + half * 8, n = (sn0 + j) * 8 + 2 * qc;
                *reinterpret_cast<uint32_t*>(o + p * Np + n) =
                    pack_bf16(st[j][2 * half], st[j][2 * half + 1]);
            }
        }
    };

    for (int k = 0; k < nc; ++k) {
        const int c = dir ? nc - 1 - k : k;
        cp_async_wait_all();
        __syncthreads();                 // chunk k landed; stage (k + 1) % 2 is free
        if (k + 1 < nc) load(k + 1);
        const unsigned char* cur = smem + (k % 2) * lay.stage;
        const bf16* Us = reinterpret_cast<const bf16*>(cur + lay.u);
        const bf16* Vs = reinterpret_cast<const bf16*>(cur + lay.v);
        const float* dts = reinterpret_cast<const float*>(cur + lay.dt);

        // cum and the rows' weights: every warp computes them and writes the
        // same values, so none waits for another.
        float cum[PER];
        const float total = chunk_cumsum(dts, a2, Qp, cw, cum);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int q = lane + 32 * i;
            if (q < Qp) ww[q] = dir ? exp2f(cum[i]) : exp2f(total - cum[i]) * dts[q];
        }
        __syncwarp();
        if (dir == 0 && warp == 0) {
            // dt and cum of the chunk's Q64 rows for the chunk pass (past
            // Q: dt 0 and cum the total).
            float* o = a.dtc + (slot0 + c) * 2 * Q64;
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const int q = lane + 32 * i;
                if (q < Q64) {
                    o[q] = q < Qp ? dts[q] : 0.f;
                    o[Q64 + q] = cum[i];
                }
            }
        }

        store(c);
        if (owns) {
            const float decay = exp2f(total);
#pragma unroll
            for (int j = 0; j < MAX_ST; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) st[j][e] *= decay;
            for (int kk = 0; kk < Qp / 16; ++kk) {
                const int k0 = kk * 16;
                uint32_t af[4];
                ldmatrix_x4_trans(af, Us + (k0 + (lane % 8) + (lane / 16) * 8) * LDU
                                          + sm * 16 + ((lane / 8) % 2) * 8);
                const float2 w0 = *reinterpret_cast<const float2*>(ww + k0 + 2 * qc);
                const float2 w8 = *reinterpret_cast<const float2*>(ww + k0 + 8 + 2 * qc);
                af[0] = scale_bf16x2(af[0], w0);
                af[1] = scale_bf16x2(af[1], w0);
                af[2] = scale_bf16x2(af[2], w8);
                af[3] = scale_bf16x2(af[3], w8);
#pragma unroll
                for (int j2 = 0; j2 < MAX_ST / 2; ++j2) {
                    if (2 * j2 >= tiles) break;
                    uint32_t bf[4];
                    ldmatrix_x4_trans(bf, Vs + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * LDV
                                              + (sn0 + 2 * j2) * 8 + (lane / 16) * 8);
                    mma_16816(st[2 * j2], af, bf[0], bf[1]);
                    mma_16816(st[2 * j2 + 1], af, bf[2], bf[3]);
                }
            }
        }
    }

    if (dir == 1 && a.dh0) {
#pragma unroll
        for (int j = 0; j < MAX_ST; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int p = sm * 16 + gr + (e / 2) * 8;
                const int n = (sn0 + j) * 8 + 2 * qc + e % 2;
                if (j < tiles && p < P && n < N) a.dh0[sbase + (long long)p * N + n] = st[j][e];
            }
    }
}

// ------------------------------------------------------------------ chunks
// The heads of slice `sl` of group g: h0 .. h0 + nh - 1, R a slice and the
// last slice what is left.  repro_torch/kernels/ssd_scan_bwd.py:
// chunk_schedule mirrors it and the rows each warpgroup takes (warpgroup w:
// rows 64w .. 64w + 63, if the chunk has them).
__device__ __forceinline__ int2 slice_heads(int g, int sl, int rep, int R) {
    return make_int2(g * rep + sl * R, min(R, rep - sl * R));
}

// Index of C B^T's block (rows tile i, columns tile j >= i) of T x T.
__device__ __forceinline__ int cb_block(int i, int j, int T) {
    return i * (2 * T - i + 1) / 2 + (j - i);
}

// Issue the TMA loads of head h's h_c, dh, dt and cum into a ring stage
// (one thread).
template <int TN>
__device__ __forceinline__ void load_head(unsigned char* st, const ChunkLayout& lay, uint64_t* full,
                                          const CUtensorMap* th, const CUtensorMap* tdh,
                                          const CUtensorMap* tdc, int slot) {
    const uint32_t pbox = lay.P64 * 128;
    mbar_arrive_expect_tx(full, 4u * lay.P64 * lay.N64 + 8u * lay.Q64);
#pragma unroll
    for (int k = 0; k < TN; ++k) {
        tma_load_3d(st + lay.hs + k * pbox, th, full, 64 * k, 0, slot);
        tma_load_3d(st + lay.dhs + k * pbox, tdh, full, 64 * k, 0, slot);
    }
    tma_load_3d(st + lay.dtc, tdc, full, 0, 0, slot);
}

// Issue the TMA loads of head h's x and dy of chunk c (one thread).
template <int TP>
__device__ __forceinline__ void load_xy(unsigned char* smem, const ChunkLayout& lay, uint64_t* bar,
                                        const CUtensorMap* tx, const CUtensorMap* tdy, int h, int c,
                                        int b) {
    const uint32_t qbox = lay.Q64 * 128;
    mbar_arrive_expect_tx(bar, 4u * lay.Q64 * lay.P64);
#pragma unroll
    for (int k = 0; k < TP; ++k) {
        tma_load_5d(smem + lay.x + k * qbox, tx, bar, 64 * k, h, 0, c, b);
        tma_load_5d(smem + lay.dy + k * qbox, tdy, bar, 64 * k, h, 0, c, b);
    }
}

// TP, TN: P and N padded to 64, in 64-column boxes.  Both warpgroups run
// the same sequence of products (the chunk's whole T x T tiles of Z^T and
// L', the blocks the mask empties as zeros), so no wgmma sits on a
// divergent path.
template <int TP, int TN>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                     const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                     const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tdh,
                     const __grid_constant__ CUtensorMap tdc, const Args a) {
    constexpr int PW = 64 * TP, NW = 64 * TN;
    // At P and N of 128 a chunk has one 64-row tile (takes): both warpgroups
    // take its rows, each 64 of dB's and dC's columns (their accumulators
    // would not fit one thread's registers beside the rest).
    constexpr bool SPLIT = TP == 2 && TN == 2;
    constexpr int NA = SPLIT ? 64 : NW;     // accumulator columns
    const ChunkLayout lay(a.Q, a.P, a.N);
    const int Q64 = lay.Q64, T = lay.T;
    const uint32_t qbox = Q64 * 128;        // bytes of a [Q64][64] box

    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem_base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* smem = smem_base;
    unsigned char* Bs = smem + lay.bm;
    unsigned char* Cs = smem + lay.cm;
    uint32_t* CBs = reinterpret_cast<uint32_t*>(smem + lay.cb);
    // rows: [4][Q64] (-row sums, F, g, h_c terms); cols: [WARPS][Q64]; red:
    // [WARPS]; mbarriers: B and C, x and dy, the ring's stages.
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
    uint64_t* bc_full = bars;
    uint64_t* xy_full = bars + 1;
    uint64_t* full = bars + 2;

    const int rep = a.H / a.G;
    const int g = blockIdx.x / a.n_sl, sl = blockIdx.x % a.n_sl;
    const int c = blockIdx.y, b = blockIdx.z;
    const int2 heads = slice_heads(g, sl, rep, a.R);
    const int tid = threadIdx.x, wg = tid / 128, ct = tid % 128;
    const int warp = tid / 32, wi = warp % 4, lane = tid % 32;
    const int gr = lane / 4, qc = lane % 4;
    const long long row0 = (long long)b * a.S + (long long)c * a.Q;
    const bool vec = a.vec;

    if (tid == 0) {
        mbar_init(bc_full, 1);
        mbar_init(xy_full, 1);
        for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
        fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
        if (vec) {
            mbar_arrive_expect_tx(bc_full, 4u * Q64 * NW);
#pragma unroll
            for (int k = 0; k < TN; ++k) {
                tma_load_5d(Bs + k * qbox, &tb, bc_full, 64 * k, g, 0, c, b);
                tma_load_5d(Cs + k * qbox, &tc, bc_full, 64 * k, g, 0, c, b);
            }
            load_xy<TP>(smem, lay, xy_full, &tx, &tdy, heads.x, c, b);
        }
        for (int i = 0; i < min(STAGES, heads.y); ++i)
            load_head<TN>(smem + lay.stage + i * lay.stage_bytes, lay, full + i, &th, &tdh, &tdc,
                          (b * a.H + heads.x + i) * a.nc + c);
    }
    if (!vec) {
        const long long bc0 = row0 * a.G * a.N + (long long)g * a.N;
        load_tile(Bs, qbox, Q64, NW, a.Bm + bc0, (long long)a.G * a.N, a.Q, a.N, THREADS);
        load_tile(Cs, qbox, Q64, NW, a.Cm + bc0, (long long)a.G * a.N, a.Q, a.N, THREADS);
        fence_proxy_async();
        __syncthreads();
    }
    // A chunk of 64 rows or fewer has one tile: the second warpgroup is done.
    if (!SPLIT && wg >= T) return;
    const int nthr = SPLIT ? THREADS : 128 * T;   // the threads left
    const int r0 = SPLIT ? 0 : 64 * wg;      // this warpgroup's first row
    const int rt = r0 / 64;                  // and its row tile
    const int n0 = SPLIT ? 64 * wg : 0;      // its first column of dB and dC
    const int row_a = r0 + 16 * wi + gr, row_b = row_a + 8;   // this thread's rows
    if (vec) mbar_wait(bc_full, 0, POLLS);

    // C B^T once, as B C^T (rows s of this warpgroup, columns t >= its
    // rows' tile), rounded to bf16; each thread keeps its own values.
    for (int j = rt; j < T; ++j) {
        float acc[32];
        wgmma_fence();
        wgmma_ss_tiles<NW>(acc, desc_sw128(Bs + r0 * 128, 0, 1024), qbox,
                           desc_sw128(Cs + j * 64 * 128, 0, 1024), qbox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(acc);
        uint32_t* dst = CBs + cb_block(rt, j, T) * 16 * 128 + ct;
#pragma unroll
        for (int r = 0; r < 16; ++r) dst[r * 128] = pack_bf16(acc[2 * r], acc[2 * r + 1]);
    }

    float dB[NA / 2], dC[NA / 2];           // this warpgroup's part of the slice's sums
    zero(dB);
    zero(dC);

    for (int i = 0; i < heads.y; ++i) {
        // This thread's indices, the layout and the tiles' addresses,
        // rebuilt in every head (see opaque_int).
        const int tid = opaque_int(threadIdx.x);
        const int ct = tid % 128, warp = tid / 32, wi = warp % 4, lane = tid % 32;
        const int gr = lane / 4, qc = lane % 4;
        const int row_a = r0 + 16 * wi + gr, row_b = row_a + 8;
        const ChunkLayout lay(opaque_int(a.Q), opaque_int(a.P), opaque_int(a.N));
        const int Q64 = lay.Q64, T = lay.T;
        const uint32_t qbox = Q64 * 128, pbox = PW * 128;
        unsigned char* smem = opaque(smem_base);
        unsigned char* Bs = smem + lay.bm;
        unsigned char* Cs = smem + lay.cm;
        const uint32_t* CBs = reinterpret_cast<const uint32_t*>(smem + lay.cb);
        unsigned char* Xs = smem + lay.x;
        unsigned char* DYs = smem + lay.dy;
        unsigned char* Zs = smem + lay.zs;
        float* rows = reinterpret_cast<float*>(smem + lay.rows);
        float* cols = reinterpret_cast<float*>(smem + lay.cols);
        float* red = reinterpret_cast<float*>(smem + lay.red);
        uint64_t* xy_full = reinterpret_cast<uint64_t*>(smem + lay.bar) + 1;
        uint64_t* full = xy_full + 1;
        const int s = i % STAGES;
        unsigned char* st = smem + lay.stage + s * lay.stage_bytes;
        unsigned char* Hs = st + lay.hs;
        unsigned char* DHs = st + lay.dhs;
        const float* dts = reinterpret_cast<const float*>(st + lay.dtc);
        const float* cw = dts + Q64;
        const int h = heads.x + i;
        if (!vec) {
            const long long xy0 = (row0 * a.H + h) * a.P;
            load_tile(Xs, qbox, Q64, PW, a.x + xy0, (long long)a.H * a.P, a.Q, a.P, nthr);
            load_tile(DYs, qbox, Q64, PW, a.dy + xy0, (long long)a.H * a.P, a.Q, a.P, nthr);
            fence_proxy_async();
        }
        mbar_wait(full + s, (i / STAGES) & 1, POLLS);
        if (vec) mbar_wait(xy_full, i & 1, POLLS);
        else named_barrier_sync(1, nthr);

        // <dh, h_c>: each thread a fixed share of the two tiles (one
        // swizzle, so the same offsets), summed by warp, then in warp order.
        {
            const uint32_t* hw = reinterpret_cast<const uint32_t*>(Hs);
            const uint32_t* dw = reinterpret_cast<const uint32_t*>(DHs);
            float hd = 0.f;
#pragma unroll 1
            for (int k = tid; k < PW * NW / 2; k += nthr) {
                const float2 u = unpack_bf16(hw[k]), v = unpack_bf16(dw[k]);
                hd += u.x * v.x + u.y * v.y;
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) hd += __shfl_xor_sync(0xffffffffu, hd, o);
            if (lane == 0) red[warp] = hd;
        }
        const float total = cw[Q64 - 1];     // padded rows have dt = 0
        const float Ah = a.A[h];
        const float cs[2] = {cw[row_a], cw[row_b]};
        const float ds[2] = {dts[row_a], dts[row_b]};
        // F, g and the h_c term of this thread's rows go to `rows` as they
        // come (summed there over P's 64-column halves; by one warpgroup
        // where both take the rows, since both adding would race and
        // launches would differ in ddt and dA; what both do write, C B^T,
        // Z^T and the row sums, they write with the same values).
        auto put = [&](int k, int ph, float v0, float v1) {
            if (qc == 0 && (!SPLIT || wg == 0)) {
                float* r = rows + k * Q64;
                r[row_a] = ph ? r[row_a] + v0 : v0;
                r[row_b] = ph ? r[row_b] + v1 : v1;
            }
        };

        // -- u = es (B dh^T), then F; + L'^T dy over t < Q64, then g, dx;
        // 64 columns of P at a time (L' formed again for the second) -------
#pragma unroll 1
        for (int ph = 0; ph < TP; ++ph) {
            const float es[2] = {ex2(total - cs[0]), ex2(total - cs[1])};
            float u[32], dots[2];
            wgmma_fence();
            wgmma_ss_tiles<NW>(u, per_step(desc_sw128(opaque(Bs) + r0 * 128, 0, 1024)), qbox,
                               desc_sw128(DHs + ph * 64 * 128, 0, 1024), pbox);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<32>(u);
#pragma unroll
            for (int k = 0; k < 32; ++k) u[k] *= es[(k >> 1) & 1];
            row_dots<64>(u, Xs + ph * qbox, qbox, row_a, lane, dots);
            put(1, ph, ds[0] * dots[0], ds[1] * dots[1]);
            const uint64_t dy_mn = per_step(desc_sw128(DYs + ph * qbox, qbox, 1024));
#pragma unroll 1
            for (int jq = 0; jq < 2 * T; ++jq) {
                // L' of 32 columns (half jq % 2 of tile j): C B^T o
                // exp2(cum_t - cum_s) where t >= s, zeros in a tile left of
                // this warpgroup's rows
                const int j = jq / 2;
                uint32_t la[2][4];
                if (j >= rt) {
                    const uint32_t* cb = CBs + cb_block(rt, j, T) * 16 * 128 + ct;
#pragma unroll
                    for (int r8 = 0; r8 < 8; ++r8) {
                        const int r = 8 * (jq % 2) + r8;    // accumulator pair of the tile
                        const float2 v = unpack_bf16(cb[r * 128]);
                        const int half = r & 1, srow = half ? row_b : row_a;
                        const int t = 64 * j + 8 * (r >> 1) + 2 * qc;
                        const float2 ct2 = *reinterpret_cast<const float2*>(cw + t);
                        const float lo = t >= srow ? v.x * ex2(ct2.x - cs[half]) : 0.f;
                        const float hi = t + 1 >= srow ? v.y * ex2(ct2.y - cs[half]) : 0.f;
                        la[r8 / 4][r8 % 4] = pack_bf16(lo, hi);
                        if (r8 % 4 == 3) compiler_barrier();
                    }
                } else {
#pragma unroll
                    for (int r8 = 0; r8 < 8; ++r8) la[r8 / 4][r8 % 4] = 0u;
                }
                fence_regs<32>(u);
                fence_regs<4>(la[0]);
                fence_regs<4>(la[1]);
                wgmma_fence();
                wgmma_rs<64>(u, la[0], desc_at(dy_mn, (2 * jq) * 2048));
                wgmma_rs<64>(u, la[1], desc_at(dy_mn, (2 * jq + 1) * 2048));
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs<32>(u);
            }
            row_dots<64>(u, Xs + ph * qbox, qbox, row_a, lane, dots);
            put(2, ph, dots[0], dots[1]);
            const long long drow = row0 * a.H + h;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int t = half ? row_b : row_a, p = 64 * ph + 8 * j + 2 * qc;
                    if (t >= a.Q || p >= a.P) continue;
                    bf16* dst = a.dx + (drow + (long long)t * a.H) * a.P + p;
                    const float v0 = ds[half] * u[4 * j + 2 * half];
                    const float v1 = ds[half] * u[4 * j + 2 * half + 1];
                    if (p + 1 < a.P && a.P % 2 == 0) {
                        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
                    } else {
                        dst[0] = __float2bfloat16(v0);
                        if (p + 1 < a.P) dst[1] = __float2bfloat16(v1);
                    }
                }
        }

        // -- v = C h^T (the h_c term, 64 columns of P at a time), then
        // dC += (dy o e^cum) h and dB += (x o e^(total - cum) dt) dh, 64 rows
        // of h and dh (k) at a time --------------------------------------
#pragma unroll 1
        for (int ph = 0; ph < TP; ++ph) {
            float v[32], dots[2];
            wgmma_fence();
            wgmma_ss_tiles<NW>(v, per_step(desc_sw128(opaque(Cs) + r0 * 128, 0, 1024)), qbox,
                               desc_sw128(Hs + ph * 64 * 128, 0, 1024), pbox);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<32>(v);
            row_dots<64>(v, DYs + ph * qbox, qbox, row_a, lane, dots);
            put(3, ph, ex2(cs[0]) * dots[0], ex2(cs[1]) * dots[1]);
        }
#pragma unroll 1
        for (int ph = 0; ph < TP; ++ph) {
            const float ec[2] = {ex2(cs[0]), ex2(cs[1])};
            uint32_t fa[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                scaled_a(fa[kk], DYs, qbox, r0 + 16 * wi, 4 * ph + kk, lane, ec[0], ec[1]);
            fence_regs<NA / 2>(dC);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) fence_regs<4>(fa[kk]);
            wgmma_fence();
            const uint64_t h_mn = desc_sw128(Hs + (n0 / 64) * pbox, pbox, 1024);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs<NA>(dC, fa[kk], desc_at(h_mn, (4 * ph + kk) * 2048));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<NA / 2>(dC);
        }
#pragma unroll 1
        for (int ph = 0; ph < TP; ++ph) {
            const float w[2] = {ex2(total - cs[0]) * ds[0], ex2(total - cs[1]) * ds[1]};
            uint32_t xa[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                scaled_a(xa[kk], Xs, qbox, r0 + 16 * wi, 4 * ph + kk, lane, w[0], w[1]);
            fence_regs<NA / 2>(dB);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) fence_regs<4>(xa[kk]);
            wgmma_fence();
            const uint64_t dh_mn = desc_sw128(DHs + (n0 / 64) * pbox, pbox, 1024);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs<NA>(dB, xa[kk], desc_at(dh_mn, (4 * ph + kk) * 2048));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<NA / 2>(dB);
        }

        // -- Z^T = x dy^T, 32 columns at a time: scaled, its sums with C B^T
        // off the diagonal, into its tile as bf16 (zeros left of the
        // diagonal) ---------------------------------------------------------
        float rsum[2] = {0.f, 0.f};
#pragma unroll 1
        for (int jh = 0; jh < 2 * T; ++jh) { // 32-column pieces of Z^T
            const int j = jh / 2;
            float z[16];
            wgmma_fence();
            wgmma_ss_tiles<PW, 32>(z, per_step(desc_sw128(Xs + r0 * 128, 0, 1024)), qbox,
                                   desc_sw128(DYs + jh * 32 * 128, 0, 1024), qbox);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<16>(z);
            const uint32_t* cb = CBs + cb_block(rt, max(j, rt), T) * 16 * 128 + ct;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int jb = 4 * (jh % 2) + q;     // 8-column block of tile j
                const int t = 64 * j + 8 * jb + 2 * qc;
                float csum[2] = {0.f, 0.f};
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int srow = half ? row_b : row_a;
                    float z0 = 0.f, z1 = 0.f;
                    if (j >= rt) {
                        const float2 m = unpack_bf16(cb[(2 * jb + half) * 128]);
                        const float2 ct2 = *reinterpret_cast<const float2*>(cw + t);
                        z0 = t >= srow ? z[4 * q + 2 * half] * ex2(ct2.x - cs[half]) * ds[half] : 0.f;
                        z1 = t + 1 >= srow ? z[4 * q + 2 * half + 1] * ex2(ct2.y - cs[half]) * ds[half]
                                           : 0.f;
                        const float p0 = t > srow ? z0 * m.x : 0.f;
                        const float p1 = t + 1 > srow ? z1 * m.y : 0.f;
                        rsum[half] += p0 + p1;
                        csum[0] += p0;
                        csum[1] += p1;
                    }
                    *reinterpret_cast<uint32_t*>(Zs + sw_off(srow, t, qbox)) = pack_bf16(z0, z1);
                }
                // the warp's 16 rows: lanes of one column pair
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                    csum[0] += __shfl_xor_sync(0xffffffffu, csum[0], o);
                    csum[1] += __shfl_xor_sync(0xffffffffu, csum[1], o);
                }
                if (gr == 0) {
                    cols[warp * Q64 + t] = csum[0];
                    cols[warp * Q64 + t + 1] = csum[1];
                }
                compiler_barrier();
            }
        }
        rsum[0] = quad_sum(rsum[0]);
        rsum[1] = quad_sum(rsum[1]);
        if (qc == 0) {
            rows[row_a] = -rsum[0];
            rows[row_b] = -rsum[1];
        }

        fence_proxy_async();
        named_barrier_sync(1, nthr);         // Z^T in place; x and dy spent
        if (tid == 0 && vec && i + 1 < heads.y) load_xy<TP>(smem, lay, xy_full, &tx, &tdy, h + 1, c, b);
        {
            // dB += Z^T C and dC += Z B over the chunk (Z the MN-major view
            // of Z^T's columns tile rt); the masked entries are zeros.
            fence_regs<NA / 2>(dB);
            fence_regs<NA / 2>(dC);
            wgmma_fence();
            const uint64_t c_mn = per_step(desc_sw128(opaque(Cs) + (n0 / 64) * qbox, qbox, 1024));
            const uint64_t z_mn = desc_sw128(Zs + rt * qbox, qbox, 1024);
            const uint64_t b_mn = per_step(desc_sw128(opaque(Bs) + (n0 / 64) * qbox, qbox, 1024));
            for (int kk = 0; kk < 4 * T; ++kk) {
                wgmma_ss<NA, 0, 1>(dB, desc_sw128(Zs + (kk / 4) * qbox + r0 * 128 + (kk % 4) * 32, 0, 1024),
                                   desc_at(c_mn, kk * 2048), 1);
                wgmma_ss<NA, 1, 1>(dC, desc_at(z_mn, kk * 2048), desc_at(b_mn, kk * 2048), 1);
            }
            wgmma_commit();
        }
        // While the products run: dcum_q (the warps' column sums, minus the
        // row sums, plus the h_c term) by warpgroup 0, one row a thread ...
        if (wg == 0 && ct < Q64) {
            float d = 0.f;
            for (int w = 0; w < 4 * T; ++w) d += cols[w * Q64 + ct];
            rows[ct] = d + rows[ct] + rows[3 * Q64 + ct];
        }
        if (wg == 0) named_barrier_sync(2, 128);
        if (warp == 0) {
            // ... then da_s = sum_{t>=s} dcum_t + exp(total) <dh, h_c> +
            // sum_{t<s} F_t; ddt and this chunk's part of dA (lane l: rows
            // l K .. l K + K - 1)
            float hd = 0.f;
            for (int w = 0; w < nthr / 32; ++w) hd += red[w];
            const float e0 = ex2(total) * hd;
            const int K = Q64 / 32;
            float rv[PER], fv[PER];
            float rs = 0.f, fs = 0.f;
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int q = lane * K + k;
                rv[k] = k < K ? rows[q] : 0.f;
                fv[k] = k < K ? rows[Q64 + q] : 0.f;
                rs += rv[k];
                fs += fv[k];
            }
            float suf = rs, pre = fs;        // inclusive suffix / prefix over lanes
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float vs = __shfl_down_sync(0xffffffffu, suf, o);
                const float vp = __shfl_up_sync(0xffffffffu, pre, o);
                if (lane + o < 32) suf += vs;
                if (lane >= o) pre += vp;
            }
            float run_r = suf - rs, run_f = pre - fs, part = 0.f;
            float da[PER];
#pragma unroll
            for (int k = PER - 1; k >= 0; --k) {
                run_r += rv[k];
                da[k] = run_r;
            }
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int q = lane * K + k;
                if (k < K && q < a.Q) {
                    const float d = da[k] + e0 + run_f;
                    a.ddt[(row0 + q) * a.H + h] = rows[2 * Q64 + q] + Ah * d;
                    part += dts[q] * d;
                }
                run_f += fv[k];
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
            if (lane == 0) a.pdA[((long long)b * a.H + h) * a.nc + c] = part;
        }
        wgmma_wait<0>();
        fence_regs<NA / 2>(dB);
        fence_regs<NA / 2>(dC);
        named_barrier_sync(1, nthr);         // Z^T read, the rows scanned: the stage is free
        if (tid == 0 && i + STAGES < heads.y)
            load_head<TN>(st, lay, full + s, &th, &tdh, &tdc, (b * a.H + h + STAGES) * a.nc + c);
    }

    // One fp32 partial of dB and dC per head slice.
    const long long nsl = (long long)a.G * a.n_sl, slot = (long long)g * a.n_sl + sl;
#pragma unroll
    for (int j = 0; j < NA / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int t = half ? row_b : row_a, n = n0 + 8 * j + 2 * qc;
            if (t >= a.Q) continue;
            const long long at = ((row0 + t) * nsl + slot) * a.N + n;
            if (n < a.N) {
                a.pdB[at] = dB[4 * j + 2 * half];
                a.pdC[at] = dC[4 * j + 2 * half];
            }
            if (n + 1 < a.N) {
                a.pdB[at + 1] = dB[4 * j + 2 * half + 1];
                a.pdC[at + 1] = dC[4 * j + 2 * half + 1];
            }
        }
}

// ------------------------------------------------------------- reductions
// blockIdx.y 0: dB, 1: dC (each group's slices in order, to bf16); 2: dA
// (batch, then chunks).
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce_kernel(Args a) {
    const long long stride = (long long)gridDim.x * THREADS;
    if (blockIdx.y < 2) {
        const float* part = blockIdx.y ? a.pdC : a.pdB;
        bf16* out = blockIdx.y ? a.dC : a.dB;
        const long long n_out = (long long)a.B * a.S * a.G * a.N;
        for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n_out; i += stride) {
            const int n = (int)(i % a.N);
            const long long rest = i / a.N;
            const int gg = (int)(rest % a.G);
            const long long row = rest / a.G;
            const float* p = part + (row * a.G * a.n_sl + (long long)gg * a.n_sl) * a.N + n;
            float sum = 0.f;
            for (int j = 0; j < a.n_sl; ++j) sum += p[(long long)j * a.N];
            out[i] = __float2bfloat16(sum);
        }
    } else {
        for (long long hh = (long long)blockIdx.x * THREADS + threadIdx.x; hh < a.H; hh += stride) {
            float sum = 0.f;
            for (int bb = 0; bb < a.B; ++bb)
                for (int cc = 0; cc < a.nc; ++cc) sum += a.pdA[((long long)bb * a.H + hh) * a.nc + cc];
            a.dA[hh] = sum;
        }
    }
}

bool takes(int Q, int P, int N) {
    return Q > 0 && P > 0 && N > 0 && Q <= MAX_Q && P <= MAX_P && N <= MAX_N &&
           (round64(P) == 64 || round64(N) == 64 || round64(Q) == 64) &&
           WalkLayout(Q, P, N).bytes <= MAX_SMEM && ChunkLayout(Q, P, N).bytes <= MAX_SMEM;
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &found);
#endif
        return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// Map over a contiguous tensor of RANK dims (innermost first) in boxes
// `box`; boxes past the edge read as zeros.
template <int RANK>
cudaError_t make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem,
                     const cuuint64_t (&dims)[RANK], const cuuint32_t (&box)[RANK],
                     CUtensorMapSwizzle swizzle) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    cuuint64_t strides[RANK - 1];
    cuuint64_t run = elem;
    for (int i = 0; i < RANK - 1; ++i) strides[i] = run *= dims[i];
    cuuint32_t elem_strides[RANK];
    for (int i = 0; i < RANK; ++i) elem_strides[i] = 1;
    const CUresult r = encode(map, type, RANK, const_cast<void*>(ptr), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int TP, int TN>
cudaError_t launch_chunks(const Args& a, int Q, int P, int N, cudaStream_t s) {
    const ChunkLayout lay(Q, P, N);
    const cuuint32_t Q64 = lay.Q64;
    CUtensorMap tx{}, tdy{}, tb{}, tc{}, th{}, tdh{}, tdc{};
    cudaError_t err = cudaSuccess;
    const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
    if (a.vec) {
        // [B, S, H, P] as (P, H, Q, nc, B): a chunk's rows past Q are zeros
        const cuuint64_t xd[5] = {(cuuint64_t)a.P, (cuuint64_t)a.H, (cuuint64_t)a.Q,
                                  (cuuint64_t)a.nc, (cuuint64_t)a.B};
        const cuuint64_t bd[5] = {(cuuint64_t)a.N, (cuuint64_t)a.G, (cuuint64_t)a.Q,
                                  (cuuint64_t)a.nc, (cuuint64_t)a.B};
        const cuuint32_t box[5] = {64, 1, Q64, 1, 1};
        err = make_map<5>(&tx, a.x, bf, 2, xd, box, sw);
        if (err == cudaSuccess) err = make_map<5>(&tdy, a.dy, bf, 2, xd, box, sw);
        if (err == cudaSuccess) err = make_map<5>(&tb, a.Bm, bf, 2, bd, box, sw);
        if (err == cudaSuccess) err = make_map<5>(&tc, a.Cm, bf, 2, bd, box, sw);
    }
    const cuuint64_t slots = (cuuint64_t)a.B * a.H * a.nc;
    const cuuint64_t hd[3] = {(cuuint64_t)round16(N), (cuuint64_t)lay.P64, slots};
    const cuuint32_t hbox[3] = {64, (cuuint32_t)lay.P64, 1};
    if (err == cudaSuccess) err = make_map<3>(&th, a.states, bf, 2, hd, hbox, sw);
    if (err == cudaSuccess) err = make_map<3>(&tdh, a.dstates, bf, 2, hd, hbox, sw);
    const cuuint64_t dd[3] = {Q64, 2, slots};
    const cuuint32_t dbox[3] = {Q64, 2, 1};
    if (err == cudaSuccess)
        err = make_map<3>(&tdc, a.dtc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dd, dbox,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
    auto kern = ssd_bwd_chunk_kernel<TP, TN>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return err;
    kern<<<dim3(a.G * a.n_sl, a.nc, a.B), THREADS, lay.bytes, s>>>(tx, tdy, tb, tc, th, tdh, tdc, a);
    return cudaGetLastError();
}

}  // namespace

// kernel 0: the walks; 1: the chunks.
extern "C" long ssd_scan_bwd_smem_bytes(int Q, int P, int N, int kernel) {
    return kernel == 0 ? (long)WalkLayout(Q, P, N).bytes : (long)ChunkLayout(Q, P, N).bytes;
}

// The backward at the kernels' chunk Q (at most 128), R heads a CTA.  The
// scratch: states and dstates bf16 [B, H, nc, P64, round16(N)] (zeros in
// rows past round16(P)), dtc fp32 [B, H, nc, 2, Q64], pdB and pdC fp32
// [B, S, G x ceil(H / G / R), N], pdA fp32 [B, H, nc].
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* dy, const void* dhT, const void* h0,
                            void* states, void* dstates, void* dtc, void* pdB, void* pdC,
                            void* pdA, void* dx, void* ddt, void* dA, void* dB, void* dC,
                            void* dh0, int B, int S, int H, int P, int G, int N, int Q, int R,
                            int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (Q <= 0 || S % Q || G <= 0 || H % G || R <= 0 || !takes(Q, P, N))
        return (int)cudaErrorInvalidValue;
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const int rep = H / G;
    Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
           static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
           static_cast<const float*>(dt), static_cast<const float*>(A),
           static_cast<const float*>(dhT), static_cast<const float*>(h0),
           static_cast<bf16*>(states), static_cast<bf16*>(dstates), static_cast<float*>(dtc),
           static_cast<float*>(pdB), static_cast<float*>(pdC), static_cast<float*>(pdA),
           static_cast<bf16*>(dx), static_cast<float*>(ddt), static_cast<float*>(dA),
           static_cast<bf16*>(dB), static_cast<bf16*>(dC), static_cast<float*>(dh0),
           B, S, H, P, G, N, Q, S / Q, R, (rep + R - 1) / R,
           P % 8 == 0 && N % 8 == 0 && aligned(x) && aligned(dy) && aligned(Bm) && aligned(Cm),
           Q % 16 == 0 && P % 16 == 0 && N % 16 == 0};
    if (!aligned(states) || !aligned(dstates) || !aligned(dtc)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);

    const int walk_bytes = WalkLayout(Q, P, N).bytes;
    err = cudaFuncSetAttribute(ssd_bwd_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               walk_bytes);
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_walk_kernel<<<dim3(H, B, 2), THREADS, walk_bytes, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const bool wide_p = round64(P) > 64, wide_n = round64(N) > 64;
    err = wide_p ? (wide_n ? launch_chunks<2, 2>(a, Q, P, N, s) : launch_chunks<2, 1>(a, Q, P, N, s))
                 : (wide_n ? launch_chunks<1, 2>(a, Q, P, N, s) : launch_chunks<1, 1>(a, Q, P, N, s));
    if (err != cudaSuccess) return (int)err;

    const long long n_out = (long long)B * S * G * N;
    const int blocks = (int)std::min<long long>((n_out + THREADS - 1) / THREADS, 132 * 16);
    ssd_bwd_reduce_kernel<<<dim3(blocks > 0 ? blocks : 1, 3), THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
