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
// rounding noise, amplified by A, in ddt and dA.)  dB and dC of a group
// sum its heads'; dA sums batch and chunks.
//
// What bounds it on the card: at mamba2-2.7b's training shape (B 4, S 1024,
// 80 heads of P 64, N 128, G 1, chunk 128) the inputs and gradients are
// ~130 MB (x, dy, dx 41.9 MB each), ~39 us at 3.35 TB/s; the design's
// products (two walks, three Q x Q triangles and three state products a
// chunk) are ~54 GFLOP, ~55 us at the bf16 tensor-core rate.  So the
// products must be on the tensor cores.  The design's fp32 scratch adds
// ~1.1 GB of traffic (states, state gradients, per-head dB/dC partials):
// this first kernel is simple, not fast.
//
// What the design does: three CUDA kernels, one stream, no atomics (two
// launches give the same bits):
//   * ssd_bwd_walk_kernel, grid (H, B, 2): z = 0 walks the chunks forward
//     and writes the state entering each chunk (and the final one) to fp32
//     scratch [B, H, nc + 1, Pp, Np]; z = 1 walks them in reverse from dhT
//     and writes dh, the gradient of the state leaving each chunk, to
//     [B, H, nc, Pp, Np] and dh_0 to d(initial_state).  Both carry their
//     [P, N] state in registers, tiled as the forward tiles its state
//     (Tiling), and add each chunk's (U o w)^T V on mma.sync m16n8k16 with
//     U o w rounded to bf16: x o exp(total - cum) dt and B for the states
//     (the forward's arithmetic), dy o exp(cum) and C for dh;
//   * ssd_bwd_chunk_kernel, grid (nc, H, B): every chunk at once, from the
//     scratch.  Warp w takes row tiles w and 15 - w (16 rows each) and for
//     them forms u (then dx and x . u), dB's and dC's per-head rows, the
//     dots above, and the direct part of ddt; every product on mma.sync with
//     fp32 accumulators.  As in the forward, each 16 x 16 block of the
//     triangle (C B^T, x dy^T, dy x^T) is formed in registers, scaled by
//     exp2 of the masked exponent (exp() only where the mask keeps the
//     entry: a positive difference would give inf, and inf * 0 is NaN) and
//     fed, packed to bf16, as the A fragment of the next product; nothing of
//     size Q x Q goes to shared memory.  Warp 0 then forms da by a reverse
//     scan, ddt, and the chunk's part of dA.  dB and dC go out per head
//     (fp32 [B, S, H, N]) and dA per chunk (fp32 [B, H, nc]);
//   * ssd_bwd_reduce_kernel sums the heads of each group (dB, dC, in head
//     order, to bf16) and dA over batch and chunks, in a fixed order.
//
// Layout: x, dy, dx [B, S, H, P] bf16; dt, ddt [B, S, H] fp32; A, dA [H]
// fp32; Bm, Cm, dB, dC [B, S, G, N] bf16; h0, dhT, dh0 [B, H, P, N] fp32
// (optional); all contiguous.  256 threads a CTA.  Ragged Q, P and N are
// padded to multiples of 16 with zeros in shared memory and in the scratch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 256;              // 16 row tiles: two per warp
constexpr int MAX_P = 128;              // u accumulator: 16 n8 tiles of P
constexpr int MAX_N = 128;              // dB / dC accumulators: 16 n8 tiles
constexpr int MAX_ST = 16;              // walk state n8 tiles per warp
constexpr int PAD = 8;                  // bf16 row padding: conflict-free ldmatrix
constexpr int PER = MAX_Q / 32;         // cumsum rows per lane
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t MAX_SMEM = 232448;     // an H100 CTA's dynamic shared memory

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

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

// Chunk kernel's shared memory: x and dy [Qp][Pp+8], B and C [Qp][Np+8],
// the entering state and dh [Pp][Np+8] (bf16); dt, cum (log2 units), the
// rows' dots (dcum), x . u (g) and F (f) [Qp] (fp32); one fp32 per warp.
// repro_torch/kernels/ssd_scan_bwd.py: smem_bytes mirrors `bytes`.
struct ChunkLayout {
    int Qp, Pp, Np, ldx, ldb;
    int x, dy, bm, cm, hs, dhs, dt, cum, dcum, g, f, red, bytes;
    __host__ __device__ constexpr ChunkLayout(int Q, int P, int N)
        : Qp(round16(Q)), Pp(round16(P)), Np(round16(N)), ldx(Pp + PAD),
          ldb(Np + PAD), x(0), dy(2 * Qp * ldx), bm(dy + 2 * Qp * ldx),
          cm(bm + 2 * Qp * ldb), hs(cm + 2 * Qp * ldb), dhs(hs + 2 * Pp * ldb),
          dt(dhs + 2 * Pp * ldb), cum(dt + 4 * Qp), dcum(cum + 4 * Qp),
          g(dcum + 4 * Qp), f(g + 4 * Qp), red(f + 4 * Qp),
          bytes(red + 4 * WARPS) {}
};

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
    float* states;                      // [B, H, nc + 1, Pp, Np]
    float* dstates;                     // [B, H, nc, Pp, Np]
    float* pdB;                         // [B, S, H, N]
    float* pdC;                         // [B, S, H, N]
    float* pdA;                         // [B, H, nc]
    bf16* dx;
    float* ddt;
    float* dA;
    bf16* dB;
    bf16* dC;
    float* dh0;                         // optional
    int B, S, H, P, G, N, Q, nc;
    int vec;                            // rows are whole 16-byte pieces
    int exact;                          // Q, P and N are multiples of 16
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

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
                 :: "r"(hopper::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src))
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
            hopper::cp_async16(dst + r * ld + c, src + r * stride + c);
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
// cum[q] and returns the chunk's total.
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

// The dots of a 16-row accumulator tile's rows (gr and gr + 8 of this lane)
// with the bf16 rows of `M` (row stride ld) starting at row r0, over the
// first `cols` / 8 n8 tiles; every lane of a quad gets its rows' sums.
template <int T>
__device__ __forceinline__ void row_dots(const float (&acc)[T][4], const bf16* M, int ld,
                                         int r0, int cols, float (&out)[2]) {
    const int gr = threadIdx.x % 32 / 4, qc = threadIdx.x % 4;
    out[0] = out[1] = 0.f;
#pragma unroll
    for (int j = 0; j < T; ++j) {
        if (j >= cols / 8) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const float2 m = unpack_bf16(*reinterpret_cast<const uint32_t*>(
                M + (r0 + gr + half * 8) * ld + j * 8 + 2 * qc));
            out[half] += m.x * acc[j][2 * half] + m.y * acc[j][2 * half + 1];
        }
    }
    out[0] = quad_sum(out[0]);
    out[1] = quad_sum(out[1]);
}

// acc[row, :] += z[row] * M[row, :] for this lane's two rows.
template <int T>
__device__ __forceinline__ void add_rows(float (&acc)[T][4], const bf16* M, int ld, int r0,
                                         int cols, const float (&z)[2]) {
    const int gr = threadIdx.x % 32 / 4, qc = threadIdx.x % 4;
#pragma unroll
    for (int j = 0; j < T; ++j) {
        if (j >= cols / 8) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const float2 m = unpack_bf16(*reinterpret_cast<const uint32_t*>(
                M + (r0 + gr + half * 8) * ld + j * 8 + 2 * qc));
            acc[j][2 * half] += z[half] * m.x;
            acc[j][2 * half + 1] += z[half] * m.y;
        }
    }
}

// acc[16 x (8 T)] = A[rows r0.., k < K] * Bop over k16 slices, A from
// row-major shared rows (ldmatrix), Bop from shared [k][n] rows (ldmatrix
// .trans), both bf16; the first `cols` / 8 n8 tiles.  Adds to acc.
template <int T>
__device__ __forceinline__ void mma_rows_kn(float (&acc)[T][4], const bf16* Am, int lda, int r0,
                                            const bf16* Bkn, int ldb, int K, int cols) {
    const int lane = threadIdx.x % 32;
    const bf16* arow = Am + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) * lda + (lane / 16) * 8;
    for (int kk = 0; kk < K / 16; ++kk) {
        uint32_t af[4];
        hopper::ldmatrix_x4(af, arow + kk * 16);
#pragma unroll
        for (int j2 = 0; j2 < T / 2; ++j2) {
            if (j2 >= cols / 16) break;
            uint32_t bf[4];
            hopper::ldmatrix_x4_trans(bf, Bkn + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ldb
                                              + j2 * 16 + (lane / 16) * 8);
            hopper::mma_16816(acc[2 * j2], af, bf[0], bf[1]);
            hopper::mma_16816(acc[2 * j2 + 1], af, bf[2], bf[3]);
        }
    }
}

// cb = A[rows r0..r0+15, k < K] * Bm[rows n0..n0+15, k < K]^T, both from
// row-major shared rows (ldmatrix), in two chains (even and odd k16
// slices): the 16 x 16 block is cb[nt] + cb[2 + nt] for its n8 tile nt.
__device__ __forceinline__ void block_product(float (&cb)[4][4], const bf16* Am, const bf16* Bm,
                                              int ld, int r0, int n0, int K) {
    const int lane = threadIdx.x % 32;
    const bf16* arow = Am + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) * ld + (lane / 16) * 8;
    const bf16* brow = Bm + (n0 + (lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[i][e] = 0.f;
    for (int kk = 0; kk < K / 16; kk += 2) {
        uint32_t af[4], bf[4];
        hopper::ldmatrix_x4(af, arow + kk * 16);
        hopper::ldmatrix_x4(bf, brow + kk * 16);
        hopper::mma_16816(cb[0], af, bf[0], bf[1]);
        hopper::mma_16816(cb[1], af, bf[2], bf[3]);
        if (kk + 1 < K / 16) {
            uint32_t af1[4], bf1[4];
            hopper::ldmatrix_x4(af1, arow + (kk + 1) * 16);
            hopper::ldmatrix_x4(bf1, brow + (kk + 1) * 16);
            hopper::mma_16816(cb[2], af1, bf1[0], bf1[1]);
            hopper::mma_16816(cb[3], af1, bf1[2], bf1[3]);
        }
    }
}

// Scale a 16 x 16 block (rows r0.. of this lane's rows, columns n0..) in
// place: entry (r, n) becomes v * exp2(cum[hi] - cum[lo]) * d where
// (hi, lo) = (n, r) if `cols_later` (the block's columns are the later
// steps) else (r, n), d = dt[r] if `row_dt` else dt[n]; zero unless the
// later step is past the earlier one (strictly if `strict`).  Returns the
// block packed as an A fragment (k = the columns).
__device__ __forceinline__ void scale_pack(float (&cb)[4][4], uint32_t (&la)[4], const float* cw,
                                           const float* dts, int r0, int n0, bool cols_later,
                                           bool row_dt, bool use_dt, bool strict) {
    const int gr = threadIdx.x % 32 / 4, qc = threadIdx.x % 4;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = r0 + gr + (e / 2) * 8, n = n0 + nt * 8 + 2 * qc + e % 2;
            const int later = cols_later ? n : r, earlier = cols_later ? r : n;
            const bool keep = strict ? later > earlier : later >= earlier;
            const float v = cb[nt][e] + cb[2 + nt][e];
            const float d = use_dt ? dts[row_dt ? r : n] : 1.f;
            cb[nt][e] = keep ? v * exp2f(cw[later] - cw[earlier]) * d : 0.f;
        }
    }
    la[0] = pack_bf16(cb[0][0], cb[0][1]);
    la[1] = pack_bf16(cb[0][2], cb[0][3]);
    la[2] = pack_bf16(cb[1][0], cb[1][1]);
    la[3] = pack_bf16(cb[1][2], cb[1][3]);
}

// acc += la (16 x 16, k = rows k0.. of Bkn) * Bkn[k0.., :] for the first
// `cols` / 8 n8 tiles; Bkn shared [k][n] rows (ldmatrix .trans).
template <int T>
__device__ __forceinline__ void mma_frag_kn(float (&acc)[T][4], const uint32_t (&la)[4],
                                            const bf16* Bkn, int ldb, int k0, int cols) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j2 = 0; j2 < T / 2; ++j2) {
        if (j2 >= cols / 16) break;
        uint32_t bf[4];
        hopper::ldmatrix_x4_trans(bf, Bkn + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * ldb
                                          + j2 * 16 + (lane / 16) * 8);
        hopper::mma_16816(acc[2 * j2], la, bf[0], bf[1]);
        hopper::mma_16816(acc[2 * j2 + 1], la, bf[2], bf[3]);
    }
}

template <int T>
__device__ __forceinline__ void zero(float (&acc)[T][4]) {
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// ------------------------------------------------------------------- walks
// z = 0: the state entering each chunk, forward from h0; z = 1: dh, the
// gradient of the state leaving each chunk, in reverse from dhT.
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_walk_kernel(Args a) {
    const int h = blockIdx.x, b = blockIdx.y, dir = blockIdx.z;
    const int g = h / (a.H / a.G);
    const int P = a.P, N = a.N, Q = a.Q, nc = a.nc;
    const WalkLayout lay(Q, P, N);
    const int Qp = lay.Qp, Pp = lay.Pp, Np = lay.Np, LDU = lay.ldu, LDV = lay.ldv;
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
    // The padded scratch: [Pp][Np] per chunk, every tile written.
    float* out = dir ? a.dstates : a.states;
    const int nout = dir ? nc : nc + 1;
    const long long obase = ((long long)b * a.H + h) * nout * Pp * Np;
    auto store = [&](int slot) {
        float* o = out + obase + (long long)slot * Pp * Np;
#pragma unroll
        for (int j = 0; j < MAX_ST; ++j) {
            if (j >= tiles) break;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int p = sm * 16 + gr + half * 8, n = (sn0 + j) * 8 + 2 * qc;
                *reinterpret_cast<float2*>(o + p * Np + n) =
                    make_float2(st[j][2 * half], st[j][2 * half + 1]);
            }
        }
    };

    for (int k = 0; k < nc; ++k) {
        const int c = dir ? nc - 1 - k : k;
        hopper::cp_async_wait_all();
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
                hopper::ldmatrix_x4_trans(af, Us + (k0 + (lane % 8) + (lane / 16) * 8) * LDU
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
                    hopper::ldmatrix_x4_trans(bf, Vs + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * LDV
                                                      + (sn0 + 2 * j2) * 8 + (lane / 16) * 8);
                    hopper::mma_16816(st[2 * j2], af, bf[0], bf[1]);
                    hopper::mma_16816(st[2 * j2 + 1], af, bf[2], bf[3]);
                }
            }
        }
    }

    if (dir == 0) {
        store(nc);
    } else if (a.dh0) {
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
// The tile of rows warp w takes in round i (0 or 1): w, then 15 - w.
// repro_torch/kernels/ssd_scan_bwd.py: chunk_row_tiles mirrors it.
__device__ __forceinline__ int row_tile(int warp, int i) { return i == 0 ? warp : 15 - warp; }

// MP: P padded to 16 is at most this, the size of u's accumulator (a
// 64-wide one for mamba2's P 64 runs ~4% faster than a 128-wide one with
// its upper half unused).
template <int MP>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_chunk_kernel(Args a) {
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int g = h / (a.H / a.G);
    const int P = a.P, N = a.N, Q = a.Q, nc = a.nc;
    const ChunkLayout lay(Q, P, N);
    const int Qp = lay.Qp, Pp = lay.Pp, Np = lay.Np, LDX = lay.ldx, LDB = lay.ldb;
    constexpr int PT = MP / 8, NT = MAX_N / 8;     // accumulator n8 tiles
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int gr = lane / 4, qc = lane % 4;
    const float Ah = a.A[h];

    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Xs = reinterpret_cast<bf16*>(smem + lay.x);
    bf16* DYs = reinterpret_cast<bf16*>(smem + lay.dy);
    bf16* Bs = reinterpret_cast<bf16*>(smem + lay.bm);
    bf16* Cs = reinterpret_cast<bf16*>(smem + lay.cm);
    bf16* Hs = reinterpret_cast<bf16*>(smem + lay.hs);
    bf16* DHs = reinterpret_cast<bf16*>(smem + lay.dhs);
    float* dts = reinterpret_cast<float*>(smem + lay.dt);
    float* cw = reinterpret_cast<float*>(smem + lay.cum);
    float* dcum = reinterpret_cast<float*>(smem + lay.dcum);
    float* gd = reinterpret_cast<float*>(smem + lay.g);
    float* fd = reinterpret_cast<float*>(smem + lay.f);
    float* red = reinterpret_cast<float*>(smem + lay.red);

    if (!a.exact) {
        for (int i = tid; i < lay.bytes / 16; i += THREADS)
            reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
        __syncthreads();
    }
    const long long row0 = (long long)b * a.S + (long long)c * Q;
    copy_rows(Xs, LDX, a.x + (row0 * a.H + h) * P, (long long)a.H * P, Q, P, a.vec);
    copy_rows(DYs, LDX, a.dy + (row0 * a.H + h) * P, (long long)a.H * P, Q, P, a.vec);
    copy_rows(Bs, LDB, a.Bm + (row0 * a.G + g) * N, (long long)a.G * N, Q, N, a.vec);
    copy_rows(Cs, LDB, a.Cm + (row0 * a.G + g) * N, (long long)a.G * N, Q, N, a.vec);
    copy_dt(dts, a.dt + row0 * a.H + h, a.H, Q);

    // The entering state and dh to bf16, and <dh, h_c> in fp32.
    {
        const long long bh = (long long)b * a.H + h;
        const float* Hg = a.states + (bh * (nc + 1) + c) * Pp * Np;
        const float* DHg = a.dstates + (bh * nc + c) * Pp * Np;
        float hdot = 0.f;
        for (int i = tid * 4; i < Pp * Np; i += THREADS * 4) {
            const float4 hv = *reinterpret_cast<const float4*>(Hg + i);
            const float4 dv = *reinterpret_cast<const float4*>(DHg + i);
            hdot += hv.x * dv.x + hv.y * dv.y + hv.z * dv.z + hv.w * dv.w;
            const int p = i / Np, n = i % Np;
            *reinterpret_cast<uint2*>(Hs + p * LDB + n) =
                make_uint2(pack_bf16(hv.x, hv.y), pack_bf16(hv.z, hv.w));
            *reinterpret_cast<uint2*>(DHs + p * LDB + n) =
                make_uint2(pack_bf16(dv.x, dv.y), pack_bf16(dv.z, dv.w));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) hdot += __shfl_xor_sync(0xffffffffu, hdot, o);
        if (lane == 0) red[warp] = hdot;
    }
    hopper::cp_async_wait_all();
    __syncthreads();
    if (warp == 0) {
        float cum[PER];
        chunk_cumsum(dts, Ah * LOG2E, Qp, cw, cum);
    }
    __syncthreads();
    const float total = cw[Qp - 1];      // padded rows have dt = 0

    for (int i = 0; i < 2; ++i) {
        const int r = row_tile(warp, i);
        if (r >= Qp / 16) continue;
        const int r0 = r * 16;
        const float cr[2] = {cw[r0 + gr], cw[r0 + gr + 8]};
        const float dr[2] = {dts[r0 + gr], dts[r0 + gr + 8]};
        float dots[2];

        // -- u = exp(total - cum_s) (B_s dh^T) + L^T dy, rows s ----------
        {
            float acc[PT][4];
            zero(acc);
            const bf16* brow = Bs + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) * LDB + (lane / 16) * 8;
            for (int kk = 0; kk < Np / 16; ++kk) {
                uint32_t af[4];
                hopper::ldmatrix_x4(af, brow + kk * 16);
#pragma unroll
                for (int j2 = 0; j2 < PT / 2; ++j2) {
                    if (j2 >= Pp / 16) break;
                    uint32_t bf[4];
                    hopper::ldmatrix_x4(bf, DHs + (j2 * 16 + (lane % 8) + (lane / 16) * 8) * LDB
                                                + kk * 16 + ((lane / 8) % 2) * 8);
                    hopper::mma_16816(acc[2 * j2], af, bf[0], bf[1]);
                    hopper::mma_16816(acc[2 * j2 + 1], af, bf[2], bf[3]);
                }
            }
            const float es[2] = {exp2f(total - cr[0]), exp2f(total - cr[1])};
#pragma unroll
            for (int j = 0; j < PT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] *= es[e / 2];
            // F_s: the dh part of x_s . u_s, times dt_s, on its own.
            row_dots(acc, Xs, LDX, r0, Pp, dots);
            if (qc == 0) {
                fd[r0 + gr] = dr[0] * dots[0];
                fd[r0 + gr + 8] = dr[1] * dots[1];
            }
            for (int tb = r; tb < Qp / 16; ++tb) {
                float cb[4][4];
                uint32_t la[4];
                block_product(cb, Bs, Cs, LDB, r0, tb * 16, Np);            // B_s . C_t
                scale_pack(cb, la, cw, dts, r0, tb * 16, true, false, false, false);
                mma_frag_kn(acc, la, DYs, LDX, tb * 16, Pp);
            }
            row_dots(acc, Xs, LDX, r0, Pp, dots);
            if (qc == 0) {
                gd[r0 + gr] = dots[0];
                gd[r0 + gr + 8] = dots[1];
            }
            const long long drow = (row0 + r0) * a.H + h;
#pragma unroll
            for (int j = 0; j < PT; ++j) {
                if (j >= Pp / 8) break;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int t = gr + half * 8, p = j * 8 + 2 * qc;
                    if (r0 + t >= Q || p >= P) continue;
                    bf16* dst = a.dx + (drow + (long long)t * a.H) * P + p;
                    const float v0 = dr[half] * acc[j][2 * half], v1 = dr[half] * acc[j][2 * half + 1];
                    if (p + 1 < P && (P % 2) == 0) {
                        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
                    } else {
                        dst[0] = __float2bfloat16(v0);
                        if (p + 1 < P) dst[1] = __float2bfloat16(v1);
                    }
                }
            }
        }

        // Z's diagonal, dt_s (dy_s . x_s), for this lane's rows.
        float zdiag[2] = {0.f, 0.f};
        for (int j = 0; j < Pp / 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = r0 + gr + half * 8, p = j * 8 + 2 * qc;
                const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(Xs + row * LDX + p));
                const float2 yv = unpack_bf16(*reinterpret_cast<const uint32_t*>(DYs + row * LDX + p));
                zdiag[half] += xv.x * yv.x + xv.y * yv.y;
            }
        zdiag[0] = dr[0] * quad_sum(zdiag[0]);
        zdiag[1] = dr[1] * quad_sum(zdiag[1]);

        // -- dB_s = sum_{t>s} Z[t,s] C_t + Z[s,s] C_s + w_s x_s dh ---------
        {
            float acc[NT][4];
            zero(acc);
            for (int tb = r; tb < Qp / 16; ++tb) {
                float cb[4][4];
                uint32_t la[4];
                block_product(cb, Xs, DYs, LDX, r0, tb * 16, Pp);           // x_s . dy_t
                scale_pack(cb, la, cw, dts, r0, tb * 16, true, true, true, true);
                mma_frag_kn(acc, la, Cs, LDB, tb * 16, Np);
            }
            row_dots(acc, Bs, LDB, r0, Np, dots);
            if (qc == 0) {
                dcum[r0 + gr] = -dots[0];
                dcum[r0 + gr + 8] = -dots[1];
            }
            add_rows(acc, Cs, LDB, r0, Np, zdiag);
            // + (x_s w_s) dh, x o w rounded to bf16 as in the states' walk
            const float ws[2] = {exp2f(total - cr[0]) * dr[0], exp2f(total - cr[1]) * dr[1]};
            const bf16* xrow = Xs + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) * LDX + (lane / 16) * 8;
            for (int kk = 0; kk < Pp / 16; ++kk) {
                uint32_t af[4];
                hopper::ldmatrix_x4(af, xrow + kk * 16);
                af[0] = scale_bf16x2(af[0], make_float2(ws[0], ws[0]));
                af[1] = scale_bf16x2(af[1], make_float2(ws[1], ws[1]));
                af[2] = scale_bf16x2(af[2], make_float2(ws[0], ws[0]));
                af[3] = scale_bf16x2(af[3], make_float2(ws[1], ws[1]));
#pragma unroll
                for (int j2 = 0; j2 < NT / 2; ++j2) {
                    if (j2 >= Np / 16) break;
                    uint32_t bf[4];
                    hopper::ldmatrix_x4_trans(bf, DHs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDB
                                                      + j2 * 16 + (lane / 16) * 8);
                    hopper::mma_16816(acc[2 * j2], af, bf[0], bf[1]);
                    hopper::mma_16816(acc[2 * j2 + 1], af, bf[2], bf[3]);
                }
            }
            const long long prow = (row0 + r0) * a.H + h;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (j >= Np / 8) break;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int t = gr + half * 8, n = j * 8 + 2 * qc;
                    if (r0 + t >= Q) continue;
                    float* dst = a.pdB + (prow + (long long)t * a.H) * N + n;
                    if (n < N) dst[0] = acc[j][2 * half];
                    if (n + 1 < N) dst[1] = acc[j][2 * half + 1];
                }
            }
        }

        // -- dC_t = exp(cum_t) dy_t h_c + sum_{s<t} Z[t,s] B_s + Z[t,t] B_t -
        {
            float acc[NT][4];
            zero(acc);
            mma_rows_kn(acc, DYs, LDX, r0, Hs, LDB, Pp, Np);
            const float et[2] = {exp2f(cr[0]), exp2f(cr[1])};
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] *= et[e / 2];
            for (int sb = 0; sb <= r; ++sb) {
                float cb[4][4];
                uint32_t la[4];
                block_product(cb, DYs, Xs, LDX, r0, sb * 16, Pp);           // dy_t . x_s
                scale_pack(cb, la, cw, dts, r0, sb * 16, false, false, true, true);
                mma_frag_kn(acc, la, Bs, LDB, sb * 16, Np);
            }
            row_dots(acc, Cs, LDB, r0, Np, dots);
            if (qc == 0) {           // the same thread wrote -B . dB' above
                dcum[r0 + gr] += dots[0];
                dcum[r0 + gr + 8] += dots[1];
            }
            add_rows(acc, Bs, LDB, r0, Np, zdiag);
            const long long prow = (row0 + r0) * a.H + h;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (j >= Np / 8) break;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int t = gr + half * 8, n = j * 8 + 2 * qc;
                    if (r0 + t >= Q) continue;
                    float* dst = a.pdC + (prow + (long long)t * a.H) * N + n;
                    if (n < N) dst[0] = acc[j][2 * half];
                    if (n + 1 < N) dst[1] = acc[j][2 * half + 1];
                }
            }
        }
    }
    __syncthreads();

    // -- da_s = sum_{t>=s} dcum_t + exp(total) <dh, h_c> + sum_{t<s} F_t;
    // ddt and this chunk's part of dA (warp 0, lane l: rows l K .. l K + K - 1)
    if (warp == 0) {
        float hd = 0.f;
        for (int w = 0; w < WARPS; ++w) hd += red[w];
        const float e0 = exp2f(total) * hd;
        const int K = (Qp + 31) / 32;
        float rv[PER], fv[PER];
        float rs = 0.f, fs = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int q = lane * K + i;
            const bool in = i < K && q < Qp;
            rv[i] = in ? dcum[q] : 0.f;
            fv[i] = in ? fd[q] : 0.f;
            rs += rv[i];
            fs += fv[i];
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
        for (int i = PER - 1; i >= 0; --i) {
            run_r += rv[i];
            da[i] = run_r;
        }
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int q = lane * K + i;
            if (i < K && q < Q) {
                const float d = da[i] + e0 + run_f;
                a.ddt[(row0 + q) * a.H + h] = gd[q] + Ah * d;
                part += dts[q] * d;
            }
            run_f += fv[i];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) a.pdA[((long long)b * a.H + h) * nc + c] = part;
    }
}

// ------------------------------------------------------------- reductions
// blockIdx.y 0: dB, 1: dC (each group's heads in order, to bf16); 2: dA
// (batch, then chunks).
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce_kernel(Args a) {
    const int rep = a.H / a.G;
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
            const float* p = part + (row * a.H + (long long)gg * rep) * a.N + n;
            float sum = 0.f;
            for (int j = 0; j < rep; ++j) sum += p[(long long)j * a.N];
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
    return Q > 0 && P > 0 && N > 0 && round16(Q) <= MAX_Q && round16(P) <= MAX_P &&
           round16(N) <= MAX_N && (size_t)WalkLayout(Q, P, N).bytes <= MAX_SMEM &&
           (size_t)ChunkLayout(Q, P, N).bytes <= MAX_SMEM;
}

}  // namespace

// kernel 0: the walks; 1: the chunks.
extern "C" long ssd_scan_bwd_smem_bytes(int Q, int P, int N, int kernel) {
    return kernel == 0 ? (long)WalkLayout(Q, P, N).bytes : (long)ChunkLayout(Q, P, N).bytes;
}

extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* dy, const void* dhT, const void* h0,
                            void* states, void* dstates, void* pdB, void* pdC, void* pdA,
                            void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0,
                            int B, int S, int H, int P, int G, int N, int Q, int device,
                            void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (Q <= 0 || S % Q || G <= 0 || H % G || !takes(Q, P, N)) return (int)cudaErrorInvalidValue;
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
           static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
           static_cast<const float*>(dt), static_cast<const float*>(A),
           static_cast<const float*>(dhT), static_cast<const float*>(h0),
           static_cast<float*>(states), static_cast<float*>(dstates),
           static_cast<float*>(pdB), static_cast<float*>(pdC), static_cast<float*>(pdA),
           static_cast<bf16*>(dx), static_cast<float*>(ddt), static_cast<float*>(dA),
           static_cast<bf16*>(dB), static_cast<bf16*>(dC), static_cast<float*>(dh0),
           B, S, H, P, G, N, Q, S / Q,
           P % 8 == 0 && N % 8 == 0 && aligned(x) && aligned(dy) && aligned(Bm) && aligned(Cm),
           Q % 16 == 0 && P % 16 == 0 && N % 16 == 0};
    if (!aligned(states) || !aligned(dstates)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);

    const int walk_bytes = WalkLayout(Q, P, N).bytes;
    err = cudaFuncSetAttribute(ssd_bwd_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               walk_bytes);
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_walk_kernel<<<dim3(H, B, 2), THREADS, walk_bytes, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int chunk_bytes = ChunkLayout(Q, P, N).bytes;
    const auto chunks = round16(P) <= 64 ? ssd_bwd_chunk_kernel<64> : ssd_bwd_chunk_kernel<MAX_P>;
    err = cudaFuncSetAttribute(chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
    if (err != cudaSuccess) return (int)err;
    chunks<<<dim3(a.nc, H, B), THREADS, chunk_bytes, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const long long n_out = (long long)B * S * G * N;
    const int blocks = (int)std::min<long long>((n_out + THREADS - 1) / THREADS, 132 * 16);
    ssd_bwd_reduce_kernel<<<dim3(blocks > 0 ? blocks : 1, 3), THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
