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
// 3.35 TB/s, and the four products above are ~26.8 GFLOP, ~27 us at the
// bf16 tensor-core rate: the two bounds are about equal.
//
// What the design does about it, simply: one CTA per (batch, head) -- 320
// at the serving shape, one per SM at a time -- walks the chunks in order
// (the loop takes the place of the Pallas kernel's sequential grid axis).
// The [P, N] state stays in shared memory across chunks, so it is read and
// written to device memory once; each chunk's x (fp32), B and C (bf16),
// dt, cum and the [Q, Q] matrix L are staged in shared memory (~196 KB at
// the serving shape; rows padded to odd word strides against bank
// conflicts).  The products run on the CUDA cores in fp32, each thread
// owning a 4 x 4 register tile of the output; blocks of L above the
// diagonal are neither computed nor read.  exp() is evaluated only where
// s <= t, i.e. the mask is applied inside the exponent (exp of a masked,
// positive difference would be inf, and inf * 0 is NaN).
//
// Left for later: tensor cores (wgmma) for the four products; with G = 1,
// all 80 heads of a batch row share C B^T, so it could be computed once
// per (batch, chunk) instead of once per head.
//
// Layout: x [B, S, H, P] bf16, dt [B, S, H] fp32, A [H] fp32, Bm and Cm
// [B, S, G, N] bf16, h0 (optional) and state [B, H, P, N] fp32, y
// [B, S, H, P] bf16, all contiguous.  Grid (H, B), 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;            // 16 x 16, a 4 x 4 output tile each
constexpr int TILE = 64;                // output rows / columns per pass

// Shared-memory layout (fp32 section first, then bf16), in elements.
struct Layout {
    int ldS, ldX, ldL, ldB;             // row strides
    size_t st, xs, L, cum, dts, w, bs, cs, bytes;
    __host__ __device__ Layout(int Q, int P, int N) {
        ldS = N + 1;                    // state [P][N+1] fp32
        ldX = P + 1;                    // x [Q][P+1] fp32
        ldL = Q + 1;                    // L [Q][Q+1] fp32
        ldB = N + 2;                    // B, C [Q][N+2] bf16 (odd word stride)
        st = 0;
        xs = st + (size_t)P * ldS;
        L = xs + (size_t)Q * ldX;
        cum = L + (size_t)Q * ldL;
        dts = cum + Q;
        w = dts + Q;
        const size_t f32_words = w + Q;
        bs = 0;                         // offsets in bf16 after the fp32 words
        cs = (size_t)Q * ldB;
        bytes = 4 * f32_words + 2 * (cs + (size_t)Q * ldB);
    }
};

// acc[i][j] += sum_{k0 <= k < k1} a(row_i, k) * b(k, col_j) with
// row_i = r0 + ty + 16 i and col_j = c0 + tx + 16 j.  Rows and columns past
// M and Nc are clamped to the last valid one (valid reads; the caller does
// not store them).
template <class FA, class FB>
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], int r0, int c0,
                                         int M, int Nc, int k0, int k1,
                                         FA a, FB b) {
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    int rows[4], cols[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        rows[i] = min(r0 + ty + 16 * i, M - 1);
        cols[i] = min(c0 + tx + 16 * i, Nc - 1);
    }
    for (int k = k0; k < k1; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a(rows[i], k);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b(k, cols[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, const float* __restrict__ h0,
                      bf16* __restrict__ y, float* __restrict__ state_out,
                      int S, int H, int P, int G, int N, int Q) {
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int g = h / (H / G);
    const Layout lay(Q, P, N);
    extern __shared__ __align__(16) unsigned char smem[];
    float* f32 = reinterpret_cast<float*>(smem);
    float* st = f32 + lay.st;
    float* xs = f32 + lay.xs;
    float* Ls = f32 + lay.L;
    float* cum = f32 + lay.cum;
    float* dts = f32 + lay.dts;
    float* ws = f32 + lay.w;
    bf16* Bs = reinterpret_cast<bf16*>(f32 + lay.w + Q) + lay.bs;
    bf16* Cs = reinterpret_cast<bf16*>(f32 + lay.w + Q) + lay.cs;
    const int ldS = lay.ldS, ldX = lay.ldX, ldL = lay.ldL, ldB = lay.ldB;
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const float a = A[h];

    const long long sbase = (long long)b * H * P * N + (long long)h * P * N;
    for (int i = threadIdx.x; i < P * N; i += THREADS) {
        st[(i / N) * ldS + i % N] = h0 ? h0[sbase + i] : 0.f;
    }

    for (int t0 = 0; t0 < S; t0 += Q) {
        const long long row0 = (long long)b * S + t0;   // (b, t0) in [B*S]
        // -- stage the chunk -------------------------------------------
        for (int i = threadIdx.x; i < Q * P; i += THREADS) {
            const int q = i / P;
            const int p = i % P;
            xs[q * ldX + p] = __bfloat162float(x[((row0 + q) * H + h) * P + p]);
        }
        for (int i = threadIdx.x; i < Q * N; i += THREADS) {
            const int q = i / N;
            const int n = i % N;
            const long long src = ((row0 + q) * G + g) * N + n;
            Bs[q * ldB + n] = Bm[src];
            Cs[q * ldB + n] = Cm[src];
        }
        for (int q = threadIdx.x; q < Q; q += THREADS) {
            dts[q] = dt[(row0 + q) * H + h];
        }
        __syncthreads();

        // -- cum = inclusive cumsum of dt * A, one warp ------------------
        if (warp == 0) {
            const int per = (Q + 31) / 32;
            const int beg = min(Q, lane * per);
            const int end = min(Q, beg + per);
            float run = 0.f;
            for (int q = beg; q < end; ++q) {
                run += dts[q] * a;
                cum[q] = run;
            }
            float incl = run;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float v = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += v;
            }
            const float excl = incl - run;
            for (int q = beg; q < end; ++q) cum[q] += excl;
        }
        __syncthreads();
        const float total = cum[Q - 1];
        for (int q = threadIdx.x; q < Q; q += THREADS) {
            ws[q] = expf(total - cum[q]) * dts[q];
        }

        // -- L = (C B^T) o exp(cum_t - cum_s) o dt_s, lower triangle ------
        for (int r0 = 0; r0 < Q; r0 += TILE) {
            for (int c0 = 0; c0 <= r0; c0 += TILE) {
                float acc[4][4];
                zero(acc);
                tile_mma(acc, r0, c0, Q, Q, 0, N,
                         [=](int t, int n) { return __bfloat162float(Cs[t * ldB + n]); },
                         [=](int n, int s) { return __bfloat162float(Bs[s * ldB + n]); });
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int t = r0 + ty + 16 * i;
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int s = c0 + tx + 16 * j;
                        if (t < Q && s < Q) {
                            Ls[t * ldL + s] = s <= t
                                ? acc[i][j] * expf(cum[t] - cum[s]) * dts[s]
                                : 0.f;
                        }
                    }
                }
            }
        }
        __syncthreads();

        // -- y = L x + exp(cum_t) (C state^T) ---------------------------
        for (int r0 = 0; r0 < Q; r0 += TILE) {
            for (int c0 = 0; c0 < P; c0 += TILE) {
                float intra[4][4], inter[4][4];
                zero(intra);
                zero(inter);
                tile_mma(intra, r0, c0, Q, P, 0, min(Q, r0 + TILE),
                         [=](int t, int s) { return Ls[t * ldL + s]; },
                         [=](int s, int p) { return xs[s * ldX + p]; });
                tile_mma(inter, r0, c0, Q, P, 0, N,
                         [=](int t, int n) { return __bfloat162float(Cs[t * ldB + n]); },
                         [=](int n, int p) { return st[p * ldS + n]; });
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int t = r0 + ty + 16 * i;
                    if (t >= Q) continue;
                    const float et = expf(cum[t]);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int p = c0 + tx + 16 * j;
                        if (p < P) {
                            y[((row0 + t) * H + h) * P + p] =
                                __float2bfloat16(intra[i][j] + et * inter[i][j]);
                        }
                    }
                }
            }
        }
        __syncthreads();                 // every read of the entering state is done

        // -- state = state * exp(total) + (x o w)^T B -------------------
        const float decay = expf(total);
        for (int r0 = 0; r0 < P; r0 += TILE) {
            for (int c0 = 0; c0 < N; c0 += TILE) {
                float acc[4][4];
                zero(acc);
                tile_mma(acc, r0, c0, P, N, 0, Q,
                         [=](int p, int s) { return xs[s * ldX + p] * ws[s]; },
                         [=](int s, int n) { return __bfloat162float(Bs[s * ldB + n]); });
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int p = r0 + ty + 16 * i;
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int n = c0 + tx + 16 * j;
                        if (p < P && n < N) {
                            st[p * ldS + n] = st[p * ldS + n] * decay + acc[i][j];
                        }
                    }
                }
            }
        }
        __syncthreads();                 // the next chunk overwrites the staging
    }

    for (int i = threadIdx.x; i < P * N; i += THREADS) {
        state_out[sbase + i] = st[(i / N) * ldS + i % N];
    }
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
    if (Q <= 0 || S % Q || G <= 0 || H % G || P <= 0 || N <= 0)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = Layout(Q, P, N).bytes;
    err = cudaFuncSetAttribute(ssd_chunk_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_scan_kernel<<<dim3(H, B), THREADS, bytes,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), static_cast<const float*>(h0),
        static_cast<bf16*>(y), static_cast<float*>(state), S, H, P, G, N, Q);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
