// RG-LRU scan backward for Hopper (sm_90a).
//
// Replaces the backward of src/repro/kernels/ops.py:339 (rglru): XLA's
// autodiff of the two-level scan under jax.checkpoint.  No Pallas kernel
// exists for it; the Pallas forward (repro/kernels/rglru_scan.py) has no
// VJP.  Per (batch, channel), with la = c log_a and the forward
//   L_t = la r_t,  a_t = exp(L_t),  e_t = exp(2 L_t),
//   beta_t = sqrt(max(1 - e_t, 0)),  h_t = a_t h_{t-1} + beta_t i_t x_t,
// given dh_t (bf16) and the final state's cotangent dh_fin (fp32, or 0):
//   g_T = dh_T + dh_fin,  g_t = dh_t + a_{t+1} g_{t+1}
//   dx_t = g_t beta_t i_t (bf16),  d gate_i_t = g_t beta_t x_t
//   dL_t = g_t (a_t h_{t-1} - (e_t / beta_t) i_t x_t),  d gate_a_t = la dL_t
//   d log_a = c sum_{b,t} r_t dL_t,  d h0 = a_1 g_1.
// Where 1 - e_t <= 0 (beta_t = 0) the derivative of beta_t is taken as 0:
// autodiff of sqrt gives inf or NaN there (kernels/rglru_scan_bwd.py).
//
// What bounds it on the card: bytes.  At recurrentgemma-2b's training
// shape (B 4, S 1024, 2560 channels) the least traffic reads x and dh
// (bf16) and both gates (fp32) and writes dx (bf16) and both gate
// gradients (fp32): 22 B an element, 230.7 MB, 0.069 ms at 3.35 TB/s,
// against ~25 operations an element.
//
// What the design does about it: two launches, no atomics.
// 1. The scan: one CTA per (batch, tile of 32 channels), 320 at the
//    training shape, the forward's geometry (csrc/rglru_scan.cu): lane l
//    takes channel l, warp w the steps [8 w, 8 w + 8) of each 64-step
//    chunk.  The CTA walks its chunks twice:
//    - forward, as the forward kernel does (each warp composes its
//      sub-segment's map h -> A h + B; the last warp applies the maps of
//      warps 0 .. 6 in that order and rescans its steps), storing the fp32
//      state entering each chunk into scratch [B, S / 64, C];
//    - backward, chunk by chunk from the last: each warp recomputes its
//      steps' a_t and beta_t i_t x_t, applies the maps of the warps before
//      it to the chunk's entering state and rescans to get h_{t-1} in
//      fp32 (the forward rounds h only on the way out, so the saved bf16 h
//      would not do), then composes the reverse map carry -> A' carry +
//      B' of its steps (carry = a_t g_t, the part of g_{t-1} that comes
//      from the right), applies the maps of the warps after it, in the
//      order 7, 6, .., to the carry entering the chunk from the right and
//      walks its steps in reverse, forming every gradient.  Warp 0's
//      carry leaves the chunk to the left.
//    The maps and carries are double buffered by chunk parity, so one
//    barrier a chunk orders their writes and reads.  Each thread sums
//    r_t dL_t over its steps; the warps' sums are added in order 0 .. 7
//    into a [B, C] fp32 partial.
//    Loads and stores are plain: a warp reads 64 (bf16) or 128 (fp32)
//    contiguous bytes a step, and one thread's eight steps are issued
//    back to back.  This reads x and both gates twice (335.5 MB at the
//    training shape, 0.100 ms).
// 2. d log_a: one thread a channel sums the partials over B in order.
// Repeatable: a fixed order and no atomics, so two launches on one input
// give bitwise equal outputs.  a and beta use the forward's formula (expf,
// no fast math), so the gradient is that of the function computed.  Under
// strong decay a_t may underflow to 0: the chain of g breaks there, as it
// does in exact arithmetic below fp32's range.  Steps past S and channels
// past C read as zeros: a = 1, beta = 0, dh = 0, an identity in both
// walks; nothing is stored for them.
//
// Layout: x, dh, dx [B, S, C] bf16; gate_a, gate_i, d gate_a, d gate_i
// [B, S, C] fp32; log_a, d log_a [C] fp32; h0, dh_fin, d h0 [B, C] fp32
// (optional); scratch [B, ceil(S / 64), C] and [B, C] fp32; all
// contiguous.  Grid (ceil(C / 32), B), 256 threads; then ceil(C / 256)
// blocks of 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// repro_torch/kernels/rglru_scan_bwd.py mirrors T, TILE and WARPS.
constexpr int TILE = 32;                // channels a CTA: one a lane
constexpr int WARPS = 8;                // sub-segments of a chunk: one a warp
constexpr int THREADS = WARPS * 32;
constexpr int T = 64;                   // steps a chunk
constexpr int SUB = T / WARPS;          // steps a sub-segment

struct Args {
    const bf16* x;
    const float* gate_a;
    const float* gate_i;
    const float* log_a;
    const float* h0;
    const bf16* dh;
    const float* dh_fin;
    bf16* dx;
    float* dga;
    float* dgi;
    float* dh0;
    float* entering;                    // [B, nc, C]
    float* partial;                     // [B, C]
    int S, C;
    float c;
};

// Two CTAs an SM (102 registers a thread): at three (80 registers) ptxas
// spilled 20 bytes, and beta_t i_t x_t kept in an array spilled 48.
__global__ void __launch_bounds__(THREADS, 2)
rglru_bwd_scan_kernel(Args a) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int c0 = blockIdx.x * TILE, b = blockIdx.y;
    const int ch = c0 + lane;
    const bool live = ch < a.C;
    const int S = a.S, C = a.C;
    const int nc = (S + T - 1) / T;
    // Channels past C take la = 0 and zero inputs: the identity.
    const float la = live ? a.c * a.log_a[ch] : 0.f;
    // This batch row's [S, C] planes start at base; within one, 32-bit
    // offsets (the wrapper refuses S C >= 2^31), which keeps the unrolled
    // steps' addresses out of 64-bit registers.
    const long long base = (long long)b * S * C;

    __shared__ float2 maps[2][WARPS][TILE];     // forward maps (A, B)
    __shared__ float2 rmaps[2][WARPS][TILE];    // reverse maps (A', B')
    __shared__ float carry_in[2][TILE];
    __shared__ float sums[WARPS][TILE];

    // ---- forward walk: the state entering each chunk, as the forward
    // kernel computes it (the last warp carries it in h_last).
    float h_last = live && a.h0 ? a.h0[(long long)b * C + ch] : 0.f;
    for (int c = 0; c < nc; ++c) {
        if (warp == WARPS - 1 && live)
            a.entering[((long long)b * nc + c) * C + ch] = h_last;
        const int t0 = c * T + warp * SUB;
        float av[SUB], bv[SUB];
        float A = 1.f, Bm = 0.f;
#pragma unroll
        for (int k = 0; k < SUB; ++k) {
            const bool in = live && t0 + k < S;
            const int off = (t0 + k) * C + ch;
            const float xv = in ? __bfloat162float(a.x[base + off]) : 0.f;
            const float ra = in ? a.gate_a[base + off] : 0.f;
            const float iv = in ? a.gate_i[base + off] : 0.f;
            const float log_at = la * ra;
            av[k] = expf(log_at);
            bv[k] = sqrtf(fmaxf(1.f - expf(2.f * log_at), 0.f)) * (iv * xv);
            A *= av[k];
            Bm = av[k] * Bm + bv[k];
        }
        maps[c % 2][warp][lane] = make_float2(A, Bm);
        __syncthreads();
        if (warp == WARPS - 1) {
            float h = h_last;
#pragma unroll
            for (int j = 0; j < WARPS - 1; ++j) {
                const float2 m = maps[c % 2][j][lane];
                h = m.x * h + m.y;
            }
#pragma unroll
            for (int k = 0; k < SUB; ++k) h = av[k] * h + bv[k];
            h_last = h;
        }
    }
    // The entering states are in scratch for every warp; the carry
    // entering the last chunk from the right is the final state's
    // cotangent.
    float carry = live && a.dh_fin ? a.dh_fin[(long long)b * C + ch] : 0.f;
    if (warp == 0 && nc > 0) carry_in[(nc - 1) % 2][lane] = carry;
    __syncthreads();

    // ---- backward walk, from the last chunk.
    float acc = 0.f;                            // sum of r_t dL_t
    for (int c = nc - 1; c >= 0; --c) {
        const int t0 = c * T + warp * SUB;
        float xv[SUB], ra[SUB], iv[SUB], gv[SUB], av[SUB];
        float A = 1.f, Bm = 0.f;
#pragma unroll
        for (int k = 0; k < SUB; ++k) {
            const bool in = live && t0 + k < S;
            const int off = (t0 + k) * C + ch;
            xv[k] = in ? __bfloat162float(a.x[base + off]) : 0.f;
            ra[k] = in ? a.gate_a[base + off] : 0.f;
            iv[k] = in ? a.gate_i[base + off] : 0.f;
            gv[k] = in ? __bfloat162float(a.dh[base + off]) : 0.f;
        }
        // beta_t i_t x_t is recomputed where it is needed (the same bits)
        // rather than kept in eight more registers.
#pragma unroll
        for (int k = 0; k < SUB; ++k) {
            const float log_at = la * ra[k];
            av[k] = expf(log_at);
            const float bv = sqrtf(fmaxf(1.f - expf(2.f * log_at), 0.f)) * (iv[k] * xv[k]);
            A *= av[k];
            Bm = av[k] * Bm + bv;
        }
        // Reverse map of the sub-segment: carry in from the right ->
        // carry out to the left, with g_t = dh_t + carry, carry = a_t g_t.
        float Ar = 1.f, Br = 0.f;
#pragma unroll
        for (int k = SUB - 1; k >= 0; --k) {
            Ar *= av[k];
            Br = av[k] * (gv[k] + Br);
        }
        maps[c % 2][warp][lane] = make_float2(A, Bm);
        rmaps[c % 2][warp][lane] = make_float2(Ar, Br);
        __syncthreads();

        // h entering this warp's steps, then h_{t-1} of each step.
        float h = a.entering && live ? a.entering[((long long)b * nc + c) * C + ch] : 0.f;
#pragma unroll
        for (int j = 0; j < WARPS - 1; ++j) {
            if (j < warp) {
                const float2 m = maps[c % 2][j][lane];
                h = m.x * h + m.y;
            }
        }
        float hp[SUB];
#pragma unroll
        for (int k = 0; k < SUB; ++k) {
            hp[k] = h;
            const float bv = sqrtf(fmaxf(1.f - expf(2.f * (la * ra[k])), 0.f)) * (iv[k] * xv[k]);
            h = av[k] * h + bv;
        }
        // The carry entering this warp's steps from the right.
        float cr = carry_in[c % 2][lane];
#pragma unroll
        for (int j = WARPS - 1; j > 0; --j) {
            if (j > warp) {
                const float2 m = rmaps[c % 2][j][lane];
                cr = m.x * cr + m.y;
            }
        }
#pragma unroll
        for (int k = SUB - 1; k >= 0; --k) {
            const float g = gv[k] + cr;
            const float log_at = la * ra[k];
            const float e2 = expf(2.f * log_at);
            const float u = 1.f - e2;
            const float beta = sqrtf(fmaxf(u, 0.f));
            const float dbeta = u > 0.f ? -e2 / beta : 0.f;
            const float dL = g * (av[k] * hp[k] + dbeta * (iv[k] * xv[k]));
            const int t = t0 + k;
            if (live && t < S) {
                const int off = t * C + ch;
                a.dx[base + off] = __float2bfloat16(g * beta * iv[k]);
                a.dgi[base + off] = g * beta * xv[k];
                a.dga[base + off] = la * dL;
                acc += ra[k] * dL;
            }
            cr = av[k] * g;
        }
        if (warp == 0) {
            if (c > 0) carry_in[(c - 1) % 2][lane] = cr;
            carry = cr;
        }
    }
    if (warp == 0 && live && a.dh0) a.dh0[(long long)b * C + ch] = carry;
    sums[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && live) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += sums[w][lane];
        a.partial[(long long)b * C + ch] = s;
    }
}

// d log_a[ch] = c * sum over b of partial[b, ch], b in order.
__global__ void __launch_bounds__(256)
rglru_bwd_reduce_kernel(const float* __restrict__ partial,
                        float* __restrict__ dla, int B, int C, float c) {
    const int ch = blockIdx.x * blockDim.x + threadIdx.x;
    if (ch >= C) return;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += partial[(long long)b * C + ch];
    dla[ch] = c * s;
}

}  // namespace

// Gradients of the RG-LRU scan.  B and C must be positive (the wrapper
// answers the empty cases); h0, dh_fin and dh0 may be null (no initial
// state, no final-state cotangent); entering is fp32 scratch [B,
// ceil(S / 64), C] (unused when S is 0), partial fp32 scratch [B, C].
extern "C" int rglru_scan_bwd(const void* x, const void* gate_a,
                              const void* gate_i, const void* log_a,
                              const void* h0, const void* dh,
                              const void* dh_fin, void* dx, void* dga,
                              void* dgi, void* dla, void* dh0, void* entering,
                              void* partial, int B, int S, int C,
                              float c_const, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B <= 0 || C <= 0 || S < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    Args a{static_cast<const bf16*>(x), static_cast<const float*>(gate_a),
           static_cast<const float*>(gate_i), static_cast<const float*>(log_a),
           static_cast<const float*>(h0), static_cast<const bf16*>(dh),
           static_cast<const float*>(dh_fin), static_cast<bf16*>(dx),
           static_cast<float*>(dga), static_cast<float*>(dgi),
           static_cast<float*>(dh0), static_cast<float*>(entering),
           static_cast<float*>(partial), S, C, c_const};
    rglru_bwd_scan_kernel<<<dim3((C + TILE - 1) / TILE, B), THREADS, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rglru_bwd_reduce_kernel<<<(C + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(dla), B, C,
        c_const);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
