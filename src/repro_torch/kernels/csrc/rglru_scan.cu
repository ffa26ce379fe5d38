// RG-LRU gated linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py (rglru_pallas,
// body _kernel):
//   log a_t = c * log_a * r_t,  a_t = exp(log a_t)
//   h_t = a_t h_{t-1} + sqrt(max(1 - exp(2 log a_t), 0)) * (i_t x_t)
// per channel, with an fp32 state.  h comes out in x's dtype (bf16), the
// final state in fp32.  Unlike the Pallas kernel (which starts from zeros
// and leaves a resumed scan to XLA), the thread loads an optional initial
// state.
//
// What bounds it on the card: bytes.  At the serving path's prefill shape
// (B 4, S 1024, 2560 channels; x bf16, both gates fp32, as the model feeds
// them) it moves ~126 MB -- x and h 21 MB each, the gates 42 MB each --
// ~38 us at 3.35 TB/s, against ~10 operations per element.
//
// What the design does about it, simply: one thread per (batch, channel),
// neighbouring threads on neighbouring channels, so every load and store of
// a time step is coalesced; a loop over all S steps keeps h in a register
// (chunking the time axis, as the Pallas kernel does to bound its VMEM
// tiles, would not change the result).  The loads of later steps do not
// depend on h, so the unrolled loop keeps several in flight.
//
// Known limit: at the serving shape B * C / 128 = 80 CTAs of 128 threads
// leave 52 of 132 SMs idle, and each thread's S-step chain is latency-
// bound.  Splitting the time axis (a scan of the affine maps h -> a h + b
// across segments) is later work.
//
// Layout: x [B, S, C] bf16, gate_a and gate_i [B, S, C] fp32, log_a [C]
// fp32, h0 (optional) and state [B, C] fp32, h [B, S, C] bf16, all
// contiguous.  Grid (ceil(C / 128), B), 128 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ gate_a,
                  const float* __restrict__ gate_i,
                  const float* __restrict__ log_a, const float* __restrict__ h0,
                  bf16* __restrict__ h_out, float* __restrict__ state_out,
                  int S, int C, float c_const) {
    const int ch = blockIdx.x * THREADS + threadIdx.x;
    const int b = blockIdx.y;
    if (ch >= C) return;
    const float la = c_const * log_a[ch];
    float h = h0 ? h0[(long long)b * C + ch] : 0.f;
    long long idx = (long long)b * S * C + ch;
#pragma unroll 8
    for (int t = 0; t < S; ++t, idx += C) {
        const float log_at = la * gate_a[idx];
        const float at = expf(log_at);
        const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_at), 0.f));
        h = at * h + beta * (gate_i[idx] * __bfloat162float(x[idx]));
        h_out[idx] = __float2bfloat16(h);
    }
    state_out[(long long)b * C + ch] = h;
}

}  // namespace

extern "C" int rglru_scan_fwd(const void* x, const void* gate_a,
                              const void* gate_i, const void* log_a,
                              const void* h0, void* h, void* state, int B,
                              int S, int C, float c_const, int device,
                              void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B <= 0 || C <= 0 || S < 0) return (int)cudaErrorInvalidValue;
    rglru_scan_kernel<<<dim3((C + THREADS - 1) / THREADS, B), THREADS, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(gate_a),
        static_cast<const float*>(gate_i), static_cast<const float*>(log_a),
        static_cast<const float*>(h0), static_cast<bf16*>(h),
        static_cast<float*>(state), S, C, c_const);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
