// jax.random's threefry streams for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package draws its seeded weights and
// batches with jax.random, which it leaves to XLA (threefry2x32 in the
// partitionable mode, then uniform, then XLA's float32 erf_inv for a
// normal); this kernel does the same work in one launch a leaf: from
// (key, counter range, scale) through threefry, the uniform or the normal
// and the scale, to a store in the leaf's dtype.  The plain version is
// repro_torch/prng.py (kernels/threefry.py::threefry_plain): every
// operation here is one of its operations, written so that nvcc can
// neither contract nor reorder it (__fmaf_rn where XLA contracts a product
// and a sum, __fmul_rn / __fadd_rn / __fdiv_rn elsewhere, log1pf and the
// IEEE sqrtf), so bits and uniforms are bitwise the plain version's and a
// normal differs only where log1pf or a double rounding in the plain
// version's FMA does.
//
// What bounds it on the card: integer operations.  An element costs ~75
// 32-bit integer operations (20 rounds of add, rotate and xor, 5 key
// injections, the counter and the mantissa) and ~25 float operations for
// a normal, against 4 bytes stored (2 in bf16): at the H100's INT32 rate
// (64 a clock on each of 132 SMs) that is ~4.5 ps an element, 1.2 ps of
// stores at 3.35 TB/s.
//
// What the design does about it: nothing is loaded (the key and the
// counter range are arguments), the rotations are funnel shifts (one
// instruction each), the key schedule is hoisted out of the element loop,
// and a grid-stride loop of 256-thread blocks, 8 a SM, keeps every SM's
// integer pipes busy with independent elements; neighbouring threads
// store neighbouring elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

enum Dist { kBits = 0, kUniform = 1, kNormal = 2 };

struct Args {
    uint32_t k0, k1;
    unsigned long long offset, n;
    int dist;
    float lo, span, scale;
    int divide, bf16_math, out_bf16;
    void* out;
};

// Threefry-2x32, 20 rounds (jax._src.prng._threefry2x32_lowering).
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1, uint32_t k2,
                                          uint32_t x0, uint32_t x1) {
#define ROUND(r)                             \
    x0 += x1;                                \
    x1 = __funnelshift_l(x1, x1, r);         \
    x1 ^= x0;
    x0 += k0;
    x1 += k1;
    ROUND(13) ROUND(15) ROUND(26) ROUND(6)
    x0 += k1; x1 += k2 + 1u;
    ROUND(17) ROUND(29) ROUND(16) ROUND(24)
    x0 += k2; x1 += k0 + 2u;
    ROUND(13) ROUND(15) ROUND(26) ROUND(6)
    x0 += k0; x1 += k1 + 3u;
    ROUND(17) ROUND(29) ROUND(16) ROUND(24)
    x0 += k1; x1 += k2 + 4u;
    ROUND(13) ROUND(15) ROUND(26) ROUND(6)
    x0 += k2; x1 += k0 + 5u;
#undef ROUND
    return make_uint2(x0, x1);
}

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// XLA's float32 erf_inv (chlo.erf_inv): Giles' polynomial, Horner steps
// contracted into FMAs.
__device__ __forceinline__ float erfinv_xla(float x) {
    const float w = -log1pf(-__fmul_rn(x, x));
    const bool small = w < 5.0f;
    const float t = small ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
    float p = small ? 2.81022636e-08f : -0.000200214257f;
    p = __fmaf_rn(p, t, small ? 3.43273939e-07f : 0.000100950558f);
    p = __fmaf_rn(p, t, small ? -3.5233877e-06f : 0.00134934322f);
    p = __fmaf_rn(p, t, small ? -4.39150654e-06f : -0.00367342844f);
    p = __fmaf_rn(p, t, small ? 0.00021858087f : 0.00573950773f);
    p = __fmaf_rn(p, t, small ? -0.00125372503f : -0.0076224613f);
    p = __fmaf_rn(p, t, small ? -0.00417768164f : 0.00943887047f);
    p = __fmaf_rn(p, t, small ? 0.246640727f : 1.00167406f);
    p = __fmaf_rn(p, t, small ? 1.50140941f : 2.83297682f);
    return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7f800000)) : __fmul_rn(p, x);
}

__global__ void __launch_bounds__(kThreads) threefry_kernel(const Args a) {
    const uint32_t k2 = a.k0 ^ a.k1 ^ 0x1BD11BDAu;
    const float sqrt2 = a.bf16_math ? 1.4140625f : 1.41421354f;
    const unsigned long long stride = (unsigned long long)gridDim.x * kThreads;
    for (unsigned long long i = (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
         i < a.n; i += stride) {
        const unsigned long long c = a.offset + i;
        const uint2 o = threefry(a.k0, a.k1, k2, (uint32_t)(c >> 32), (uint32_t)c);
        const uint32_t raw = o.x ^ o.y;
        if (a.dist == kBits) {
            static_cast<uint32_t*>(a.out)[i] = raw;
            continue;
        }
        // [0, 1): 23 of 32 bits (fp32) or 7 of 8 bits (bf16) as the mantissa
        // of a number in [1, 2), minus 1.
        const float f = a.bf16_math
            ? __fsub_rn(__uint_as_float((((raw & 0xFFu) >> 1) | 0x3F80u) << 16), 1.0f)
            : __fsub_rn(__uint_as_float((raw >> 9) | 0x3F800000u), 1.0f);
        float v = fmaxf(a.lo, __fmaf_rn(f, a.span, a.lo));
        if (a.bf16_math) v = round_bf16(v);
        if (a.dist == kNormal) {
            if (a.bf16_math) {
                v = round_bf16(__fmul_rn(round_bf16(erfinv_xla(v)), sqrt2));
            } else {
                v = __fmul_rn(sqrt2, erfinv_xla(v));
            }
        }
        v = a.divide ? __fdiv_rn(v, a.scale) : __fmul_rn(v, a.scale);
        if (a.bf16_math) v = round_bf16(v);
        if (a.out_bf16) {
            static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(v);
        } else {
            static_cast<float*>(a.out)[i] = v;
        }
    }
}

}  // namespace

// Draw elements [offset, offset + n) of a stream into out (n contiguous
// elements: uint32 bits, or float32 / bf16 values).  Returns a cudaError_t.
extern "C" int threefry_draw(unsigned int k0, unsigned int k1, long long offset,
                             long long n, int dist, float lo, float span, float scale,
                             int divide, int bf16_math, int out_bf16, void* out,
                             int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n < 0 || offset < 0 || dist < kBits || dist > kNormal) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long want = (n + kThreads - 1) / kThreads;
    const long long cap = (long long)sms * kBlocksPerSM;
    const unsigned int blocks = (unsigned int)(want < cap ? want : cap);
    Args a{k0, k1, (unsigned long long)offset, (unsigned long long)n, dist, lo, span, scale,
           divide, bf16_math, out_bf16, out};
    threefry_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
