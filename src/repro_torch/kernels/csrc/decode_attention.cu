// Decode attention for Hopper (sm_90a): one query token per sequence
// against a padded KV cache, bf16 in and out.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention_pallas, body _kernel): keys at positions >= length[b]
// are masked, the softmax runs online in fp32, and a row with length 0
// comes out 0 (the Pallas kernel's 1e-30 floor on l).
//
// What bounds it on the card: bytes.  Each key is read once and used for
// the G query heads of its KV group, ~2*G FLOP per byte, far below the
// H100's ~295 FLOP/byte balance point, so the floor is the K/V bytes up to
// length[b] over 3.35 TB/s.  What the design does about it:
//   * split-K: the TPU kernel walks one sequence's cache in order on one
//     core; here B*KV (16 at the serving shapes) CTAs could not fill 132
//     SMs, so pass 1 gives every 64-key split of every (b, kv head) its own
//     CTA, which writes a partial (m, l, acc) to scratch the wrapper
//     allocates, and pass 2 combines the partials per query head;
//   * the G query heads of a KV head share each K/V tile load;
//   * splits at or past length[b] exit before touching memory, so a cache
//     padded to max_seq costs only what is filled;
//   * length stays on the device: both passes read it there, the host
//     never waits for it.
// This is the simple version: no TMA, no asynchronous copies.
//
// Layout: q [B, H, D], k_cache [B, S, KV, D], v_cache [B, S, KV, Dv],
// length int32 [B], out [B, H, Dv], all contiguous; scratch part_m,
// part_l [B, KV, n_split, G] and part_acc [B, KV, n_split, G, Dv] fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 64;                  // keys per split (one CTA each)
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;       // the Pallas kernel's mask value

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ int clamp_len(const int* length, int b, int S) {
    return max(0, min(length[b], S));
}

// Pass 1: grid (n_split, KV, B).  One CTA scores one 64-key split of one
// (b, kv head) for the G query heads that share it.
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc, const int* __restrict__ length,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int S, int H, int KV, int D,
                    int Dv, int n_split, float scale) {
    const int split = blockIdx.x;
    const int hk = blockIdx.y;
    const int b = blockIdx.z;
    const int G = H / KV;
    const int len = clamp_len(length, b, S);
    const int j0 = split * BK;
    if (j0 >= len) return;               // pass 2 never reads this split
    const int nk = min(BK, len - j0);

    extern __shared__ __align__(16) unsigned char smem[];
    float* qs = reinterpret_cast<float*>(smem);          // [G][D], scaled
    float* sc = qs + G * D;                              // [G][BK]
    float* ml = sc + G * BK;                             // m [G], l [G]
    bf16* ks = reinterpret_cast<bf16*>(ml + 2 * G);      // [BK][D + 2]
    bf16* vs = ks + BK * (D + 2);                        // [BK][Dv]
    const int LDK = D + 2;   // odd word stride: row-parallel reads hit distinct banks

    const bf16* qb = q + ((long long)b * H + (long long)hk * G) * D;
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
        qs[i] = __bfloat162float(qb[i]) * scale;
    }
    const bf16* kb = kc + ((long long)b * S + j0) * KV * D + (long long)hk * D;
    const bf16* vb = vc + ((long long)b * S + j0) * KV * Dv + (long long)hk * Dv;
    for (int i = threadIdx.x; i < nk * (D / 2); i += THREADS) {
        const int r = i / (D / 2);
        const int c = (i % (D / 2)) * 2;
        *reinterpret_cast<__nv_bfloat162*>(ks + r * LDK + c) =
            *reinterpret_cast<const __nv_bfloat162*>(kb + (long long)r * KV * D + c);
    }
    for (int i = threadIdx.x; i < nk * (Dv / 2); i += THREADS) {
        const int r = i / (Dv / 2);
        const int c = (i % (Dv / 2)) * 2;
        *reinterpret_cast<__nv_bfloat162*>(vs + r * Dv + c) =
            *reinterpret_cast<const __nv_bfloat162*>(vb + (long long)r * KV * Dv + c);
    }
    __syncthreads();

    // Scores s[g][j] = (scale q_g) . k_j for the valid keys of the split.
    for (int i = threadIdx.x; i < G * BK; i += THREADS) {
        const int g = i / BK;
        const int jj = i % BK;
        float s = NEG_INF;
        if (jj < nk) {
            const float* qg = qs + g * D;
            const __nv_bfloat162* kr =
                reinterpret_cast<const __nv_bfloat162*>(ks + jj * LDK);
            float acc = 0.f;
            for (int d = 0; d < D / 2; ++d) {
                const float2 kv = __bfloat1622float2(kr[d]);
                acc = fmaf(qg[2 * d], kv.x, acc);
                acc = fmaf(qg[2 * d + 1], kv.y, acc);
            }
            s = acc;
        }
        sc[i] = s;
    }
    __syncthreads();

    // Softmax statistics of the split, one warp per query head.
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int g = warp; g < G; g += THREADS / 32) {
        float mx = NEG_INF;
        for (int jj = lane; jj < nk; jj += 32) mx = fmaxf(mx, sc[g * BK + jj]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int jj = lane; jj < BK; jj += 32) {
            const float p = jj < nk ? __expf(sc[g * BK + jj] - mx) : 0.f;
            sc[g * BK + jj] = p;
            sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
            ml[g] = mx;
            ml[G + g] = sum;
        }
    }
    __syncthreads();

    // Unnormalised partial output acc[g][dv] = sum_j p[g][j] v[j][dv].
    const long long part = (((long long)b * KV + hk) * n_split + split) * G;
    for (int i = threadIdx.x; i < G * Dv; i += THREADS) {
        const int g = i / Dv;
        const int dv = i % Dv;
        const float* pg = sc + g * BK;
        float acc = 0.f;
        for (int jj = 0; jj < nk; ++jj) {
            acc = fmaf(pg[jj], __bfloat162float(vs[jj * Dv + dv]), acc);
        }
        part_acc[(part + g) * Dv + dv] = acc;
    }
    if (threadIdx.x < G) {
        part_m[part + threadIdx.x] = ml[threadIdx.x];
        part_l[part + threadIdx.x] = ml[G + threadIdx.x];
    }
}

// Pass 2: grid (H, B).  Rescale each valid split's partial to the global
// max and normalise: out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M).
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      const int* __restrict__ length, bf16* __restrict__ out,
                      int S, int H, int KV, int Dv, int n_split) {
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int G = H / KV;
    const int hk = h / G;
    const int g = h % G;
    const int n_valid = (clamp_len(length, b, S) + BK - 1) / BK;
    const long long base = ((long long)b * KV + hk) * n_split;

    extern __shared__ float w[];          // [n_split] rescale weights
    float M = NEG_INF;
    for (int s = 0; s < n_valid; ++s) M = fmaxf(M, part_m[(base + s) * G + g]);
    for (int s = threadIdx.x; s < n_valid; s += blockDim.x) {
        w[s] = __expf(part_m[(base + s) * G + g] - M);
    }
    __syncthreads();
    float L = 0.f;
    for (int s = 0; s < n_valid; ++s) L += part_l[(base + s) * G + g] * w[s];
    const float denom = fmaxf(L, 1e-30f);
    for (int dv = threadIdx.x; dv < Dv; dv += blockDim.x) {
        float acc = 0.f;
        for (int s = 0; s < n_valid; ++s) {
            acc = fmaf(part_acc[((base + s) * G + g) * Dv + dv], w[s], acc);
        }
        out[((long long)b * H + h) * Dv + dv] = __float2bfloat16(acc / denom);
    }
}

cudaError_t set_smem(const void* kern, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

}  // namespace

extern "C" int decode_attention_splits(int S) { return (S + BK - 1) / BK; }

extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, const void* length,
                                    void* part_m, void* part_l, void* part_acc,
                                    void* out, int B, int S, int H, int KV,
                                    int D, int Dv, float scale, int device,
                                    void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (D % 2 || Dv % 2 || H % KV) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int G = H / KV;
    const int n_split = (S + BK - 1) / BK;

    const size_t bytes1 = sizeof(float) * (G * D + G * BK + 2 * G) +
                          sizeof(bf16) * (BK * (D + 2) + BK * Dv);
    err = set_smem(reinterpret_cast<const void*>(decode_split_kernel), bytes1);
    if (err != cudaSuccess) return (int)err;
    decode_split_kernel<<<dim3(n_split, KV, B), THREADS, bytes1, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k_cache),
        static_cast<const bf16*>(v_cache), static_cast<const int*>(length),
        static_cast<float*>(part_m), static_cast<float*>(part_l),
        static_cast<float*>(part_acc), S, H, KV, D, Dv, n_split, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const size_t bytes2 = sizeof(float) * n_split;
    err = set_smem(reinterpret_cast<const void*>(decode_combine_kernel), bytes2);
    if (err != cudaSuccess) return (int)err;
    decode_combine_kernel<<<dim3(H, B), THREADS, bytes2, st>>>(
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<const float*>(part_acc), static_cast<const int*>(length),
        static_cast<bf16*>(out), S, H, KV, Dv, n_split);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
