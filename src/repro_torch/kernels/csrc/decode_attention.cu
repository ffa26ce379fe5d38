// Decode attention for Hopper (sm_90a): one query token per sequence
// against a padded KV cache, bf16 in and out, in one launch.
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
//   * split by length, on the device: the TPU kernel walks one sequence's
//     cache in order on one core; here CTA (split, kv head, b) takes keys
//     [split*c, min(len, (split+1)*c)) with c = ceil(len / n_split), so
//     the filled part of every row is shared evenly however the cache is
//     padded -- but c is at least the keys whose K/V bytes are 8x a
//     split's fp32 partial (16 G Dv / (D + Dv), within what shared memory
//     holds), so the combine reads few partials; splits past the length
//     only arrive.  The host picks n_split from the shapes alone
//     (kernels/decode_attention.py: plan) and never reads length;
//   * all of a CTA's K and V in flight at once: every thread issues 16-byte
//     asynchronous copies (cp.async) into padded shared-memory rows, and
//     they complete on one mbarrier for K and one for V, so scores start
//     while V lands.  (Bulk copies of single 256- or 512-byte key rows
//     are too small for the copy engine to reach the memory's rate.);
//   * products on the tensor cores: the G <= 16 query heads of the KV group
//     are the 16 rows of mma.sync m16n8k16 (padded with zero rows), K and V
//     come from shared memory by ldmatrix; each warp takes a quarter of the
//     CTA's keys, 16 at a time, with the online softmax on the score
//     fragments (exp2, scale folded in) and P fed back from registers;
//   * one launch: every CTA merges its warps, writes its partial (m, l,
//     acc), fences and counts itself on a per-(b, kv head) counter; the last
//     to arrive combines the partials in split order (bitwise repeatable
//     whichever CTA is last), writes out and resets the counter to 0.  A CTA
//     with no keys only arrives, and a row of length 0 comes out 0.
//     Where the caller asks for it (lse not null), the combining CTA also
//     writes each head's logsumexp from the (M, L) it already holds,
//     ln 2 (M + log2 L), or -inf for a row with no keys: the sharded
//     decode combines the slices of a sequence-sharded cache by it.  The
//     out it writes is the same either way.
//
// Head dims (D, Dv): (64, 64), (128, 128), (64, 128), (256, 256) and the
// reduced configs' (32, 32), whose rows take two k16 steps of QK^T and
// four n8 tiles of P V.
// Layout: q [B, H, D], k_cache [B, S, KV, D], v_cache [B, S, KV, Dv],
// length int32 [B], out [B, H, Dv], all contiguous and 16-byte aligned;
// part fp32 holds acc [B*KV, n_split, G, Dv] then (m, l) [B*KV, n_split,
// G, 2] (m in log2 units), written by the splits that hold keys; counter
// int32 [>= B*KV], zero between calls; lse fp32 [B, H] or null.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS = 16;                // mma rows: the query heads, G <= 16
constexpr int STEP = 16;                // keys per mma step
constexpr float NEG_INF = -1e30f;       // the Pallas kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;
// Dynamic shared memory a CTA may ask for: the card's 227 KB less 1 KB,
// which covers the static `last` flag.
constexpr size_t MAX_SMEM = 226 * 1024;

struct Args {
    const bf16* q;
    const bf16* kc;
    const bf16* vc;
    const int* length;
    float* part;
    int* counter;
    bf16* out;
    float* lse;
    int S, H, KV, n_split;
    float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
    return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(FULL, x, 1);
    return x + __shfl_xor_sync(FULL, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory rows, in bf16 (K, V, Q) and fp32 (the staged warp
// results): padded by 16 bytes so that the eight rows an ldmatrix reads
// fall in distinct banks, and so that staged rows stay 16-byte aligned.
__host__ __device__ constexpr int row_k(int D) { return D + 8; }
__host__ __device__ constexpr int row_stage(int Dv) { return Dv + 4; }

// One warp over keys [w0, w1) of the CTA (w0 a multiple of STEP; keys up
// to the next multiple of STEP are finite in shared memory).  Leaves the
// warp's unnormalised acc, m (log2 units) and l of the 16 rows in `st`
// ([ROWS][row_stage(Dv)]: acc, then m, l).
template <int D, int Dv>
__device__ __forceinline__ void attend(float scale2, const bf16* Qs,
                                       const bf16* Ks, const bf16* Vs,
                                       uint64_t* bars, int w0, int w1,
                                       float* st) {
    constexpr int LDK = row_k(D), LDV = row_k(Dv), SR = row_stage(Dv);
    const int lane = threadIdx.x % 32;
    float o[Dv / 8][4];
#pragma unroll
    for (int n = 0; n < Dv / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows r, r + 8

    if (w0 < w1) {
        hopper::mbar_wait(&bars[0], 0);
        uint32_t qf[D / 16][4];            // A fragments of Q, k16 slices
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            hopper::ldmatrix_x4(qf[kk], Qs + ((lane % 8) + ((lane / 8) % 2) * 8) * LDK
                                            + kk * 16 + (lane / 16) * 8);
        for (int j0 = w0; j0 < w1; j0 += STEP) {
            // S[16 x 16 keys] = Q K^T, as two n8 tiles.
            float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                uint32_t kb[4];
                hopper::ldmatrix_x4(kb, Ks + (j0 + (lane % 8) + (lane / 16) * 8) * LDK
                                            + kk * 16 + ((lane / 8) % 2) * 8);
                hopper::mma_16816(s[0], qf[kk], kb[0], kb[1]);
                hopper::mma_16816(s[1], qf[kk], kb[2], kb[3]);
            }
            float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = j0 + t * 8 + (lane % 4) * 2 + (e % 2);
                    s[t][e] = key < w1 ? s[t][e] * scale2 : NEG_INF;
                    mx[e / 2] = fmaxf(mx[e / 2], s[t][e]);
                }
            float corr[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float mnew = fmaxf(m[h], quad_max(mx[h]));
                corr[h] = exp2f(m[h] - mnew);
                m[h] = mnew;
                l[h] *= corr[h];
            }
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    s[t][e] = exp2f(s[t][e] - m[e / 2]);
                    l[e / 2] += s[t][e];       // this lane's share
                }
#pragma unroll
            for (int n = 0; n < Dv / 8; ++n) {
                o[n][0] *= corr[0];
                o[n][1] *= corr[0];
                o[n][2] *= corr[1];
                o[n][3] *= corr[1];
            }
            // P as the A fragment of one k16 slice: the two score tiles'
            // layouts are the A layout's two column halves.
            const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                    pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
            hopper::mbar_wait(&bars[1], 0);
#pragma unroll
            for (int n = 0; n < Dv / 16; ++n) {
                uint32_t vb[4];
                hopper::ldmatrix_x4_trans(vb, Vs + (j0 + (lane % 8) + ((lane / 8) % 2) * 8) * LDV
                                                  + n * 16 + (lane / 16) * 8);
                hopper::mma_16816(o[2 * n], pa, vb[0], vb[1]);
                hopper::mma_16816(o[2 * n + 1], pa, vb[2], vb[3]);
            }
        }
    }

    const int r = lane / 4, c = (lane % 4) * 2;
#pragma unroll
    for (int n = 0; n < Dv / 8; ++n) {
        *reinterpret_cast<float2*>(st + r * SR + n * 8 + c) = make_float2(o[n][0], o[n][1]);
        *reinterpret_cast<float2*>(st + (r + 8) * SR + n * 8 + c) =
            make_float2(o[n][2], o[n][3]);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    if (lane % 4 == 0) {
        st[r * SR + Dv] = m[0];
        st[r * SR + Dv + 1] = l[0];
        st[(r + 8) * SR + Dv] = m[1];
        st[(r + 8) * SR + Dv + 1] = l[1];
    }
}

// Grid (n_split, KV, B), THREADS threads.  Shared memory: two mbarriers;
// K [keys][D + 8], V [keys][Dv + 8] and Q [ROWS][D + 8] bf16, keys =
// ceil(S / n_split) rounded up to STEP; the warps' stage [NWARPS][ROWS]
// [Dv + 4], the combine's (m, l) [n_split][G] (m then replaced by the
// weight) and 1 / L [G], fp32.  The last CTA reuses K, V, Q and the stage
// for the partials it combines.
template <int D, int Dv>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(Args a) {
    constexpr int LDK = row_k(D), LDV = row_k(Dv), SR = row_stage(Dv);
    const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
    const int G = a.H / a.KV;
    const int ns = a.n_split;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int len = max(0, min(a.length[b], a.S));
    const int cap = (a.S + ns - 1) / ns;             // keys shared memory holds
    const int floor_keys = min(cap, (16 * G * Dv + D + Dv - 1) / (D + Dv));
    const int per = max((len + ns - 1) / ns, floor_keys);
    const int used = (len + per - 1) / per;          // splits with keys
    const int j0 = min(len, split * per);
    const int nk = min(len, j0 + per) - j0;
    const int keys = (cap + STEP - 1) / STEP * STEP;

    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);        // K, V
    bf16* Ks = reinterpret_cast<bf16*>(smem + 16);
    bf16* Vs = Ks + (size_t)keys * LDK;
    bf16* Qs = Vs + (size_t)keys * LDV;
    float* stage = reinterpret_cast<float*>(Qs + ROWS * LDK);
    float2* mls = reinterpret_cast<float2*>(stage + NWARPS * ROWS * SR);
    float* inv = reinterpret_cast<float*>(mls + G * ns);
    __shared__ int last;
    __shared__ float fac[ROWS][NWARPS];              // warp merge factors

    const long long bkv = (long long)b * a.KV + hk;
    const long long rec = (bkv * ns + split) * G;    // (split, head 0)
    float* part_acc = a.part;
    float* part_ml = a.part + (long long)gridDim.z * a.KV * ns * G * Dv;

    if (nk > 0) {
        const int nk16 = (nk + STEP - 1) / STEP * STEP;
        if (tid == 0) {
            hopper::mbar_init(&bars[0], THREADS);
            hopper::mbar_init(&bars[1], THREADS);
            hopper::fence_barrier_init();
        }
        // Zeros in the padding rows: Q past G, K and V past nk.
        const uint4 zero = make_uint4(0, 0, 0, 0);
        for (int i = tid; i < (ROWS - G) * (D / 8); i += THREADS)
            *reinterpret_cast<uint4*>(Qs + (G + i / (D / 8)) * LDK + (i % (D / 8)) * 8) = zero;
        for (int i = tid; i < (nk16 - nk) * (D / 8); i += THREADS)
            *reinterpret_cast<uint4*>(Ks + (nk + i / (D / 8)) * LDK + (i % (D / 8)) * 8) = zero;
        for (int i = tid; i < (nk16 - nk) * (Dv / 8); i += THREADS)
            *reinterpret_cast<uint4*>(Vs + (nk + i / (Dv / 8)) * LDV + (i % (Dv / 8)) * 8) =
                zero;
        __syncthreads();

        const bf16* qg = a.q + ((long long)b * a.H + (long long)hk * G) * D;
        for (int i = tid; i < G * (D / 8); i += THREADS)
            hopper::cp_async16(Qs + (i / (D / 8)) * LDK + (i % (D / 8)) * 8, qg + i * 8);
        const long long row0 = ((long long)b * a.S + j0) * a.KV + hk;
        for (int i = tid; i < nk * (D / 8); i += THREADS) {
            const int r = i / (D / 8), c = i % (D / 8);
            hopper::cp_async16(Ks + r * LDK + c * 8,
                               a.kc + (row0 + (long long)r * a.KV) * D + c * 8);
        }
        hopper::cp_async_arrive(&bars[0]);
        for (int i = tid; i < nk * (Dv / 8); i += THREADS) {
            const int r = i / (Dv / 8), c = i % (Dv / 8);
            hopper::cp_async16(Vs + r * LDV + c * 8,
                               a.vc + (row0 + (long long)r * a.KV) * Dv + c * 8);
        }
        hopper::cp_async_arrive(&bars[1]);

        // Warp ranges start at multiples of STEP; warp 0 always has keys,
        // so every copy has landed before the CTA can exit.
        const int cw = ((nk + NWARPS - 1) / NWARPS + STEP - 1) / STEP * STEP;
        const int w0 = min(nk, warp * cw), w1 = min(nk, w0 + cw);
        attend<D, Dv>(a.scale * LOG2E, Qs, Ks, Vs, bars, w0, w1,
                      stage + warp * ROWS * SR);
        __syncthreads();

        // Merge the warps into the split's partial: per head, the warps'
        // factors 2^(m_w - M), then acc = sum_w f_w acc_w.
        if (tid < G) {
            float M = NEG_INF, L = 0.f;
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, stage[(w * ROWS + tid) * SR + Dv]);
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) {
                const float* row = stage + (w * ROWS + tid) * SR;
                fac[tid][w] = exp2f(row[Dv] - M);
                L = fmaf(row[Dv + 1], fac[tid][w], L);
            }
            part_ml[(rec + tid) * 2] = M;
            part_ml[(rec + tid) * 2 + 1] = L;
        }
        __syncthreads();
        for (int idx = tid; idx < G * (Dv / 4); idx += THREADS) {
            const int g = idx / (Dv / 4), d4 = idx % (Dv / 4);
            float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) {
                const float4 x =
                    reinterpret_cast<const float4*>(stage + (w * ROWS + g) * SR)[d4];
                const float f = fac[g][w];
                sum = make_float4(fmaf(f, x.x, sum.x), fmaf(f, x.y, sum.y),
                                  fmaf(f, x.z, sum.z), fmaf(f, x.w, sum.w));
            }
            reinterpret_cast<float4*>(part_acc + (rec + g) * Dv)[d4] = sum;
        }
    }

    // Arrive; the last CTA of this (b, kv head) combines.
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&a.counter[bkv], 1) == ns - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();

    // Weights 2^(m_s - M) / L per (split, head) over the splits that hold
    // keys, from their (m, l) staged in shared memory; 8 lanes per head.
    const long long base = bkv * ns * G;             // (split 0, head 0)
    const float2* ml = reinterpret_cast<const float2*>(part_ml) + base;
#pragma unroll 4
    for (int i = tid; i < used * G; i += THREADS) mls[i] = __ldcg(ml + i);
    __syncthreads();
    {
        const int g = tid / 8, j = tid % 8;          // G <= 16 = THREADS / 8
        float M = NEG_INF, L = 0.f;
        if (g < G)
            for (int s = j; s < used; s += 8) M = fmaxf(M, mls[s * G + g].x);
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
        if (g < G)
            for (int s = j; s < used; s += 8) {
                const float2 v = mls[s * G + g];
                const float w = exp2f(v.x - M);
                mls[s * G + g].x = w;
                L = fmaf(v.y, w, L);
            }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) L += __shfl_xor_sync(FULL, L, o);
        if (g < G && j == 0) {
            inv[g] = 1.f / fmaxf(L, 1e-30f);
            if (a.lse)
                a.lse[(long long)b * a.H + (long long)hk * G + g] =
                    L > 0.f ? LN2 * (M + log2f(L)) : __int_as_float(0xff800000);
        }
    }
    __syncthreads();

    // out = sum_s w_s acc_s / L, in split order.  The partials come into
    // shared memory (K, V, Q and the stage: free now) by cp.async, as many
    // splits at a time as fit; a thread owns the float4s tid + k THREADS of
    // out [G][Dv].
    constexpr int MAX_OUT = ROWS * (Dv / 4) / THREADS;
    const int n_out = G * (Dv / 4);
    float4* buf = reinterpret_cast<float4*>(Ks);
    const int fit = (int)((reinterpret_cast<unsigned char*>(mls) -
                           reinterpret_cast<unsigned char*>(Ks)) / (n_out * sizeof(float4)));
    const float4* pacc = reinterpret_cast<const float4*>(part_acc) + base * (Dv / 4);
    float4 o[MAX_OUT];
#pragma unroll
    for (int k = 0; k < MAX_OUT; ++k) o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < used; s0 += fit) {
        const int nb = min(fit, used - s0);
        for (int i = tid; i < nb * n_out; i += THREADS)
            hopper::cp_async16(buf + i, pacc + (long long)s0 * n_out + i);
        hopper::cp_async_wait_all();
        __syncthreads();
#pragma unroll
        for (int k = 0; k < MAX_OUT; ++k) {
            const int idx = tid + k * THREADS;
            if (idx >= n_out) break;
            const int g = idx / (Dv / 4);
            for (int s = 0; s < nb; ++s) {
                const float w = mls[(s0 + s) * G + g].x;
                const float4 v = buf[s * n_out + idx];
                o[k] = make_float4(fmaf(w, v.x, o[k].x), fmaf(w, v.y, o[k].y),
                                   fmaf(w, v.z, o[k].z), fmaf(w, v.w, o[k].w));
            }
        }
        __syncthreads();                             // buf is refilled next
    }
#pragma unroll
    for (int k = 0; k < MAX_OUT; ++k) {
        const int idx = tid + k * THREADS;
        if (idx >= n_out) break;
        const int g = idx / (Dv / 4), d4 = idx % (Dv / 4);
        const float r = inv[g];
        uint2 packed;
        packed.x = pack_bf16(o[k].x * r, o[k].y * r);
        packed.y = pack_bf16(o[k].z * r, o[k].w * r);
        *reinterpret_cast<uint2*>(a.out + ((long long)b * a.H + (long long)hk * G + g) * Dv
                                  + d4 * 4) = packed;
    }
    if (tid == 0) a.counter[bkv] = 0;
}

size_t smem_bytes(int S, int D, int Dv, int G, int n_split) {
    const size_t keys = ((S + n_split - 1) / n_split + STEP - 1) / STEP * STEP;
    return 16 + sizeof(bf16) * (keys * (row_k(D) + row_k(Dv)) + ROWS * row_k(D)) +
           sizeof(float) * ((size_t)NWARPS * ROWS * row_stage(Dv) +
                            2 * (size_t)G * n_split + G);
}

template <int D, int Dv>
cudaError_t launch(const Args& a, int B, size_t smem, cudaStream_t st) {
    const void* kern = reinterpret_cast<const void*>(decode_attention_kernel<D, Dv>);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    decode_attention_kernel<D, Dv><<<dim3(a.n_split, a.KV, B), THREADS, smem, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Shared memory one CTA needs (the wrapper's plan mirrors it).
extern "C" long long decode_attention_smem(int S, int D, int Dv, int G,
                                           int n_split) {
    return (long long)smem_bytes(S, D, Dv, G, n_split);
}

extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, const void* length,
                                    void* part, void* counter, void* out,
                                    void* lse, int B, int S, int H, int KV,
                                    int D, int Dv,
                                    int n_split, float scale, int device,
                                    void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (H % KV || H / KV > ROWS || n_split < 1 || n_split > S)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(S, D, Dv, H / KV, n_split);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k_cache),
           static_cast<const bf16*>(v_cache), static_cast<const int*>(length),
           static_cast<float*>(part), static_cast<int*>(counter),
           static_cast<bf16*>(out), static_cast<float*>(lse), S, H, KV,
           n_split, scale};
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (D == 64 && Dv == 64) return (int)launch<64, 64>(a, B, smem, st);
    if (D == 128 && Dv == 128) return (int)launch<128, 128>(a, B, smem, st);
    if (D == 64 && Dv == 128) return (int)launch<64, 128>(a, B, smem, st);
    if (D == 256 && Dv == 256) return (int)launch<256, 256>(a, B, smem, st);
    if (D == 32 && Dv == 32) return (int)launch<32, 32>(a, B, smem, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
