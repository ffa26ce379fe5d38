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
// gradients (fp32): 22 B an element, 230.7 MB, plus the forward's fp32
// state entering each 64-step chunk, 0.66 MB: 0.069 ms at 3.35 TB/s,
// against ~25 operations an element.  Reaching that rate takes every SM
// busy with loads in flight while it computes.
//
// What the design does about it: two launches, no atomics.
// 1. The scan: one CTA per (batch, tile of 32 channels), 320 at the
//    training shape, all resident at once (three an SM: <= 80 registers a
//    thread, ~57 KB of shared memory a CTA), the forward's geometry
//    (csrc/rglru_scan.cu): lane l takes channel l, warp w the steps
//    [8 w, 8 w + 8) of each 64-step chunk.  The CTA walks its chunks once,
//    from the last:
//    - Loads: each chunk's [T][32] boxes of x, gate_a, gate_i and dh,
//      24 KB, arrive by TMA (one thread, four boxes of rank-3 maps) into
//      one of STAGES buffers on an mbarrier; a buffer is refilled with the
//      chunk STAGES before as soon as its stores have read it, so the next
//      chunk's loads are in flight while a chunk is computed.  TMA
//      zero-fills rows past S and channels past C: a = 1, beta = 0,
//      dh = 0, the identity in both directions.
//    - The state entering each chunk is the forward kernel's (its optional
//      entering output, fp32 [B, ceil(S / 64), C]).
//    - Scan: each warp reads its 8 steps from the buffer, keeps what it
//      derives from them in registers (a_t, beta_t, beta's derivative,
//      beta_t i_t x_t: 32 floats, 62 registers a thread), composes its
//      sub-segment's map h -> A h + B and the reverse map
//      carry -> A' carry + B' of its steps (carry = a_t g_t, the part of
//      g_{t-1} that comes from the right), and writes both to shared
//      memory.  After a barrier it applies the maps of the warps
//      before it to the chunk's entering state and rescans to get h_{t-1}
//      in fp32 (the forward rounds h only on the way out, so the saved
//      bf16 h would not do), applies the reverse maps of the warps after
//      it, in the order 7, 6, .., to the carry entering the chunk from the
//      right, and walks its steps in reverse, forming every gradient.
//      Warp 0's carry leaves the chunk to the left.  The maps and carries
//      are double buffered by chunk parity.  Each thread sums r_t dL_t
//      over its steps; the warps' sums are added in order 0 .. 7 into a
//      [B, C] fp32 partial.
//    - Stores: a thread owns its 8 elements of each box, so it writes its
//      dx, d gate_a and d gate_i over its own x, gate_a and gate_i in the
//      buffer it read.  After a proxy fence and a barrier one thread
//      stores the three boxes by TMA (rows past S and channels past C left
//      out), waits until they have read the buffer, and refills it.
//    Shapes whose rows are not whole 16-byte pieces (C % 8 != 0), tensors
//    that are not 16-byte aligned, and S 0 take the same walk with each
//    thread copying its own elements between global memory (zeros past
//    the edges) and the buffer instead of TMA.
// 2. d log_a: one thread a channel sums the partials over B in order.
// Repeatable: a fixed order and no atomics, so two launches on one input
// give bitwise equal outputs.  a and beta use the forward's formula (expf,
// no fast math), so the gradient is that of the function computed.  Under
// strong decay a_t may underflow to 0: the chain of g breaks there, as it
// does in exact arithmetic below fp32's range.
//
// Layout: x, dh, dx [B, S, C] bf16; gate_a, gate_i, d gate_a, d gate_i
// [B, S, C] fp32; log_a, d log_a [C] fp32; dh_fin, d h0 [B, C] fp32
// (optional); entering [B, ceil(S / 64), C] fp32 (its chunk 0 the initial
// state); scratch [B, C] fp32; all contiguous.  Grid (ceil(C / 32), B), 256 threads; then
// ceil(C / 256) blocks of 256.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// repro_torch/kernels/rglru_scan_bwd.py mirrors T, TILE, WARPS and STAGES.
constexpr int TILE = 32;                // channels a CTA: one a lane
constexpr int WARPS = 8;                // sub-segments of a chunk: one a warp
constexpr int THREADS = WARPS * 32;
constexpr int T = 64;                   // steps a chunk
constexpr int SUB = T / WARPS;          // steps a sub-segment
constexpr int STAGES = 2;               // chunk buffers
constexpr uint32_t MAX_POLLS = 1u << 20;  // a lost copy traps in ~seconds

// Shared memory, in bytes.  STAGES buffers, each x [T][TILE] bf16, gate_a
// and gate_i [T][TILE] fp32 and dh [T][TILE] bf16 (every offset a multiple
// of 128, as TMA wants; the gradients are written over the first three);
// the sub-segment maps and reverse maps, each [2][WARPS][TILE] float2; the
// carry entering a chunk from the right [2][TILE] fp32; the warps' sums of
// r dL [WARPS][TILE] fp32; one mbarrier a buffer.
struct Layout {
    static constexpr int x = 0, ga = x + T * TILE * 2, gi = ga + T * TILE * 4;
    static constexpr int dh = gi + T * TILE * 4;
    static constexpr int stage = dh + T * TILE * 2;
    static constexpr int maps = STAGES * stage;
    static constexpr int rmaps = maps + 2 * WARPS * TILE * 8;
    static constexpr int carry = rmaps + 2 * WARPS * TILE * 8;
    static constexpr int sums = carry + 2 * TILE * 4;
    static constexpr int bars = sums + WARPS * TILE * 4;
    static constexpr int bytes = bars + STAGES * 8;
};
static_assert(Layout::ga % 128 == 0 && Layout::gi % 128 == 0 &&
              Layout::dh % 128 == 0 && Layout::stage % 128 == 0,
              "TMA wants 128-byte aligned boxes");
// Three CTAs an SM (the launch bounds), each with 1 KB the system reserves,
// in an H100 SM's 228 KB: all 320 CTAs of the training shape at once.
static_assert(3 * (Layout::bytes + 1024) <= 228 * 1024, "three CTAs an SM");

struct Args {
    const bf16* x;
    const float* gate_a;
    const float* gate_i;
    const float* log_a;
    const bf16* dh;
    const float* dh_fin;
    const float* entering;              // [B, nc, C]
    bf16* dx;
    float* dga;
    float* dgi;
    float* dh0;
    float* partial;                     // [B, C]
    int S, C;
    float c;
};

struct Maps {                           // rank-3 TMA maps over [B, S, C]
    CUtensorMap x, ga, gi, dh, dx, dga, dgi;
};

__device__ __forceinline__ void tma_chunk(unsigned char* st, uint64_t* bar,
                                          const Maps& m, int chunk, int c0,
                                          int b) {
    hopper::mbar_arrive_expect_tx(bar, Layout::stage);
    hopper::tma_load_3d(st + Layout::x, &m.x, bar, c0, chunk * T, b);
    hopper::tma_load_3d(st + Layout::ga, &m.ga, bar, c0, chunk * T, b);
    hopper::tma_load_3d(st + Layout::gi, &m.gi, bar, c0, chunk * T, b);
    hopper::tma_load_3d(st + Layout::dh, &m.dh, bar, c0, chunk * T, b);
}

// TMA: x, the gates and dh arrive and the gradients leave by TMA through
// the maps (C a multiple of 8, 16-byte aligned tensors, S > 0); otherwise
// each thread copies its own elements and the maps are not read.  One
// source for both.
template <bool TMA>
__global__ void __launch_bounds__(THREADS, 3)
rglru_bwd_scan_kernel(Args a, const __grid_constant__ Maps m) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int c0 = blockIdx.x * TILE, b = blockIdx.y;
    const int ch = c0 + lane;
    const bool live = ch < a.C;
    const int S = a.S, C = a.C;
    const int nc = (S + T - 1) / T;
    // Channels past C take la = 0 and zero inputs: the identity.
    const float la = live ? a.c * a.log_a[ch] : 0.f;
    // This batch row's [S, C] planes start at base; within one, 32-bit
    // offsets (the wrapper refuses S C >= 2^31).
    const long long base = (long long)b * S * C;

    extern __shared__ __align__(128) unsigned char smem[];
    float2* maps = reinterpret_cast<float2*>(smem + Layout::maps);
    float2* rmaps = reinterpret_cast<float2*>(smem + Layout::rmaps);
    float* carry_in = reinterpret_cast<float*>(smem + Layout::carry);
    float* sums = reinterpret_cast<float*>(smem + Layout::sums);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Layout::bars);

    if constexpr (TMA) {
        if (tid == 0) {
            for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&bars[s], 1);
            hopper::fence_barrier_init();
        }
        __syncthreads();
        if (tid == 0)
            for (int i = 0; i < STAGES && i < nc; ++i)
                tma_chunk(smem + i * Layout::stage, &bars[i], m, nc - 1 - i,
                          c0, b);
    }

    // The carry entering the last chunk from the right is the final
    // state's cotangent; warp 0 keeps the carry leaving each chunk.
    float carry = live && a.dh_fin ? a.dh_fin[(long long)b * C + ch] : 0.f;
    if (warp == 0) carry_in[lane] = carry;
    float acc = 0.f;                            // sum of r_t dL_t
    // This thread's element of step k in a box: e0 + k * TILE.
    const int e0 = warp * SUB * TILE + lane;
    // Iteration i walks chunk nc - 1 - i from buffer i % STAGES.
    for (int i = 0; i < nc; ++i) {
        const int c = nc - 1 - i, t0 = c * T + warp * SUB;
        unsigned char* st = smem + (i % STAGES) * Layout::stage;
        bf16* sx = reinterpret_cast<bf16*>(st + Layout::x);
        float* sga = reinterpret_cast<float*>(st + Layout::ga);
        float* sgi = reinterpret_cast<float*>(st + Layout::gi);
        bf16* sdh = reinterpret_cast<bf16*>(st + Layout::dh);
        const float h_in = live ? a.entering[((long long)b * nc + c) * C + ch] : 0.f;
        if constexpr (TMA) {
            hopper::mbar_wait(&bars[i % STAGES], (i / STAGES) & 1, MAX_POLLS);
        } else {
            // One step at a time: unrolled, the 32 loads spilled.
#pragma unroll 1
            for (int k = 0; k < SUB; ++k) {
                const bool in = live && t0 + k < S;
                const long long idx = base + (t0 + k) * C + ch;
                const int e = e0 + k * TILE;
                sx[e] = in ? a.x[idx] : __float2bfloat16(0.f);
                sga[e] = in ? a.gate_a[idx] : 0.f;
                sgi[e] = in ? a.gate_i[idx] : 0.f;
                sdh[e] = in ? a.dh[idx] : __float2bfloat16(0.f);
            }
        }

        // Each step's a_t, beta_t, beta's derivative and beta_t i_t x_t,
        // kept in registers for the rescan and the reverse walk; the
        // sub-segment's map and, from its last step, its reverse map:
        // carry in from the right -> carry out to the left, with
        // g_t = dh_t + carry, carry = a_t g_t.
        float av[SUB], beta[SUB], dbeta[SUB], bv[SUB];
        float A = 1.f, Bm = 0.f;
#pragma unroll
        for (int k = 0; k < SUB; ++k) {
            const int e = e0 + k * TILE;
            const float ra = sga[e];
            av[k] = expf(la * ra);
            const float e2 = expf(2.f * (la * ra));
            const float u = 1.f - e2;
            beta[k] = sqrtf(fmaxf(u, 0.f));
            dbeta[k] = u > 0.f ? -e2 / beta[k] : 0.f;
            bv[k] = beta[k] * (sgi[e] * __bfloat162float(sx[e]));
            A *= av[k];
            Bm = av[k] * Bm + bv[k];
        }
        float Ar = 1.f, Br = 0.f;
#pragma unroll
        for (int k = SUB - 1; k >= 0; --k) {
            Ar *= av[k];
            Br = av[k] * (__bfloat162float(sdh[e0 + k * TILE]) + Br);
        }
        maps[((i % 2) * WARPS + warp) * TILE + lane] = make_float2(A, Bm);
        rmaps[((i % 2) * WARPS + warp) * TILE + lane] = make_float2(Ar, Br);
        __syncthreads();

        // h entering this warp's steps, then h_{t-1} of each step.
        float h = h_in;
#pragma unroll
        for (int j = 0; j < WARPS - 1; ++j) {
            if (j < warp) {
                const float2 mp = maps[((i % 2) * WARPS + j) * TILE + lane];
                h = mp.x * h + mp.y;
            }
        }
        float hp[SUB];
#pragma unroll
        for (int k = 0; k < SUB; ++k) {
            hp[k] = h;
            h = av[k] * h + bv[k];
        }
        // The carry entering this warp's steps from the right.
        float cr = carry_in[(i % 2) * TILE + lane];
#pragma unroll
        for (int j = WARPS - 1; j > 0; --j) {
            if (j > warp) {
                const float2 mp = rmaps[((i % 2) * WARPS + j) * TILE + lane];
                cr = mp.x * cr + mp.y;
            }
        }
#pragma unroll
        for (int k = SUB - 1; k >= 0; --k) {
            const int e = e0 + k * TILE;
            const float xv = __bfloat162float(sx[e]), ra = sga[e], iv = sgi[e];
            const float g = __bfloat162float(sdh[e]) + cr;
            const float dL = g * (av[k] * hp[k] + dbeta[k] * (iv * xv));
            // The gradients over this thread's own inputs.
            sx[e] = __float2bfloat16(g * beta[k] * iv);
            sgi[e] = g * beta[k] * xv;
            sga[e] = la * dL;
            if (live && t0 + k < S) acc += ra * dL;
            cr = av[k] * g;
        }
        if (warp == 0) {
            carry_in[((i + 1) % 2) * TILE + lane] = cr;
            carry = cr;
        }

        if constexpr (TMA) {
            hopper::fence_proxy_async();
            __syncthreads();
            if (tid == 0) {
                hopper::tma_store_3d(&m.dx, st + Layout::x, c0, c * T, b);
                hopper::tma_store_3d(&m.dga, st + Layout::ga, c0, c * T, b);
                hopper::tma_store_3d(&m.dgi, st + Layout::gi, c0, c * T, b);
                hopper::bulk_commit();
                if (i + STAGES < nc) {
                    hopper::bulk_wait_read<0>();
                    tma_chunk(st, &bars[i % STAGES], m, c - STAGES, c0, b);
                }
            }
        } else {
#pragma unroll 1
            for (int k = 0; k < SUB; ++k) {
                if (live && t0 + k < S) {
                    const long long idx = base + (t0 + k) * C + ch;
                    const int e = e0 + k * TILE;
                    a.dx[idx] = sx[e];
                    a.dga[idx] = sga[e];
                    a.dgi[idx] = sgi[e];
                }
            }
        }
    }
    if (warp == 0 && live && a.dh0) a.dh0[(long long)b * C + ch] = carry;
    sums[warp * TILE + lane] = acc;
    __syncthreads();
    if (warp == 0 && live) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += sums[w * TILE + lane];
        a.partial[(long long)b * C + ch] = s;
    }
    // The last stores must have read their buffer before the CTA's shared
    // memory goes.
    if constexpr (TMA)
        if (tid == 0) hopper::bulk_wait_read<0>();
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

// Rank-3 map over a contiguous [batch, seq, C] tensor: boxes of T steps by
// TILE channels of one batch row (zeros past S and C), unswizzled.
cudaError_t make_map(CUtensorMap* map, const void* ptr, bool bf16_elems,
                     int C, int S, int B) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const int elem = bf16_elems ? 2 : 4;
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)C * elem, (cuuint64_t)S * C * elem};
    const cuuint32_t boxes[3] = {TILE, T, 1};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult r = encode(
        map, bf16_elems ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
        3, const_cast<void*>(ptr), dims, strides, boxes, elem_strides,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool TMA>
cudaError_t allow_smem() {
    return cudaFuncSetAttribute(rglru_bwd_scan_kernel<TMA>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Layout::bytes);
}

}  // namespace

// Gradients of the RG-LRU scan.  B and C must be positive (the wrapper
// answers the empty cases); dh_fin and dh0 may be null (no final-state
// cotangent, no initial state); entering is the forward kernel's fp32
// [B, ceil(S / 64), C] (not read when S is 0), partial fp32 scratch
// [B, C].
extern "C" int rglru_scan_bwd(const void* x, const void* gate_a,
                              const void* gate_i, const void* log_a,
                              const void* dh, const void* dh_fin,
                              const void* entering,
                              void* dx, void* dga, void* dgi, void* dla,
                              void* dh0, void* partial, int B, int S, int C,
                              float c_const, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B <= 0 || C <= 0 || S < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const bool tma = S > 0 && C % 8 == 0 && aligned(x) && aligned(gate_a) &&
                     aligned(gate_i) && aligned(dh) && aligned(dx) &&
                     aligned(dga) && aligned(dgi);
    err = tma ? allow_smem<true>() : allow_smem<false>();
    if (err != cudaSuccess) return (int)err;
    Maps m{};
    if (tma) {
        const struct { CUtensorMap* map; const void* ptr; bool bf; } maps[] = {
            {&m.x, x, true}, {&m.ga, gate_a, false}, {&m.gi, gate_i, false},
            {&m.dh, dh, true}, {&m.dx, dx, true}, {&m.dga, dga, false},
            {&m.dgi, dgi, false}};
        for (const auto& mp : maps) {
            err = make_map(mp.map, mp.ptr, mp.bf, C, S, B);
            if (err != cudaSuccess) return (int)err;
        }
    }
    Args a{static_cast<const bf16*>(x), static_cast<const float*>(gate_a),
           static_cast<const float*>(gate_i), static_cast<const float*>(log_a),
           static_cast<const bf16*>(dh), static_cast<const float*>(dh_fin),
           static_cast<const float*>(entering), static_cast<bf16*>(dx),
           static_cast<float*>(dga), static_cast<float*>(dgi),
           static_cast<float*>(dh0), static_cast<float*>(partial), S, C,
           c_const};
    const dim3 grid((C + TILE - 1) / TILE, B);
    if (tma)
        rglru_bwd_scan_kernel<true><<<grid, THREADS, Layout::bytes, st>>>(a, m);
    else
        rglru_bwd_scan_kernel<false><<<grid, THREADS, Layout::bytes, st>>>(a, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rglru_bwd_reduce_kernel<<<(C + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(dla), B, C,
        c_const);
    return (int)cudaGetLastError();
}

// The scan kernel's CTAs an SM holds at once (cudaOccupancy...), of the
// TMA instantiation (tma 1) or the other, into *blocks.
extern "C" int rglru_scan_bwd_occupancy(int tma, int* blocks) {
    cudaError_t err = tma ? allow_smem<true>() : allow_smem<false>();
    if (err != cudaSuccess) return (int)err;
    return (int)(tma ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, rglru_bwd_scan_kernel<true>, THREADS, Layout::bytes)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, rglru_bwd_scan_kernel<false>, THREADS, Layout::bytes));
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
