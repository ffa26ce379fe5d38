// RG-LRU gated linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py (rglru_pallas,
// body _kernel):
//   log a_t = c * log_a * r_t,  a_t = exp(log a_t)
//   h_t = a_t h_{t-1} + sqrt(max(1 - exp(2 log a_t), 0)) * (i_t x_t)
// per channel, with an fp32 state.  h comes out in x's dtype (bf16), the
// final state in fp32.  Unlike the Pallas kernel (which starts from zeros
// and leaves a resumed scan to XLA), the kernel loads an optional initial
// state.
//
// What bounds it on the card: bytes.  At the serving path's prefill shape
// (B 4, S 1024, 2560 channels; x bf16, both gates fp32, as the model feeds
// them) it moves ~126 MB -- x and h 21 MB each, the gates 42 MB each --
// ~38 us at 3.35 TB/s, against ~10 operations per element.  Reaching that
// rate takes ~25 KB in flight on every SM, and a walk over time must not
// be a chain of S dependent steps per thread.
//
// What the design does about it: one launch, no communication between
// CTAs.  One CTA per (batch, tile of 32 channels) -- 320 at the serving
// shape, all resident at once (3 a SM: <= 80 registers a thread, ~72 KB of
// shared memory a CTA) -- walks its chunks of T = 64 steps in order.
//   * Loads: each chunk's [T][32] tiles of x (bf16), gate_a and gate_i
//     (fp32), 20 KB, arrive by TMA (one thread, three boxes of a rank-3
//     map) into one of STAGES buffers on an mbarrier; the chunk STAGES
//     ahead is issued as soon as every warp has read this one, so two to
//     three chunks a CTA are in flight.  TMA zero-fills rows past S and
//     channels past C; a zero row is a = exp(0) = 1, beta = 0: the identity
//     map, so ragged edges need no masks in the scan, only in the stores.
//     Shapes whose rows are not whole 16-byte pieces (C % 8 != 0), tensors
//     that are not 16-byte aligned, and S 0 read and write the global
//     tensors directly instead, with zeros past the edges.
//   * Scan: h -> a h + b composes associatively.  Lane l takes channel l,
//     warp w the steps [8 w, 8 w + 8) of the chunk: it computes a_t and
//     b_t = beta_t i_t x_t into registers, composes them into its
//     sub-segment's map (A_w, B_w), and writes the map to shared memory.
//     After a barrier, warp w applies the maps of warps 0 .. w - 1, in
//     that fixed order, to the chunk's entering state and rescans its 8
//     steps from registers.  The last warp's final h is the next chunk's
//     entering state.  The maps and the entering state are double
//     buffered, so that barrier orders every read and write of them.
//   * Stores: h goes to a [T][32] bf16 staging tile (double buffered) and,
//     after a second barrier, out by one TMA store, which leaves out rows
//     past S and channels past C.  tools/rglru_phases.py times it against
//     a 2-byte store of every step from every thread ("plain stores").
//   * The training path asks for the fp32 state entering each chunk
//     (entering, [B, ceil(S / 64), C]), which the backward
//     (csrc/rglru_scan_bwd.cu) would otherwise rebuild: the last warp
//     stores the state it enters each chunk with, one coalesced store a
//     chunk.  It changes no other output's bits.
//   * Repeatable: a fixed order and no atomics, so two launches on one
//     input give bitwise equal outputs; nothing needs a reset between
//     launches.
// beta uses the plain version's formula (expf, no fast math).  A_w may
// underflow to 0 under strong decay: the earlier state's contribution is
// below fp32's range either way.
//
// Layout: x [B, S, C] bf16, gate_a and gate_i [B, S, C] fp32, log_a [C]
// fp32, h0 (optional) and state [B, C] fp32, h [B, S, C] bf16, entering
// (optional) [B, ceil(S / 64), C] fp32, all contiguous.  Grid
// (ceil(C / 32), B), 256 threads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// repro_torch/kernels/rglru_scan.py mirrors T, TILE and WARPS.
constexpr int TILE = 32;                // channels a CTA: one a lane
constexpr int WARPS = 8;                // sub-segments of a chunk: one a warp
constexpr int THREADS = WARPS * 32;
constexpr int T = 64;                   // steps a chunk
constexpr int SUB = T / WARPS;          // steps a sub-segment
constexpr int STAGES = 3;               // chunk buffers
constexpr uint32_t MAX_POLLS = 1u << 20;  // a lost copy traps in ~seconds

// Shared memory, in bytes.  STAGES buffers, each x [T][TILE] bf16 and
// gate_a, gate_i [T][TILE] fp32 (every offset a multiple of 128, as TMA
// wants); the sub-segment maps [2][WARPS][TILE] float2 (A, B); the chunk's
// entering state [2][TILE] fp32; h on its way out [2][T][TILE] bf16; one
// mbarrier a buffer.
struct Layout {
    static constexpr int x = 0, ga = x + T * TILE * 2, gi = ga + T * TILE * 4;
    static constexpr int stage = gi + T * TILE * 4;
    static constexpr int maps = STAGES * stage;
    static constexpr int carry = maps + 2 * WARPS * TILE * 8;
    static constexpr int hs = carry + 2 * TILE * 4;
    static constexpr int bars = hs + 2 * T * TILE * 2;
    static constexpr int bytes = bars + STAGES * 8;
};
static_assert(Layout::stage % 128 == 0 && Layout::hs % 128 == 0,
              "TMA wants 128-byte aligned boxes");
// Three CTAs an SM (the launch bounds), each with 1 KB the system reserves,
// in an H100 SM's 228 KB: all 320 CTAs of the serving shape at once.
static_assert(3 * (Layout::bytes + 1024) <= 228 * 1024, "three CTAs an SM");

struct Args {
    const bf16* x;
    const float* gate_a;
    const float* gate_i;
    const float* log_a;
    const float* h0;
    bf16* h;
    float* state;
    float* entering;                    // null: not asked for
    int S, C;
    float c;
};

__device__ __forceinline__ void tma_chunk(unsigned char* smem, uint64_t* bars,
                                          const CUtensorMap* tx,
                                          const CUtensorMap* tga,
                                          const CUtensorMap* tgi, int chunk,
                                          int c0, int b) {
    unsigned char* st = smem + (chunk % STAGES) * Layout::stage;
    uint64_t* bar = &bars[chunk % STAGES];
    hopper::mbar_arrive_expect_tx(bar, Layout::stage);
    hopper::tma_load_3d(st + Layout::x, tx, bar, c0, chunk * T, b);
    hopper::tma_load_3d(st + Layout::ga, tga, bar, c0, chunk * T, b);
    hopper::tma_load_3d(st + Layout::gi, tgi, bar, c0, chunk * T, b);
}

// TMA: x and the gates arrive by TMA through the maps tx, tga, tgi and h
// leaves through th (C a multiple of 8, 16-byte aligned tensors, S > 0);
// otherwise each thread reads and writes its own elements and the maps are
// not read.  One source for both.
template <bool TMA>
__global__ void __launch_bounds__(THREADS, 3)
rglru_scan_kernel(Args a, const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tga,
                  const __grid_constant__ CUtensorMap tgi,
                  const __grid_constant__ CUtensorMap th) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int c0 = blockIdx.x * TILE, b = blockIdx.y;
    const int ch = c0 + lane;
    const bool live = ch < a.C;
    const int S = a.S, C = a.C;
    const int nc = (S + T - 1) / T;
    // Channels past C take log a = 0 and zero inputs: the identity map.
    const float la = live ? a.c * a.log_a[ch] : 0.f;
    const long long row0 = (long long)b * S;

    extern __shared__ __align__(128) unsigned char smem[];
    float2* maps = reinterpret_cast<float2*>(smem + Layout::maps);
    float* carry = reinterpret_cast<float*>(smem + Layout::carry);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Layout::bars);

    if constexpr (TMA) {
        if (tid == 0) {
            for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&bars[s], 1);
            hopper::fence_barrier_init();
        }
        __syncthreads();
        if (tid == 0)
            for (int s = 0; s < STAGES && s < nc; ++s)
                tma_chunk(smem, bars, &tx, &tga, &tgi, s, c0, b);
    }

    // The entering state of chunk 0; then, in the last warp, the state
    // after each chunk.
    float h_last = live && a.h0 ? a.h0[(long long)b * C + ch] : 0.f;
    for (int c = 0; c < nc; ++c) {
        const int t0 = c * T + warp * SUB;
        float av[SUB], bv[SUB];
        float A = 1.f, Bm = 0.f;
        const unsigned char* st = smem + (c % STAGES) * Layout::stage;
        if constexpr (TMA) hopper::mbar_wait(&bars[c % STAGES], (c / STAGES) & 1, MAX_POLLS);
#pragma unroll
        for (int k = 0; k < SUB; ++k) {
            float xv, ra, iv;
            if constexpr (TMA) {
                const int e = (warp * SUB + k) * TILE + lane;
                xv = __bfloat162float(reinterpret_cast<const bf16*>(st + Layout::x)[e]);
                ra = reinterpret_cast<const float*>(st + Layout::ga)[e];
                iv = reinterpret_cast<const float*>(st + Layout::gi)[e];
            } else {
                const bool in = live && t0 + k < S;
                const long long idx = (row0 + t0 + k) * C + ch;
                xv = in ? __bfloat162float(a.x[idx]) : 0.f;
                ra = in ? a.gate_a[idx] : 0.f;
                iv = in ? a.gate_i[idx] : 0.f;
            }
            const float log_at = la * ra;
            av[k] = expf(log_at);
            bv[k] = sqrtf(fmaxf(1.f - expf(2.f * log_at), 0.f)) * (iv * xv);
            A *= av[k];
            Bm = av[k] * Bm + bv[k];
        }
        float2* cmaps = maps + (c % 2) * WARPS * TILE;
        cmaps[warp * TILE + lane] = make_float2(A, Bm);
        // Every warp has read this chunk's buffer and written its map; the
        // last warp wrote the entering state in the chunk before.
        __syncthreads();
        if constexpr (TMA)
            if (tid == 0 && c + STAGES < nc)
                tma_chunk(smem, bars, &tx, &tga, &tgi, c + STAGES, c0, b);

        float h = c == 0 ? h_last : carry[(c % 2) * TILE + lane];
        if (a.entering && warp == WARPS - 1 && live)
            a.entering[((long long)b * nc + c) * C + ch] = h;
#pragma unroll
        for (int j = 0; j < WARPS - 1; ++j) {
            if (j < warp) {
                const float2 m = cmaps[j * TILE + lane];
                h = m.x * h + m.y;
            }
        }
        if constexpr (TMA) {
            // Through a staging tile and one TMA store, which leaves out
            // rows past S and channels past C.  The tile written here was
            // last stored two chunks ago; thread 0 waited for that store.
            bf16* hs = reinterpret_cast<bf16*>(smem + Layout::hs) + (c % 2) * T * TILE;
#pragma unroll
            for (int k = 0; k < SUB; ++k) {
                h = av[k] * h + bv[k];
                hs[(warp * SUB + k) * TILE + lane] = __float2bfloat16(h);
            }
            hopper::fence_proxy_async();
            __syncthreads();
            if (tid == 0) {
                hopper::tma_store_3d(&th, hs, c0, c * T, b);
                hopper::bulk_commit();
                hopper::bulk_wait_read<1>();
            }
        } else {
#pragma unroll
            for (int k = 0; k < SUB; ++k) {
                h = av[k] * h + bv[k];
                if (live && t0 + k < S) a.h[(row0 + t0 + k) * C + ch] = __float2bfloat16(h);
            }
        }
        if (warp == WARPS - 1) {
            carry[((c + 1) % 2) * TILE + lane] = h;
            h_last = h;
        }
    }
    if (warp == WARPS - 1 && live) a.state[(long long)b * C + ch] = h_last;
    // The last stores must have read the staging tiles before the CTA's
    // shared memory goes.
    if constexpr (TMA)
        if (tid == 0) hopper::bulk_wait_read<0>();
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
cudaError_t make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                     int elem, int C, int S, int B) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)C * elem, (cuuint64_t)S * C * elem};
    const cuuint32_t boxes[3] = {TILE, T, 1};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult r = encode(
        map, type, 3, const_cast<void*>(ptr), dims, strides, boxes, elem_strides,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rglru_scan_fwd(const void* x, const void* gate_a,
                              const void* gate_i, const void* log_a,
                              const void* h0, void* h, void* state,
                              void* entering, int B, int S, int C,
                              float c_const, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B <= 0 || C <= 0 || S < 0) return (int)cudaErrorInvalidValue;
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const bool tma = S > 0 && C % 8 == 0 && aligned(x) && aligned(gate_a) &&
                     aligned(gate_i) && aligned(h);
    const auto kernel = tma ? rglru_scan_kernel<true> : rglru_scan_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout::bytes);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap tx{}, tga{}, tgi{}, th{};
    if (tma) {
        err = make_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, C, S, B);
        if (err == cudaSuccess)
            err = make_map(&tga, gate_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, C, S, B);
        if (err == cudaSuccess)
            err = make_map(&tgi, gate_i, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, C, S, B);
        if (err == cudaSuccess)
            err = make_map(&th, h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, C, S, B);
        if (err != cudaSuccess) return (int)err;
    }
    Args a{static_cast<const bf16*>(x), static_cast<const float*>(gate_a),
           static_cast<const float*>(gate_i), static_cast<const float*>(log_a),
           static_cast<const float*>(h0), static_cast<bf16*>(h),
           static_cast<float*>(state), static_cast<float*>(entering), S, C,
           c_const};
    kernel<<<dim3((C + TILE - 1) / TILE, B), THREADS, Layout::bytes,
             reinterpret_cast<cudaStream_t>(stream)>>>(a, tx, tga, tgi, th);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
