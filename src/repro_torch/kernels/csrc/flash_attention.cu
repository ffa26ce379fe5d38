// Flash attention forward (prefill) for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:109
// (flash_attention_pallas, body _kernel): forward-only online-softmax GQA
// attention with a causal, sliding-window or no mask and a static q_offset.
// Scores are accumulated in fp32 and scaled in fp32; the running max m, sum
// l and output accumulator are fp32; a row that no key may attend to comes
// out 0 (the Pallas kernel's 1e-30 floor on l).  On request (training) it
// also writes each row's logsumexp for the backward
// (csrc/flash_attention_bwd.cu); serving passes no lse pointer.
//
// What bounds it on the card: tensor-core operations.  At the serving
// path's prefill shapes the causal half of QK^T and PV is 34.39 GFLOP
// (yi-6b: B 4, S 1024, 32 heads / 4 KV of 128) and 21.50 GFLOP
// (recurrentgemma-2b: 10 heads / 1 KV of 256), against ~50 MB of Q/K/V/O:
// far above the H100's ~295 FLOP/byte balance point.  What the design does
// about it:
// - Both products run on wgmma, Hopper's warpgroup tensor-core
//   instruction, fed from shared memory: S = Q K^T with both operands in
//   shared memory, O += P V with P from registers.
// - Copies go through TMA: Q once, K and V through a two-stage ring, each
//   stage with its own "full" mbarrier for K and for V, so QK^T starts
//   before V lands.  One thread issues the copies of tile t + 1 before the
//   CTA computes on tile t; a CTA-wide barrier at the end of each tile
//   frees its stage.  Rank-4 tensor maps (D, heads, seq, batch) let the
//   hardware zero-fill the ragged sequence edge of each batch.
// - The softmax runs on the accumulator registers: each thread holds rows
//   r and r + 8 of its warp's 16, a row's max is two shuffles across the
//   quad, the rescale of O happens in place, and P is packed to bf16 in
//   the order of wgmma's A fragment.  Nothing of S, P or O goes through
//   shared memory.
// - K/V tiles that the mask covers entirely are skipped, and the mask is
//   evaluated only on tiles that cross its edge; the heaviest query tiles
//   of every head are scheduled first.
// Left for later: a producer warp with setmaxnreg, ping-pong between the
// two warpgroups (softmax of one beside the products of the other),
// packing the G heads of a KV group into M, persistent CTAs.
//
// CTA: two warpgroups (256 threads), 64 query rows each (BM = 128) of one
// head; key tiles of BN = 128 (BN = 64 when a head dim exceeds 128).
// Shared memory: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB at D 128,
// Q 48 KB + 2 x (K 24 KB + V 16 KB) = 128 KB at (192, 128), Q 64 KB +
// 2 x (K 32 KB + V 32 KB) = 192 KB at D 256: one CTA per SM.
//
// Head dims (D, Dv): (64, 64), (128, 128), (64, 128), (128, 64), (192, 128)
// (MLA, deepseek-v2-lite: qk 128 + 64 rope, v 128; D is three TMA boxes),
// (256, 256), and the reduced configs' (32, 32) and (64, 32) (reduced MLA:
// qk 48 zero-padded to 64 by the model, v 32).  A width under one 64-column
// box runs on the tiles of width 64 (tile_width): its tensor map is 32
// columns wide and its 64-column box reads columns 32..63 as zeros, so
// QK^T is unchanged, P V gives zeros past Dv, and only the store of `out`
// keeps to the true Dv.  The products do twice the work such a shape
// needs; no host-side copy pads anything.
// Layout: q [B, Sq, H, D], k [B, Sk, KV, D], v [B, Sk, KV, Dv], out
// [B, Sq, H, Dv], all contiguous.  Grid (H, B, ceil(Sq / 128)), the query
// tile reversed along z so that the longest causal tiles start first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int BM = 128;                 // query rows per CTA
constexpr int THREADS = 256;            // two warpgroups of 64 rows each
constexpr int BOX = 64;                 // TMA box width: 64 bf16 = 128 bytes

// The width of the shared-memory tiles for a head dim: whole boxes; a dim
// under one box takes one, zero-filled past the tensor by the tensor map.
constexpr int tile_width(int d) { return d < BOX ? BOX : d; }

enum MaskKind { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_WINDOW = 2 };

template <int D, int DV>
struct Tile {
    static constexpr int BN = (D > 128 || DV > 128) ? 64 : 128;
    // Every section is a whole number of 1024-byte swizzle atoms, so each
    // stays 1024-byte aligned.  A tile of width W is W / 64 boxes of
    // [rows][64] bf16, box after box.
    static constexpr uint32_t q_bytes = BM * D * 2;
    static constexpr uint32_t k_bytes = BN * D * 2;
    static constexpr uint32_t v_bytes = BN * DV * 2;
    static constexpr uint32_t q_off = 0;
    static constexpr uint32_t k_off = q_off + q_bytes;          // 2 stages
    static constexpr uint32_t v_off = k_off + 2 * k_bytes;      // 2 stages
    static constexpr uint32_t bar_off = v_off + 2 * v_bytes;    // 5 barriers
    static constexpr uint32_t bytes = bar_off + 64 + 1024;      // + alignment
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// D and DV are the tile widths; DV_OUT <= DV is the width of `out`.
template <int D, int DV, int DV_OUT>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ out, float* __restrict__ lse, int Sq,
                 int Sk, int H, int KV, int mask_kind, int window,
                 int q_offset, float scale_log2) {
    using T = Tile<D, DV>;
    constexpr int BN = T::BN;
    extern __shared__ unsigned char smem_raw[];
    // 128-byte swizzle wants 1024-byte aligned tiles.
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* Qs = reinterpret_cast<bf16*>(smem + T::q_off);
    bf16* Ks = reinterpret_cast<bf16*>(smem + T::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + T::v_off);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::bar_off);
    uint64_t* q_full = bars;
    uint64_t* k_full = bars + 1;         // [2]
    uint64_t* v_full = bars + 3;         // [2]

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int m0 = (gridDim.z - 1 - blockIdx.z) * BM;
    const int hk = h / (H / KV);
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int lane = tid % 32;
    // This thread's two rows (the accumulator layout in hopper.cuh).
    const int row0 = m0 + 64 * wg + 16 * ((tid / 32) % 4) + lane / 4;
    const int col_in = 2 * (lane % 4);

    // K/V tiles that any row of this CTA can see.
    int n_lo = 0;
    int n_hi = Sk;
    if (mask_kind != MASK_NONE) {
        n_hi = min(Sk, q_offset + m0 + BM);
        if (mask_kind == MASK_WINDOW) n_lo = max(0, q_offset + m0 - window + 1);
    }
    const int t_lo = n_lo / BN;
    const int n_tiles = max(0, (n_hi + BN - 1) / BN - t_lo);

    if (tid == 0) {
        for (int i = 0; i < 5; ++i) mbar_init(bars + i, 1);
        fence_barrier_init();
    }
    __syncthreads();

    auto load_kv = [&](int stage, int tile) {
        mbar_arrive_expect_tx(k_full + stage, T::k_bytes);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c)
            tma_load_4d(Ks + stage * BN * D + c * BN * BOX, &tk, k_full + stage,
                        c * BOX, hk, tile * BN, b);
        mbar_arrive_expect_tx(v_full + stage, T::v_bytes);
#pragma unroll
        for (int c = 0; c < DV / BOX; ++c)
            tma_load_4d(Vs + stage * BN * DV + c * BN * BOX, &tv,
                        v_full + stage, c * BOX, hk, tile * BN, b);
    };

    if (tid == 0 && n_tiles > 0) {
        mbar_arrive_expect_tx(q_full, T::q_bytes);
#pragma unroll
        for (int c = 0; c < D / BOX; ++c)
            tma_load_4d(Qs + c * BM * BOX, &tq, q_full, c * BOX, h, m0, b);
        load_kv(0, t_lo);
    }
    __syncwarp();

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};        // this thread's columns only
    // The CTA's first and last query positions: a key tile needs the mask
    // only where its edge crosses them.
    const int q_first = q_offset + m0;
    const int q_last = q_offset + m0 + BM - 1;

    if (n_tiles > 0) mbar_wait(q_full, 0);
    // This warpgroup's 64 rows of Q, box 0.
    const bf16* q_wg = Qs + wg * 64 * BOX;

    for (int i = 0; i < n_tiles; ++i) {
        const int stage = i & 1;
        const uint32_t parity = (i >> 1) & 1;  // each stage flips every 2nd tile
        const int n0 = (t_lo + i) * BN;
        if (tid == 0 && i + 1 < n_tiles) load_kv(stage ^ 1, t_lo + i + 1);
        __syncwarp();

        // S = Q K^T: 64 x BN per warpgroup, D / 16 steps of k16.
        float s[BN / 2];
        const bf16* k_st = Ks + stage * BN * D;
        mbar_wait(k_full + stage, parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const int box = kk / 4;
            const int sub = (kk % 4) * 16;      // 32 bytes per k16 step
            wgmma_ss<BN>(s,
                         desc_sw128(q_wg + box * BM * BOX + sub, 0, 1024),
                         desc_sw128(k_st + box * BN * BOX + sub, 0, 1024),
                         kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BN / 2>(s);

        // Online softmax on the registers, in the log2 domain.
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) s[x] *= scale_log2;
        const bool edge = n0 + BN > Sk ||
            (mask_kind != MASK_NONE && n0 + BN - 1 > q_first) ||
            (mask_kind == MASK_WINDOW && n0 <= q_last - window);
        if (edge) {
#pragma unroll
            for (int x = 0; x < BN / 2; ++x) {
                const int col = n0 + 8 * (x / 4) + col_in + (x & 1);
                const int qpos = q_offset + row0 + ((x & 2) ? 8 : 0);
                bool ok = col < Sk;
                if (mask_kind != MASK_NONE) ok = ok && col <= qpos;
                if (mask_kind == MASK_WINDOW) ok = ok && col > qpos - window;
                if (!ok) s[x] = -INFINITY;
            }
        }
        float corr[2];
        float base[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
                mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_run[r], mx);
            // A row with no visible key so far keeps m = -inf; subtract 0
            // then, so that exp2(-inf) = 0 everywhere instead of NaN.
            base[r] = m_new == -INFINITY ? 0.f : m_new;
            corr[r] = ex2(m_run[r] - base[r]);
            m_run[r] = m_new;
        }
        float psum[2] = {0.f, 0.f};
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) {
            const int r = (x >> 1) & 1;
            s[x] = ex2(s[x] - base[r]);
            psum[r] += s[x];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + psum[r];
#pragma unroll
        for (int x = 0; x < DV / 2; ++x) o[x] *= corr[(x >> 1) & 1];
        // P as bf16 A fragments: k16 slice kk is S's 8-column blocks 2kk
        // and 2kk + 1, i.e. s[8kk .. 8kk + 7] in order.
        uint32_t p[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);

        // O += P V: V is [keys, Dv] with Dv contiguous, an MN-major B
        // operand (transposed); atoms of 64 Dv columns are one box apart.
        const bf16* v_st = Vs + stage * BN * DV;
        mbar_wait(v_full + stage, parity);
        fence_regs<DV / 2>(o);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) fence_regs<4>(p[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
            wgmma_rs<DV>(o, p[kk],
                         desc_sw128(v_st + kk * 16 * BOX, BN * BOX * 2, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<DV / 2>(o);
        __syncthreads();                  // every warp is done with the stage
    }

    // Epilogue: the quad's partial sums, then O / max(l, 1e-30) as bf16.
    float inv[2];
    float l_tot[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l_tot[r] = fmaxf(l, 1e-30f);
        inv[r] = 1.f / l_tot[r];
    }
    // The backward's lse (training only): natural log of the scaled
    // logits' sum of exponentials, (m + log2 l) ln 2 from the log2 domain;
    // a row that sees no key gets -1e30 (the reference's -1e30 + log(1e-30)
    // in fp32), so that the backward gives it zero gradient.
    if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            if (row >= Sq) continue;
            lse[((long long)b * Sq + row) * H + h] = m_run[r] == -INFINITY
                ? -1e30f
                : (m_run[r] + log2f(l_tot[r])) * 0.6931471805599453f;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Sq) continue;
        bf16* orow =
            out + ((long long)(b * Sq + row) * H + h) * DV_OUT + col_in;
#pragma unroll
        for (int j = 0; j < DV_OUT / 8; ++j) {
            *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(
                o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        }
    }
}

// ------------------------------------------------------------------- host
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

// Rank-4 map over a contiguous [batch, seq, heads, width] bf16 tensor,
// boxes of 64 columns x `rows` positions of one head of one batch, 128-byte
// swizzled; positions past `seq`, and columns past a `width` under the box,
// read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int width, int heads,
                     int seq, int batch, int rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t e = sizeof(bf16);
    const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                                (cuuint64_t)seq, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {width * e, (cuuint64_t)heads * width * e,
                                   (cuuint64_t)seq * heads * width * e};
    const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// (D, Dv) are the tensors' head dims; the kernel runs on tiles of
// tile_width(D) and tile_width(Dv) columns.
template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Sq, int Sk, int H, int KV,
                   int mask_kind, int window, int q_offset, float scale,
                   cudaStream_t stream) {
    constexpr int TD = tile_width(D), TDV = tile_width(DV);
    using T = Tile<TD, TDV>;
    if (Sk == 0)   // no key anywhere: every row is 0
        return cudaMemsetAsync(out, 0, (size_t)B * Sq * H * DV * sizeof(bf16),
                               stream);
    CUtensorMap tq, tk, tv;
    cudaError_t err = make_map(&tq, q, D, H, Sq, B, BM);
    if (err == cudaSuccess) err = make_map(&tk, k, D, KV, Sk, B, T::BN);
    if (err == cudaSuccess) err = make_map(&tv, v, DV, KV, Sk, B, T::BN);
    if (err != cudaSuccess) return err;
    auto kern = flash_fwd_kernel<TD, TDV, DV>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)T::bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(H, B, (Sq + BM - 1) / BM);
    kern<<<grid, THREADS, T::bytes, stream>>>(
        tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), Sq,
        Sk, H, KV, mask_kind, window, q_offset, scale * 1.4426950408889634f);
    return cudaGetLastError();
}

}  // namespace

// `lse` ([B, Sq, H] fp32) may be null: serving asks for none.  With Sk = 0
// only `out` is written (zeros); the wrapper fills `lse` then.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int B, int Sq, int Sk,
                                   int H, int KV, int D, int Dv, int mask_kind,
                                   int window, int q_offset, float scale,
                                   int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (D == 128 && Dv == 128)
        return (int)launch<128, 128>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                     mask_kind, window, q_offset, scale, st);
    if (D == 64 && Dv == 64)
        return (int)launch<64, 64>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                   mask_kind, window, q_offset, scale, st);
    if (D == 128 && Dv == 64)
        return (int)launch<128, 64>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                    mask_kind, window, q_offset, scale, st);
    if (D == 64 && Dv == 128)
        return (int)launch<64, 128>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                    mask_kind, window, q_offset, scale, st);
    if (D == 192 && Dv == 128)   // MLA (deepseek-v2-lite); 128 KB
        return (int)launch<192, 128>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                     mask_kind, window, q_offset, scale, st);
    if (D == 256 && Dv == 256)   // recurrentgemma; 192 KB of shared memory
        return (int)launch<256, 256>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                     mask_kind, window, q_offset, scale, st);
    if (D == 32 && Dv == 32)     // the reduced configs, on (64, 64) tiles
        return (int)launch<32, 32>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                   mask_kind, window, q_offset, scale, st);
    if (D == 64 && Dv == 32)     // reduced MLA (qk 48 padded to 64)
        return (int)launch<64, 32>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                   mask_kind, window, q_offset, scale, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
