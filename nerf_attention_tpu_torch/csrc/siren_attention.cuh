// Attention straight from SIREN parameters: per head, O = softmax(q K^T / sqrt(D)) V
// with K and V rebuilt tile by tile from a key net and a value net, never stored.
//
// Replaces: nerf_attention_tpu/ops/siren_attention_pallas.py,
// siren_attention_decode_fused (_attn_kernel, kernel 2D), and
// nerf_attention_tpu/ops/siren_quant_pallas.py, _attn_quant_jit
// (_attn_quant_kernel, kernel 2F): one kernel, whose weight loads go through
// a loader per layer, dense fp32 (2D) or group-quantized int8 / int6 / int4
// codes times their fp16-valued scale (2F).
//
// What bounds it on an H100: arithmetic. Rebuilding one row of K and one of
// V costs two network forwards, 2 * 2 * (H + (L-2) H^2 + H D) flops (0.66
// MFLOP for the medium config); the attention itself adds 4 T D per row. At
// S = 2048 and 8 heads that is 10.7 GFLOP against 10.5 MB of fp32 weights:
// 0.022 ms on the tensor cores in TF32, 0.065 ms as three passes. Quantized
// weights cut the bytes but not the products.
//
// What the design does about it: a block owns one (head, chunk of row
// tiles) cell; the chunk count fills the card's SMs in whole waves. For each
// tile of up to 128 rows the block runs the key net through siren_common.cuh's
// net_tile (activations in shared memory, or for wide nets in a scratch area
// of device memory per block, every product on the tensor cores
// in 3xTF32 against weight slabs all warps share, streamed through one ring
// across both nets and every tile of the chunk, sines in the epilogues),
// denormalizes its output into a (rows x D) tile in the activation buffer
// (a tile of its own in shared memory for wide nets) and takes the scores, then runs the value net into the same tile and
// folds it into the online softmax (attn_common.cuh). K and V never reach
// device memory. Each block writes its chunk's (m, l, acc); a second kernel
// merges the chunks in order. Quantized weights are dequantized once per
// slab: code * scale rounded once in fp32 (__fmul_rn), the product
// ops/quantize.py takes on the host, so 2F on packed weights equals 2D on the
// host-dequantized weights bit for bit.
//
// bf16 modes (compute_dtype=bfloat16 in the JAX kernels): 2D's rounds the
// weights, biases and activations of both nets (siren_common.cuh's kBF16
// stack, siren_attention_pallas.py:_flat_weights), 2F's only the activations
// (kAct16: its packed weights reach the products as fp32,
// siren_quant_pallas.py:_QuantWeightView). Both keep q.k and the softmax in
// fp32 and round p and V to bf16 before p.V, with fp32 sums
// (attn_common.cuh's acc_update<true>); the output stays fp32. 2F in bf16 on
// packed weights equals 2F in bf16 on the host-dequantized weights as dense
// records bit for bit, as the fp32 modes do.
//
// One library per arithmetic: siren_attention.cu (fp32), siren_attention_bf16.cu
// (2D's bf16 mode) and siren_attention_act16.cu (2F's) each define
// SIREN_ATTENTION_PREC and include this header, so the three build in
// parallel (one library of all three modes took 344 s to compile for the H100).
#pragma once

#ifndef SIREN_ATTENTION_PREC
#error "define SIREN_ATTENTION_PREC (a siren::Precision) before including siren_attention.cuh"
#endif
#ifndef SIREN_PART
#error "define SIREN_PART (0 or 1): ops/_build.py builds this library in two parts"
#endif

#include <cuda_runtime.h>

#include <cstring>

// 8 warps a block: against 16, its extra state and steps beside the stack
// fit the registers without spilling, and the attention ladder ran faster.
#define SIREN_STACK_THREADS 256

#include "attn_common.cuh"
#include "siren_common.cuh"

using namespace siren;

// The attention state beside the stack: the queries, the softmax state, xs
// and, on a wide tile, the kv tile (rows x kv_ld). Otherwise the kv tile
// lives in the activation buffer, whose row stride covers max(Hp, Dp): a
// net's final epilogue writes it once every warp has read the last
// activations, and the next net's layer 0 overwrites it.
__host__ __device__ constexpr int kv_ld(int D) { return (D + kOutMult - 1) / kOutMult * kOutMult + 4; }

__host__ __device__ constexpr int attn_floats(int T, int D, int rows, bool wide) {
    return T * D + attn::state_floats(T, D, rows) + rows + (wide ? rows * kv_ld(D) : 0);
}

// The stack's shape beside the attention state (T queries, widths H and D,
// `rows` rows a tile, the arithmetic prec: slabs at least 16 deep for bf16 products).
static StackShape attn_shape(int T, int H, int D, int rows, int prec) {
    const int min_sk = prec == kBF16 ? 16 : 8;
    const StackShape sh = stack_shape(H, D, rows, attn_floats(T, D, rows, false), min_sk);
    return sh.wide() ? stack_shape(H, D, rows, attn_floats(T, D, rows, true), min_sk) : sh;
}

template <int MI, int NI, bool WIDE, bool FAST, int PREC>
__global__ void __launch_bounds__(kThreads) siren_attention_kernel(
    const __grid_constant__ NetDesc knet, const __grid_constant__ NetDesc vnet, int L,
    const float* __restrict__ k_mean, const float* __restrict__ k_std, const float* __restrict__ v_mean,
    const float* __restrict__ v_std, const float* __restrict__ q, const float* __restrict__ mult,
    float* __restrict__ part_ml, float* __restrict__ part_acc, float* scratch, int S, int T,
    const __grid_constant__ StackShape sh, float omega, float q_scale, int causal, int tiles_per_chunk) {
    extern __shared__ float4 smem4[];
    const int rows = sh.rows;
    const int D = sh.D;
    float* smem = reinterpret_cast<float*>(smem4);
    float* stages = smem + (WIDE ? 0 : rows * sh.lda);
    float* qs = stages + kStages * sh.stage_floats();
    const attn::State st = attn::carve_state(qs + T * D, T, D, rows);
    float* xs = st.sc + T * rows;
    float* act = WIDE ? scratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * sh.scratch_floats() : smem;
    float* kv = WIDE ? xs + rows : act;  // the denormalized K or V tile
    const int ld = WIDE ? kv_ld(D) : sh.lda;

    const int n = blockIdx.y;
    const int c = blockIdx.x;
    const int n_tiles = (S + rows - 1) / rows;
    const int lo = c * tiles_per_chunk;
    const int hi = min(lo + tiles_per_chunk, n_tiles);
    __shared__ SlabSrc srcs[2 * kMaxLayers];
    SlabRing ring(&knet, &vnet, 2, L, n, max(hi - lo, 0), sh, stages, srcs);
    const float* km = k_mean + (size_t)n * D;
    const float* ks = k_std + (size_t)n * D;
    const float* vm = v_mean + (size_t)n * D;
    const float* vs = v_std + (size_t)n * D;
    for (int e = threadIdx.x; e < T * D; e += blockDim.x) qs[e] = q[(size_t)n * T * D + e] * q_scale;
    st.init(T, D);

    const float xden = (float)max(S - 1, 1);
    for (int ti = lo; ti < hi; ++ti) {
        const int t0 = ti * rows;
        __syncthreads();  // the last tile's readers of act are done
        if (threadIdx.x < rows) xs[threadIdx.x] = (float)(t0 + threadIdx.x) / xden;
        __syncthreads();
        net_tile<MI, NI, WIDE, FAST, PREC>(ring, knet, L, n, sh, xs, mult, omega, act, act + rows * sh.lda,
                                     [&](int r, int j, float y) { kv[r * ld + j] = y * ks[j] + km[j]; });
        __syncthreads();
        // Query row t sits at position S - T + t; causal rows see positions <= theirs.
        attn::scores(qs, kv, ld, T, D, rows, 1.f, [&](int t, int r) {
            return causal ? t0 + r <= S - T + t : t0 + r < S;
        }, st.sc);
        __syncthreads();  // the scores have read K
        net_tile<MI, NI, WIDE, FAST, PREC>(ring, vnet, L, n, sh, xs, mult, omega, act, act + rows * sh.lda,
                                     [&](int r, int j, float y) { kv[r * ld + j] = y * vs[j] + vm[j]; });
        attn::softmax_update_rows(st, T, rows);
        __syncthreads();
        attn::acc_update<PREC != kF32>(st, kv, ld, T, D, rows);
    }
    __syncthreads();
    const size_t cell = (size_t)n * gridDim.x + c;
    attn::write_partial(st, T, D, part_ml + cell * T * 2, part_acc + cell * T * D);
}

// Shared-memory bytes of a block (T queries, widths H and D, `rows` rows a
// tile, arithmetic prec); 0 when the tile does not take these widths or does not fit.
static int smem_bytes(int T, int H, int D, int rows, int prec) {
    const StackShape sh = attn_shape(T, H, D, rows, prec);
    return sh.sk > 0 ? (sh.floats() + attn_floats(T, D, rows, sh.wide())) * (int)sizeof(float) : 0;
}

// The launch arguments of the kernel, one struct so that the host code can
// hand them through the tile-kind dispatch.
struct Args {
    const NetDesc *knet, *vnet;
    int L;
    const float *k_mean, *k_std, *v_mean, *v_std, *q, *mult;
    float *part_ml, *part_acc, *scratch;
    int S, T;
    StackShape sh;
    float omega, q_scale;
    int causal, tiles_per_chunk;
};

// The kernel instance of one tile kind: sets its shared-memory size, then
// either stores how many of its blocks one SM holds (per_sm not null) or
// launches it. Returns a CUDA error.
template <int KIND, bool FAST, int PREC>
static int run(int smem, int* per_sm, dim3 grid, const Args& a, cudaStream_t st) {
    const auto kernel = siren_attention_kernel<tile_mi(KIND), tile_ni(KIND), KIND == kTileWide, FAST, PREC>;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm != nullptr) return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
    kernel<<<grid, kThreads, smem, st>>>(*a.knet, *a.vnet, a.L, a.k_mean, a.k_std, a.v_mean, a.v_std, a.q, a.mult,
                                         a.part_ml, a.part_acc, a.scratch, a.S, a.T, a.sh, a.omega, a.q_scale, a.causal,
                                         a.tiles_per_chunk);
    return (int)cudaGetLastError();
}

template <bool FAST, int PREC>
static int run_kind(int kind, int smem, int* per_sm, dim3 grid, const Args& a, cudaStream_t st) {
    switch (kind) {
        case kTile128: return run<kTile128, FAST, PREC>(smem, per_sm, grid, a, st);
        case kTile64: return run<kTile64, FAST, PREC>(smem, per_sm, grid, a, st);
        case kTile16: return run<kTile16, FAST, PREC>(smem, per_sm, grid, a, st);
        default: return run<kTileWide, FAST, PREC>(smem, per_sm, grid, a, st);
    }
}

// The library is built in two parts that compile at once (SIREN_PART, ops/_build.py's PARTS): part 0
// holds the exact-sine kernel instances and the entry points, part 1 the fast-sine instances behind run_fast.
__attribute__((visibility("hidden"))) int run_fast(int kind, int smem, int* per_sm, dim3 grid, const Args& a,
                                                   cudaStream_t st);

#if SIREN_PART == 1
int run_fast(int kind, int smem, int* per_sm, dim3 grid, const Args& a, cudaStream_t st) {
    return run_kind<true, SIREN_ATTENTION_PREC>(kind, smem, per_sm, grid, a, st);
}
#endif

#if SIREN_PART == 0
static int run_sine(int fast, int kind, int smem, int* per_sm, dim3 grid, const Args& a, cudaStream_t st) {
    return fast ? run_fast(kind, smem, per_sm, grid, a, st)
                : run_kind<false, SIREN_ATTENTION_PREC>(kind, smem, per_sm, grid, a, st);
}

// How many blocks of this shape one SM holds with the arithmetic prec, which must be this library's
// SIREN_ATTENTION_PREC. Returns a CUDA error.
extern "C" int siren_attention_blocks_per_sm(int T, int H, int D, int rows, int fast, int prec, int* per_sm) {
    *per_sm = 0;
    if (prec != SIREN_ATTENTION_PREC) return (int)cudaErrorInvalidValue;
    const int smem = smem_bytes(T, H, D, rows, prec);
    if (smem == 0) return 0;
    return run_sine(fast, attn_shape(T, H, D, rows, prec).kind, smem, per_sm, dim3(), Args{}, cudaStream_t{});
}

// Device-memory floats each block of this shape needs as scratch (0 but
// for a wide tile, whose activations live there; the same in every mode).
extern "C" int siren_attention_scratch_floats(int T, int H, int D, int rows) {
    return attn_shape(T, H, D, rows, kF32).scratch_floats();
}

// k_desc, v_desc: L LayerDesc records (13 int64 each). k_mean .. v_std:
// (N, D) fp32; q: (N, T, D) fp32; mult: (H,) fp32 or null. part_ml
// (N, chunks, T, 2) and part_acc (N, chunks, T, D) are scratch, and so is
// scratch, N * chunks * siren_attention_scratch_floats fp32 (null when that
// is 0); out (N, T, D); m_out, l_out (N, T) or null. prec: this library's
// SIREN_ATTENTION_PREC (kBF16 for 2D's bf16 mode, kAct16 for 2F's). rows: 16, 32, 64 or 128, one that
// siren_attention_blocks_per_sm finds resident in that mode; chunks * tiles_per_chunk * rows >= S.
// Returns cudaGetLastError() after both launches.
extern "C" int siren_attention_launch(const long long* k_desc, const long long* v_desc, int L,
                                      const float* k_mean, const float* k_std, const float* v_mean,
                                      const float* v_std, const float* q, const float* mult,
                                      float* part_ml, float* part_acc, float* scratch, float* out, float* m_out,
                                      float* l_out, int N, int S, int T, int H, int D, float omega,
                                      float q_scale, int fast, int prec, int causal, int rows, int chunks,
                                      int tiles_per_chunk, void* stream) {
    if (L < 2 || L > kMaxLayers || N < 1 || N > 65535 || S < 1 || prec != SIREN_ATTENTION_PREC)
        return (int)cudaErrorInvalidValue;
    NetDesc knet{}, vnet{};
    std::memcpy(knet.layer, k_desc, sizeof(LayerDesc) * L);
    std::memcpy(vnet.layer, v_desc, sizeof(LayerDesc) * L);
    const StackShape sh = attn_shape(T, H, D, rows, prec);
    if (!net_ok(knet, L) || !net_ok(vnet, L) || sh.sk == 0 || (sh.wide() && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int smem = (sh.floats() + attn_floats(T, D, rows, sh.wide())) * (int)sizeof(float);
    const Args a{&knet, &vnet, L, k_mean, k_std, v_mean, v_std, q, mult, part_ml, part_acc, scratch, S, T, sh,
                 omega, q_scale, causal, tiles_per_chunk};
    const int err = run_sine(fast, sh.kind, smem, nullptr, dim3(chunks, N), a, st);
    if (err != 0) return err;
    attn::merge_chunks_kernel<<<N, attn::kThreads, 0, st>>>(part_ml, part_acc, out, m_out, l_out,
                                                            chunks, T, D);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
#endif
