// Fused SIREN decode: N networks evaluated at x = r / (T-1), r < S, in one
// launch (T = S, or the caller's total_len >= S: coordinates pinned to a
// cache's final length), their weights dense fp32 or group-quantized codes that are
// dequantized as they are staged.
//
// Replaces: nerf_attention_tpu/ops/siren_pallas.py, siren_decode_fused
// (_siren_kernel, kernel 2B) and siren_decode_batch (_siren_batch_kernel,
// kernel 2C), and nerf_attention_tpu/ops/siren_quant_pallas.py,
// siren_decode_batch_quant (_decode_quant_kernel via _decode_batch_quant_jit,
// kernel 2E). 2B is the N = 1 call on dense weights, 2C the dense call, 2E
// the call on packed weights (ops/siren_quant_cuda.py).
//
// What bounds it on an H100: arithmetic. Per row a network costs
// 2 * (H + (L-2) * H^2 + H * D) flops and (L-1) * H sines; for the medium
// config over N = 40 nets at S = 2048 that is 26.9 GFLOP against 26 MB of
// weights and 42 MB of output. On the tensor cores in TF32 (495 TFLOP/s) that
// is 0.054 ms, three passes of it 0.16 ms; the weights each tile streams from
// L2 (0.66 MB per tile for medium: 5 KB a row at 128 rows a tile) come next.
//
// What the design does about it: a block owns one (network, chunk of row
// tiles) cell, one tile but for wide nets, whose blocks each hold two
// activation buffers in device scratch; positions are made in the block, so
// nothing is read but the weights. Each tile runs through siren_common.cuh's
// net_tile: activations in shared memory (but for a wide tile's), every
// product on the tensor cores in 3xTF32 against weight slabs
// that all 16 warps share, sines in the products' epilogues. Tiles are as
// large as shared memory, the accumulators and the card's fill allow (the
// wrapper's choice, 16 to 128 rows). The final layer writes straight to the
// output; rows past S are not stored. Packed weights are dequantized once
// per slab (code x scale rounded once in fp32), so 2E on packed weights
// equals 2C on the host-dequantized weights bit for bit.
//
// bf16 mode (2B and 2C with compute_dtype=bfloat16, as the JAX kernels take
// it) of nets wider than 256 (ops/siren_cuda.py:bf16_route; narrower ones take
// siren_decode_bf16.cu): siren_common.cuh's bf16 stack, one m16n8k16 pass a
// product, the output written as bf16; the weights stream from L2 as fp32.
// 2E's bf16 mode (siren_quant_pallas.py:_decode_quant_kernel, whose packed
// weights reach the products as fp32) is the ACT16 stack: the fp32 path's
// products on activations rounded to bf16, the output written as bf16; its
// records may be packed or dense.

#ifndef SIREN_PART
#error "define SIREN_PART (0 or 1): ops/_build.py builds this library in two parts"
#endif

#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

#include "siren_common.cuh"

using namespace siren;

template <int MI, int NI, bool WIDE, bool FAST, int PREC>
__global__ void __launch_bounds__(kThreads) siren_decode_kernel(const __grid_constant__ NetDesc net, int L,
                                                                const float* __restrict__ mult,
                                                                void* __restrict__ out_, float* scratch, int S,
                                                                float xden, const __grid_constant__ StackShape sh,
                                                                float omega, int tiles_per_chunk) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* stages = smem + (WIDE ? 0 : sh.rows * sh.lda);
    float* xs = stages + kStages * sh.stage_floats();
    float* act = WIDE ? scratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * sh.scratch_floats() : smem;

    const int n = blockIdx.y;
    const int n_tiles = (S + sh.rows - 1) / sh.rows;
    const int lo = blockIdx.x * tiles_per_chunk;
    const int hi = min(lo + tiles_per_chunk, n_tiles);
    __shared__ SlabSrc srcs[2 * kMaxLayers];
    SlabRing ring(&net, &net, 1, L, n, max(hi - lo, 0), sh, stages, srcs);
    const size_t o = (size_t)n * S * sh.D;
    for (int ti = lo; ti < hi; ++ti) {
        const int t0 = ti * sh.rows;
        __syncthreads();  // the last tile is done with xs
        if (threadIdx.x < sh.rows) xs[threadIdx.x] = (float)(t0 + threadIdx.x) / xden;
        __syncthreads();
        net_tile<MI, NI, WIDE, FAST, PREC>(ring, net, L, n, sh, xs, mult, omega, act, act + sh.rows * sh.lda,
                                           [&](int r, int j, float y) {
                                               const int row = t0 + r;
                                               if (row >= S) return;
                                               const size_t e = o + (size_t)row * sh.D + j;
                                               if (PREC != kF32) {
                                                   static_cast<__nv_bfloat16*>(out_)[e] = __float2bfloat16_rn(y);
                                               } else {
                                                   static_cast<float*>(out_)[e] = y;
                                               }
                                           });
    }
}

// The stack's shape for hidden width H, out width D and `rows` rows a tile
// (slabs of at least 16 rows with bf16 products: one k16 step), and its shared-memory
// bytes, 0 when the tile does not take these widths or does not fit.
static StackShape decode_shape(int H, int D, int rows, int prec) {
    return stack_shape(H, D, rows, rows, prec == kBF16 ? 16 : 8);
}

static int smem_bytes(const StackShape& sh) { return sh.sk > 0 ? (sh.floats() + sh.rows) * (int)sizeof(float) : 0; }

// The kernel instance of one tile kind: sets its shared-memory size, then
// either stores how many of its blocks one SM holds (per_sm not null) or
// launches it. Returns a CUDA error.
template <int KIND, bool FAST, int PREC>
static int run(int smem, int* per_sm, dim3 grid, const NetDesc& net, int L, const float* mult, void* out,
               float* scratch, int S, float xden, const StackShape& sh, float omega, int tiles_per_chunk,
               cudaStream_t st) {
    const auto kernel = siren_decode_kernel<tile_mi(KIND), tile_ni(KIND), KIND == kTileWide, FAST, PREC>;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm != nullptr) return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
    kernel<<<grid, kThreads, smem, st>>>(net, L, mult, out, scratch, S, xden, sh, omega, tiles_per_chunk);
    return (int)cudaGetLastError();
}

template <bool FAST, int PREC, typename... Args>
static int run_kind(int kind, Args... args) {
    switch (kind) {
        case kTile128: return run<kTile128, FAST, PREC>(args...);
        case kTile64: return run<kTile64, FAST, PREC>(args...);
        case kTile16: return run<kTile16, FAST, PREC>(args...);
        default: return run<kTileWide, FAST, PREC>(args...);
    }
}

// The instance for the arithmetic (prec, a Precision) and the sine.
template <bool FAST, typename... Args>
static int run_prec(int prec, int kind, Args... args) {
    if (prec == kBF16) return run_kind<FAST, kBF16>(kind, args...);
    if (prec == kAct16) return run_kind<FAST, kAct16>(kind, args...);
    return run_kind<FAST, kF32>(kind, args...);
}

// The library is built in two parts that compile at once (SIREN_PART, ops/_build.py's PARTS): part 0
// holds the exact-sine kernel instances and the entry points, part 1 the fast-sine instances behind run_fast.
__attribute__((visibility("hidden"))) int run_fast(int prec, int kind, int smem, int* per_sm, dim3 grid,
                                                   const NetDesc& net, int L, const float* mult, void* out,
                                                   float* scratch, int S, float xden, const StackShape& sh,
                                                   float omega, int tiles_per_chunk, cudaStream_t st);

#if SIREN_PART == 1
int run_fast(int prec, int kind, int smem, int* per_sm, dim3 grid, const NetDesc& net, int L, const float* mult,
             void* out, float* scratch, int S, float xden, const StackShape& sh, float omega, int tiles_per_chunk,
             cudaStream_t st) {
    return run_prec<true>(prec, kind, smem, per_sm, grid, net, L, mult, out, scratch, S, xden, sh, omega,
                          tiles_per_chunk, st);
}
#endif

#if SIREN_PART == 0
// The instance for the sine (fast) and the arithmetic (prec, a Precision).
template <typename... Args>
static int run_mode(int fast, int prec, int kind, Args... args) {
    return fast ? run_fast(prec, kind, args...) : run_prec<false>(prec, kind, args...);
}

// How many blocks of this shape one SM holds (0 for a shape the kernel does
// not take) with the arithmetic prec (a Precision). Returns a CUDA error.
extern "C" int siren_decode_blocks_per_sm(int H, int D, int rows, int fast, int prec, int* per_sm) {
    const StackShape sh = decode_shape(H, D, rows, prec);
    const int smem = smem_bytes(sh);
    *per_sm = 0;
    if (smem == 0) return 0;
    const NetDesc net{};
    return run_mode(fast, prec, sh.kind, smem, per_sm, dim3(), net, 0, nullptr, nullptr, nullptr, 0, 1.f, sh, 0.f,
                    0, cudaStream_t{});
}

// Device-memory floats each block of this shape needs as scratch (0 but
// for a wide tile, whose activations live there).
extern "C" int siren_decode_scratch_floats(int H, int D, int rows) {
    return decode_shape(H, D, rows, 0).scratch_floats();
}

// desc: L LayerDesc records (13 int64 each; layer 0 dense fp32, layers
// 1..L-2 (H, H), layer L-1 (H, D)); mult: (H,) fp32 or null; prec: a
// Precision; out: (N, S, D) fp32 with kF32, else bf16 (with kBF16 every
// record dense: that mode rounds weights, which no packed kernel of the JAX
// package does); scratch: N * chunks *
// siren_decode_scratch_floats fp32, or null when that is 0. tile_rows: 16, 32,
// 64 or 128, one that siren_decode_blocks_per_sm finds resident in this mode;
// chunks * tiles_per_chunk * tile_rows >= S. total_len: 0 for positions
// r / (S - 1), else T >= S for r / (T - 1). Returns cudaGetLastError() after
// the launch.
extern "C" int siren_decode_launch(const long long* desc, int L, const float* mult, void* out, float* scratch, int N,
                                   int S, int total_len, int H, int D, float omega, int fast, int prec, int tile_rows,
                                   int chunks, int tiles_per_chunk, void* stream) {
    NetDesc net{};
    if (L < 2 || L > kMaxLayers || N < 1 || N > 65535 || S < 1 || (total_len != 0 && total_len < S))
        return (int)cudaErrorInvalidValue;
    const float xden = (float)std::max((total_len != 0 ? total_len : S) - 1, 1);
    std::memcpy(net.layer, desc, sizeof(LayerDesc) * L);
    const StackShape sh = decode_shape(H, D, tile_rows, prec);
    if (prec < kF32 || prec > kAct16 || !net_ok(net, L) || sh.sk == 0 || (sh.wide() && scratch == nullptr) ||
        (long long)chunks * tiles_per_chunk * sh.rows < S)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; prec == kBF16 && i < L; ++i)
        if (net.layer[i].kind != kDense) return (int)cudaErrorInvalidValue;
    return run_mode(fast, prec, sh.kind, smem_bytes(sh), nullptr, dim3(chunks, N), net, L, mult, out, scratch, S,
                    xden, sh, omega, tiles_per_chunk, (cudaStream_t)stream);
}

extern "C" const char* error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
#endif
