// Kernel 2E's bf16 mode on Hopper: N networks over packed (or dense) fp32 weights evaluated at x = r / (S - 1),
// r < S, in one launch, every hidden and final product three wgmma bf16 chains on ready bf16 pieces of the
// weights, the sine epilogue on the accumulators in registers, a bf16 output.
//
// Replaces: nerf_attention_tpu/ops/siren_quant_pallas.py, _decode_batch_quant_jit (kernel _decode_quant_kernel)
// with compute_dtype=bfloat16: its weight views hand _layer_stack fp32 values (_QuantWeightView), so layer 0 is
// fp32 (x * w0 + b0, times omega and the FM multiplier, the fp32 sine, rounded to bf16), every hidden and final
// product is the fp32 product of bf16 activations and fp32 weights plus the fp32 bias, each hidden activation is
// rounded to bf16 after its fp32 sine, and the output is rounded to bf16. Nets up to kMaxWidth wide (hidden and
// output, multiples of 4) take this kernel; others keep the layer stack's ACT16 instance (siren_decode.cu), by the
// wrapper's width rule (ops/siren_cuda.py:bf16_route).
//
// The design is 2B/2C's bf16 kernel (siren_decode_bf16.cu) with siren_wgmma.cuh's ACT16 arithmetic: split_kernel
// first writes every net's weights as three bf16 pieces (w3, w2, w1) in wgmma's B layout, once a launch; then a
// block of three warpgroups owns a (net, chunk of 128-row tiles) cell, its producer thread copying ready pieces
// (8 KB bulk copies, by its four warps) through a ring of kAct16Stages pieces, its two consumer warpgroups (64 rows each) running layer 0
// in SIMT and each product as three chains into one accumulator set, the epilogue in registers. Every sum is taken
// in one fixed order (w3's chain, w2's, w1's, each k ascending), so two runs give the same bits, and packed weights
// give the bits of their host-dequantized values shipped dense.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "siren_wgmma.cuh"

namespace bf16wg {

constexpr int kAct16Stages = 24;  // two 256-wide chunks' pieces (3 splits x 4 k atoms each)
constexpr int kAct16BarOff = kAct16Stages * kStageBytes;
constexpr int kAct16BiasOff = kAct16BarOff + 2 * kAct16Stages * 8;

// Shared-memory bytes of a block for L layers: the ring, its barriers, the fp32 biases of every layer, layer 0's
// weights and scales, and room to align the ring to 1024 bytes.
inline int act16_decode_smem(int L) { return kAct16BiasOff + (L + 2) * kMaxWidth * 4 + 1024; }

// mult: (H,) fp32 FM multipliers or null; pieces: split_kernel's; out: (N, S, D) bf16. A block takes tiles
// [blockIdx.x * tiles_per_chunk, ...) of net blockIdx.y.
template <bool FAST>
__global__ void __launch_bounds__(kThreads, 1) decode_act16_kernel(const __grid_constant__ NetDesc net, int L,
                                                                   const float* __restrict__ mult,
                                                                   const unsigned char* __restrict__ pieces,
                                                                   __nv_bfloat16* __restrict__ out, int S,
                                                                   float xden, int H, int D, float omega,
                                                                   int tiles_per_chunk) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + kAct16BarOff);
    uint64_t* empty = full + kAct16Stages;
    const int n = blockIdx.y;
    const int n_tiles = (S + kRows - 1) / kRows;
    const int t_lo = blockIdx.x * tiles_per_chunk, t_hi = min(t_lo + tiles_per_chunk, n_tiles);
    const int KA = (H + kPiece - 1) / kPiece, dch = (D + kPiece - 1) / kPiece;
    const int per_tile = pieces_per_net(H, D, L, kSplits);
    const int total = max(t_hi - t_lo, 0) * per_tile;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kAct16Stages; ++s) {
            mbar_init(full + s, 1);   // the stage's producer warp, with its copy's bytes
            mbar_init(empty + s, 8);  // lane 0 of each consumer warp after its group
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    float* bias = reinterpret_cast<float*>(smem + kAct16BiasOff);
    float* first_w = bias + L * kMaxWidth;
    float* first_sc = first_w + kMaxWidth;
    fill_net_tables<false>(net, n, L, H, bias, first_w);
    fill_scales(mult, H, omega, first_sc);
    __syncthreads();
    if (threadIdx.x < 128) {
        regs_dec<kProducerRegs>();
        const unsigned char* mine = pieces + (size_t)n * per_tile * kStageBytes;
        produce_ready<kAct16Stages>(total, smem, full, empty,
                                    [&](int p) { return mine + (size_t)(p % per_tile) * kStageBytes; });
    } else {
        regs_inc<kConsumerRegs>();
        const int lt = threadIdx.x % 128, lane = lt % 32;
        Consumer<FAST, kSplits, kAct16Stages, float> c{{bias, first_w, first_sc}, KA, KA, dch, lane, lane % 4,
                                                       omega, xden, smem_addr(smem), full, empty};
        DecodeOut<decltype(c)> to{c, out + (size_t)n * S * D, S, D};
        c.run(threadIdx.x / 128 - 1, lt / 32, lane / 4, L, t_lo, t_hi, to);
    }
}

template <bool FAST>
int launch(dim3 grid, const NetDesc& net, int L, const float* mult, const void* pieces, void* out, int S, float xden,
           int H, int D, float omega, int tiles_per_chunk, cudaStream_t st) {
    const auto kernel = decode_act16_kernel<FAST>;
    const int smem = act16_decode_smem(L);
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, st>>>(net, L, mult, static_cast<const unsigned char*>(pieces),
                                         static_cast<__nv_bfloat16*>(out), S, xden, H, D, omega, tiles_per_chunk);
    return (int)cudaGetLastError();
}

}  // namespace bf16wg

using namespace bf16wg;

// Bytes of the pieces area a launch over n_nets nets of these widths needs (split_kernel's output).
extern "C" long long siren_act16_pieces_bytes(int H, int D, int L, int n_nets) {
    return (long long)pieces_per_net(H, D, L, kSplits) * kStageBytes * n_nets;
}

// desc: L LayerDesc records (13 int64 each; dense fp32 or packed codes, layer 0 dense; layer 0 (1, H), layers
// 1..L-2 (H, H), layer L-1 (H, D)); mult: (H,) fp32 or null; pieces: siren_act16_pieces_bytes(H, D, L, N) of
// device memory (16-byte aligned), scratch the launch overwrites; out: (N, S, D) bf16. H and D multiples of 4, at
// most kMaxWidth. chunks * tiles_per_chunk * 128 >= S. Runs split_kernel, then the decode. Returns
// cudaGetLastError() after the launches.
extern "C" int siren_decode_act16_launch(const long long* desc, int L, const float* mult, void* pieces, void* out,
                                         int N, int S, int H, int D, float omega, int fast, int chunks,
                                         int tiles_per_chunk, void* stream) {
    NetDesc net{};
    if (L < 2 || L > siren::kMaxLayers || N < 1 || N > 65535 || S < 1 || chunks < 1 || tiles_per_chunk < 1 ||
        (long long)chunks * tiles_per_chunk * kRows < S || pieces == nullptr)
        return (int)cudaErrorInvalidValue;
    std::memcpy(net.layer, desc, sizeof(LayerDesc) * L);
    if (!act16_net_ok(net, L, H, D)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t err = split_launch<kSplits>(net, net, N, N, L, H, D, pieces, st);
    if (err != cudaSuccess) return (int)err;
    const float xden = (float)std::max(S - 1, 1);
    const dim3 grid(chunks, N);
    return fast ? launch<true>(grid, net, L, mult, pieces, out, S, xden, H, D, omega, tiles_per_chunk, st)
                : launch<false>(grid, net, L, mult, pieces, out, S, xden, H, D, omega, tiles_per_chunk, st);
}

extern "C" const char* error_string(int status) { return cudaGetErrorString((cudaError_t)status); }
