// Kernels 2F's and 2D's bf16 modes on Hopper: per head, O = softmax(q K^T / sqrt(D)) V with K and V rebuilt tile
// by tile from a key net and a value net, every hidden and final product wgmma bf16 chains on ready bf16 pieces of
// the weights (SPLITS a weight), the activations and the sine epilogue in registers.
//
// Replaces, with compute_dtype=bfloat16:
//   * nerf_attention_tpu/ops/siren_quant_pallas.py, _attn_quant_jit (kernel _attn_quant_kernel), over packed (or
//     dense) fp32 weights: both nets' stacks as 2E's bf16 mode (bf16 activations times fp32 weights, siren_wgmma.cuh's
//     ACT16 arithmetic: three pieces a weight, three chains a product);
//   * nerf_attention_tpu/ops/siren_attention_pallas.py, siren_attention_decode_fused (kernel _attn_kernel), over
//     dense fp32 weights: _flat_weights rounds both nets' W and b to bf16, so each product is one chain over w1 =
//     bf16(w), each bias and layer 0's row bf16-rounded (siren_wgmma.cuh's rounded arithmetic).
// Both then denormalize K and V in fp32 (y * std + mean), take q.k and the online softmax in fp32, round p and V to
// bf16 for p.V with fp32 sums (attn_common.cuh's acc_update<true>) and give an fp32 output, with (m, l) when asked.
// Nets up to kMaxWidth wide with D <= kMaxHeadDim and T <= kMaxQueries take this kernel; others keep the layer
// stack's instances (siren_attention_act16.cu, siren_attention_bf16.cu), by the wrappers' rule
// (ops/siren_attention_cuda.py:attention_route).
//
// The design. split_kernel first writes every key and value net's weights as SPLITS bf16 pieces in wgmma's B
// layout, once a launch. A block of three warpgroups owns one (head, chunk of 128-row tiles) cell: its producer
// thread copies ready pieces (8 KB bulk copies, by its four warps) through a ring of kAttnStages pieces, the key net's pieces of a
// tile, then the value net's; its two consumer warpgroups (64 rows each) run both nets on the same registers
// (siren_wgmma.cuh's Consumer). For each tile:
//
//   1. the key net's last layer, chunk by chunk: each accumulator plus its bias, denormalized (y * k_std + k_mean,
//      fp32), times the thread's columns of every query (q / sqrt(D) in shared memory), summed over the quad's
//      lanes by shuffles into the tile's score rows, chunk after chunk (-inf where the causal mask or the window's
//      end excludes a row). K never leaves registers;
//   2. the online softmax over the tile's 128 rows (attn_common.cuh, one warp a query);
//   3. the value net's last layer writes its denormalized rows rounded to bf16 into a (128, D + kVPad) tile;
//   4. acc += p . V on bf16-rounded p and V with fp32 sums, one thread per (query, column).
//
// A chunk's (m, l, acc) goes to device memory and attn::merge_chunks_kernel merges the chunks in order, as for
// the layer stack's attention kernel. Every sum is taken in one fixed order, so two runs give the same bits, and
// packed weights give the bits of their host-dequantized values shipped dense.
//
// Shared memory (AttnSmem): the ring (16 x 8 KB), both nets' fp32 bias tables and layer 0 rows (bf16-rounded
// values where the weights are rounded), the
// denormalization stats, the queries, the attention state and the V tile: 224 KB at L = 16, T = 16, D = 128.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "attn_common.cuh"
#include "siren_wgmma.cuh"

namespace bf16wg {

constexpr int kAttnStages = 16;
constexpr int kMaxQueries = 16;   // T: the partial scores a consumer thread keeps, two rows each
constexpr int kMaxHeadDim = 128;  // D: the V tile's columns
constexpr int kVPad = 8;          // bf16 past D in a V tile row: a warp's pair stores hit 32 distinct banks
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on an H100

// Byte offsets of a block's shared memory from its 1024-aligned base, for L layers, T queries, head width D.
struct AttnSmem {
    int bar, bias, first_w, first_sc, stats, qs, state, vt, total;
    __host__ __device__ AttnSmem(int L, int T, int D) {
        bar = kAttnStages * kStageBytes;
        bias = bar + 2 * kAttnStages * 8;                // key net's L rows of kMaxWidth, then the value net's
        first_w = bias + 2 * L * kMaxWidth * 4;          // key net's, then the value net's
        first_sc = first_w + 2 * kMaxWidth * 4;
        stats = first_sc + kMaxWidth * 4;                // k_mean, k_std, v_mean, v_std
        qs = stats + 4 * D * 4;
        state = qs + T * D * 4;
        vt = state + attn::state_floats(T, D, kRows) * 4;
        total = vt + kRows * (D + kVPad) * 2;
    }
    __host__ __device__ int bytes() const { return total + 1024; }
};

// The consumers' last-layer output, for the key net (key) or the value net: rows lr0, lr0 + 8 of the tile, the
// thread's columns 8j + 2t, + 1 of each chunk. The key net's scores go straight to the tile's score rows: a chunk's
// K values (in place of its accumulators) times each query's columns, summed over the thread's columns and then
// over the quad's lanes by shuffles, the first chunk's sum stored and each later one's added by the one lane that
// owns the (query, row), so the sum's order is fixed. No partial sum is held across chunks: registers are short.
struct AttnOut {
    const float* qs;     // (T, D), q / sqrt(D)
    const float* stats;  // k_mean, k_std, v_mean, v_std: (D,) each
    float* sc;           // (T, kRows) scores
    __nv_bfloat16* vt;   // (kRows, D + kVPad) V rows, bf16
    int D, T, t, lr0;
    bool key;

    __device__ __forceinline__ void operator()(int ch, float (&acc)[32], const float2 (&bb)[8]) {
        const float* mean = stats + (key ? 0 : 2 * D);
        const float* stdv = mean + D;
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // acc becomes the chunk's denormalized rows; zero past D (D a multiple of 4)
            const int col = ch * kPiece + 8 * j + 2 * t;
            float2 m = make_float2(0.f, 0.f), sd = m;
            if (col < D) {
                m = *reinterpret_cast<const float2*>(mean + col);
                sd = *reinterpret_cast<const float2*>(stdv + col);
            }
            acc[4 * j] = __fadd_rn(__fmul_rn(__fadd_rn(acc[4 * j], bb[j].x), sd.x), m.x);
            acc[4 * j + 1] = __fadd_rn(__fmul_rn(__fadd_rn(acc[4 * j + 1], bb[j].y), sd.y), m.y);
            acc[4 * j + 2] = __fadd_rn(__fmul_rn(__fadd_rn(acc[4 * j + 2], bb[j].x), sd.x), m.x);
            acc[4 * j + 3] = __fadd_rn(__fmul_rn(__fadd_rn(acc[4 * j + 3], bb[j].y), sd.y), m.y);
            if (!key && col < D) {
                const int ld = D + kVPad;
                *reinterpret_cast<__nv_bfloat162*>(vt + lr0 * ld + col) = __floats2bfloat162_rn(acc[4 * j],
                                                                                              acc[4 * j + 1]);
                *reinterpret_cast<__nv_bfloat162*>(vt + (lr0 + 8) * ld + col) =
                    __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
            }
        }
        if (!key) return;
#pragma unroll 1
        for (int tq = 0; tq < T; ++tq) {  // T is the same for every lane
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = ch * kPiece + 8 * j + 2 * t;
                if (col < D) {
                    const float2 q = *reinterpret_cast<const float2*>(qs + tq * D + col);
                    s0 = fmaf(q.y, acc[4 * j + 1], fmaf(q.x, acc[4 * j], s0));
                    s1 = fmaf(q.y, acc[4 * j + 3], fmaf(q.x, acc[4 * j + 2], s1));
                }
            }
            s0 += __shfl_xor_sync(attn::kFull, s0, 1);
            s1 += __shfl_xor_sync(attn::kFull, s1, 1);
            s0 += __shfl_xor_sync(attn::kFull, s0, 2);
            s1 += __shfl_xor_sync(attn::kFull, s1, 2);
            if ((tq & 3) == t) {
                float* row = sc + tq * kRows;
                row[lr0] = ch == 0 ? s0 : row[lr0] + s0;
                row[lr0 + 8] = ch == 0 ? s1 : row[lr0 + 8] + s1;
            }
        }
    }

    // The owning lanes' scores of this tile set to -inf where the query does not attend the row at position t0 +
    // lr: query row tq sits at position S - T + tq, and causal rows see positions <= theirs.
    __device__ __forceinline__ void mask_scores(int t0, int S, int causal) const {
#pragma unroll 1
        for (int tq = t; tq < T; tq += 4) {
            const int last = causal ? S - T + tq : S - 1;
            float* row = sc + tq * kRows;
            if (t0 + lr0 > last) row[lr0] = attn::neg_inf();
            if (t0 + lr0 + 8 > last) row[lr0 + 8] = attn::neg_inf();
        }
    }
};

// k_mean .. v_std: (N, D); q: (N, T, D); mult: (H,) or null; pieces: split_kernel<SPLITS>'s (N key nets, then N
// value nets); part_ml (N, chunks, T, 2), part_acc (N, chunks, T, D). A block takes tiles [blockIdx.x *
// tiles_per_chunk, ...) of head blockIdx.y. SPLITS: kSplits (2F, ACT16) or 1 (2D, the weights rounded).
template <bool FAST, int SPLITS>
__global__ void __launch_bounds__(kThreads, 1) attention_wgmma_kernel(
    const __grid_constant__ NetDesc knet, const __grid_constant__ NetDesc vnet, int L,
    const float* __restrict__ k_mean, const float* __restrict__ k_std, const float* __restrict__ v_mean,
    const float* __restrict__ v_std, const float* __restrict__ q, const float* __restrict__ mult,
    const unsigned char* __restrict__ pieces, float* __restrict__ part_ml, float* __restrict__ part_acc, int N, int S,
    int T, int H, int D, float omega, float q_scale, int causal, int tiles_per_chunk) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    const AttnSmem off(L, T, D);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + off.bar);
    uint64_t* empty = full + kAttnStages;
    const int n = blockIdx.y, chunk = blockIdx.x;
    const int n_tiles = (S + kRows - 1) / kRows;
    const int lo = chunk * tiles_per_chunk, hi = min(lo + tiles_per_chunk, n_tiles);
    const int KA = (H + kPiece - 1) / kPiece, dch = (D + kPiece - 1) / kPiece;
    const int per_net = pieces_per_net(H, D, L, SPLITS);
    const int total = max(hi - lo, 0) * 2 * per_net;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kAttnStages; ++s) {
            mbar_init(full + s, 1);   // the stage's producer warp, with its copy's bytes
            mbar_init(empty + s, 8);  // lane 0 of each consumer warp after its group
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    float* kbias = reinterpret_cast<float*>(smem + off.bias);
    float* vbias = kbias + L * kMaxWidth;
    float* kfirst = reinterpret_cast<float*>(smem + off.first_w);
    float* vfirst = kfirst + kMaxWidth;
    float* first_sc = reinterpret_cast<float*>(smem + off.first_sc);
    fill_net_tables<SPLITS == 1>(knet, n, L, H, kbias, kfirst);
    fill_net_tables<SPLITS == 1>(vnet, n, L, H, vbias, vfirst);
    fill_scales(mult, H, omega, first_sc);
    float* stats = reinterpret_cast<float*>(smem + off.stats);
    for (int e = threadIdx.x; e < D; e += kThreads) {
        stats[e] = k_mean[(size_t)n * D + e];
        stats[D + e] = k_std[(size_t)n * D + e];
        stats[2 * D + e] = v_mean[(size_t)n * D + e];
        stats[3 * D + e] = v_std[(size_t)n * D + e];
    }
    float* qs = reinterpret_cast<float*>(smem + off.qs);
    for (int e = threadIdx.x; e < T * D; e += kThreads) qs[e] = q[(size_t)n * T * D + e] * q_scale;
    const attn::State st = attn::carve_state(reinterpret_cast<float*>(smem + off.state), T, D, kRows);
    __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(smem + off.vt);
    __syncthreads();
    if (threadIdx.x < 128) {
        regs_dec<kProducerRegs>();
        produce_ready<kAttnStages>(total, smem, full, empty, [&](int p) {
            const int idx = p % (2 * per_net);  // the tile's key net pieces, then its value net's
            const int y = idx < per_net ? n : N + n;
            return pieces + ((size_t)y * per_net + idx % per_net) * kStageBytes;
        });
        return;
    }
    regs_inc<kConsumerRegs>();
    const int lt = threadIdx.x - 128, wg = lt / 128, warp = (lt % 128) / 32, lane = lt % 32;
    const int t = lane % 4, lr0 = wg * 64 + warp * 16 + lane / 4;
    const NetTables<float> key_net{kbias, kfirst, first_sc}, value_net{vbias, vfirst, first_sc};
    const float xden = (float)max(S - 1, 1);
    Consumer<FAST, SPLITS, kAttnStages, float> c{key_net, KA, KA, dch, lane, t, omega, xden, smem_addr(smem), full,
                                                 empty};
    AttnOut out{qs, stats, st.sc, vt, D, T, t, lr0, true};
    st.init(T, D, lt, 256);
    uint32_t a[kKSteps][4], an[kKSteps][4];
    float acc[32];
    for (int ti = lo; ti < hi; ++ti) {
        const int t0 = ti * kRows;
        c.r0 = t0 + lr0;
        c.r1 = c.r0 + 8;
#pragma unroll 1
        for (int which = 0; which < 2; ++which) {  // the key net, then the value net
            c.net = which == 0 ? key_net : value_net;
            out.key = which == 0;
            c.rows(L, a, an, acc, out);
            if (out.key) out.mask_scores(t0, S, causal);
            consumer_sync();  // key: the tile's scores are written; value: the V tile is
            if (out.key) {
                attn::softmax_update_rows(st, T, kRows, lt, 256);
            } else {
                attn::acc_update<true>(st, vt, D + kVPad, T, D, kRows, lt, 256);
                consumer_sync();  // p . V is done with the scores and the V tile before the next tile writes them
            }
        }
    }
    const size_t cell = (size_t)n * gridDim.x + chunk;
    attn::write_partial(st, T, D, part_ml + cell * T * 2, part_acc + cell * T * D, lt, 256);
}

// The split pass with SPLITS pieces a weight, then the attention kernel.
template <bool FAST, int SPLITS>
int launch(dim3 grid, const NetDesc& knet, const NetDesc& vnet, int L, const float* k_mean, const float* k_std,
           const float* v_mean, const float* v_std, const float* q, const float* mult, void* pieces,
           float* part_ml, float* part_acc, int N, int S, int T, int H, int D, float omega, float q_scale, int causal,
           int tiles_per_chunk, cudaStream_t st) {
    const auto kernel = attention_wgmma_kernel<FAST, SPLITS>;
    const int smem = AttnSmem(L, T, D).bytes();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = split_launch<SPLITS>(knet, vnet, N, 2 * N, L, H, D, pieces, st);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, st>>>(knet, vnet, L, k_mean, k_std, v_mean, v_std, q, mult,
                                         static_cast<const unsigned char*>(pieces), part_ml, part_acc, N, S, T, H, D,
                                         omega, q_scale, causal, tiles_per_chunk);
    return (int)cudaGetLastError();
}

}  // namespace bf16wg

using namespace bf16wg;

// Bytes of the pieces area a launch over N heads of these widths needs (split_kernel's output over 2N nets: kSplits
// pieces a weight, one where `rounded`).
extern "C" long long siren_attention_wgmma_pieces_bytes(int H, int D, int L, int N, int rounded) {
    return (long long)pieces_per_net(H, D, L, rounded ? 1 : kSplits) * kStageBytes * 2 * N;
}

// Shared-memory bytes of a block (L layers, T queries, head width D).
extern "C" int siren_attention_wgmma_smem(int L, int T, int D) { return AttnSmem(L, T, D).bytes(); }

// k_desc, v_desc: L LayerDesc records each (dense fp32 or packed codes, layer 0 dense; (1, H), (H, H) x (L - 2),
// (H, D)); k_mean .. v_std: (N, D) fp32; q: (N, T, D) fp32; mult: (H,) fp32 or null; rounded: 0 for 2F's
// arithmetic (kSplits pieces a weight), 1 for 2D's (weights, biases and layer 0 rounded to bf16, one piece a weight);
// pieces: siren_attention_wgmma_pieces_bytes(H, D, L, N, rounded) of device memory (16-byte aligned), scratch the
// launch overwrites; part_ml (N, chunks, T, 2) and part_acc (N, chunks, T, D) scratch; out (N, T, D); m_out, l_out
// (N, T) or null. H and D multiples of 4, H at most kMaxWidth, D at most kMaxHeadDim, T at most kMaxQueries (and at
// most S when causal); chunks * tiles_per_chunk * 128 >= S. Runs split_kernel, the attention and the merge. Returns
// cudaGetLastError() after the launches.
extern "C" int siren_attention_wgmma_launch(const long long* k_desc, const long long* v_desc, int L,
                                            const float* k_mean, const float* k_std, const float* v_mean,
                                            const float* v_std, const float* q, const float* mult, void* pieces,
                                            float* part_ml, float* part_acc, float* out, float* m_out, float* l_out,
                                            int N, int S, int T, int H, int D, float omega, float q_scale, int fast,
                                            int rounded, int causal, int chunks, int tiles_per_chunk, void* stream) {
    NetDesc knet{}, vnet{};
    if (L < 2 || L > siren::kMaxLayers || N < 1 || N > 65535 || S < 1 || T < 1 || T > kMaxQueries ||
        (causal && T > S) || D > kMaxHeadDim || chunks < 1 || tiles_per_chunk < 1 ||
        (long long)chunks * tiles_per_chunk * kRows < S || pieces == nullptr ||
        AttnSmem(L, T, D).bytes() > kMaxSmem)
        return (int)cudaErrorInvalidValue;
    std::memcpy(knet.layer, k_desc, sizeof(LayerDesc) * L);
    std::memcpy(vnet.layer, v_desc, sizeof(LayerDesc) * L);
    if (!act16_net_ok(knet, L, H, D) || !act16_net_ok(vnet, L, H, D)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid(chunks, N);
    const auto run = [&](auto kernel_launch) {
        return kernel_launch(grid, knet, vnet, L, k_mean, k_std, v_mean, v_std, q, mult, pieces, part_ml, part_acc, N,
                             S, T, H, D, omega, q_scale, causal, tiles_per_chunk, st);
    };
    const int status = rounded ? (fast ? run(launch<true, 1>) : run(launch<false, 1>))
                               : (fast ? run(launch<true, kSplits>) : run(launch<false, kSplits>));
    if (status != 0) return status;
    attn::merge_chunks_kernel<<<N, attn::kThreads, 0, st>>>(part_ml, part_acc, out, m_out, l_out, chunks, T, D);
    return (int)cudaGetLastError();
}

extern "C" const char* error_string(int status) { return cudaGetErrorString((cudaError_t)status); }
