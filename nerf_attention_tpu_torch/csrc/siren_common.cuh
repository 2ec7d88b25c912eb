// Shared pieces of the SIREN kernels: the flat parameter layout and the
// block-wide fp32 product over a row tile kept in shared memory.
//
// Every helper is called by all threads of a block and splits its work over
// them in a fixed way, so each output is summed by one thread in one order:
// results do not change from run to run.
#pragma once

#include <cuda_runtime.h>

namespace siren {

constexpr int kThreads = 256;     // threads per decode block
constexpr int kRowsPerItem = 8;   // rows one thread carries through a product

// The per-network layout of models/siren.py:SirenStack. w_0 (1, H), b_0 (H),
// then per hidden layer i = 1..L-2: w_i (H, H), b_i (H), then w_f (H, D),
// b_f (D). Every W is row-major (in, out).
struct Layout {
    int H, D, L;

    __host__ __device__ size_t w(int i) const {
        if (i == 0) return 0;
        return 2 * (size_t)H + (size_t)(i - 1) * ((size_t)H * H + H);
    }
    __host__ __device__ size_t b(int i) const {
        const size_t fan = i == 0 ? 1 : (size_t)H;
        const size_t width = i == L - 1 ? (size_t)D : (size_t)H;
        return w(i) + fan * width;
    }
    __host__ __device__ size_t size() const { return b(L - 1) + D; }
};

// A dense fp32 weight matrix (K x J), row-major in global memory.
// load4(k, j, w) fetches W[k..k+3][j].
struct DenseW {
    const float* __restrict__ w;
    int J;

    __device__ __forceinline__ void load4(int k, int j, float* out) const {
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = __ldg(w + (size_t)(k + q) * J + j);
    }
};

// out[r][j] = sum_k in[r][k] * W[k][j] for r < rows, j < J, handed to
// epi(r, j, sum). in is shared (rows x K, K % 4 == 0); W is a loader with
// load4 (DenseW, or a dequantizing one). A work item is kRowsPerItem rows
// of one column: a warp spans consecutive columns, so each W load is
// coalesced and each in load is one float4 that all lanes share.
template <typename WLoad, typename Epi>
__device__ __forceinline__ void matmul_rows(
    const float* __restrict__ in, int K, const WLoad& W, int J, int rows, Epi epi) {
    const int items = (rows / kRowsPerItem) * J;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
        const int j = it % J;
        const int r0 = (it / J) * kRowsPerItem;
        const float* in0 = in + r0 * K;
        float acc[kRowsPerItem];
#pragma unroll
        for (int q = 0; q < kRowsPerItem; ++q) acc[q] = 0.f;
        for (int k = 0; k < K; k += 4) {
            float w[4];
            W.load4(k, j, w);
#pragma unroll
            for (int q = 0; q < kRowsPerItem; ++q) {
                const float4 h = *reinterpret_cast<const float4*>(in0 + q * K + k);
                acc[q] = fmaf(h.x, w[0], acc[q]);
                acc[q] = fmaf(h.y, w[1], acc[q]);
                acc[q] = fmaf(h.z, w[2], acc[q]);
                acc[q] = fmaf(h.w, w[3], acc[q]);
            }
        }
#pragma unroll
        for (int q = 0; q < kRowsPerItem; ++q) epi(r0 + q, j, acc[q]);
    }
}

template <typename Epi>
__device__ __forceinline__ void matmul_rows(
    const float* __restrict__ in, int K, const float* __restrict__ W, int J, int rows, Epi epi) {
    matmul_rows(in, K, DenseW{W, J}, J, rows, epi);
}

}  // namespace siren
