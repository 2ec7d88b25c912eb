// Shared pieces of the attention kernels (siren_attention.cu, kv_quant_attention.cu):
// the online softmax over one row tile held in shared memory, each block's
// partial (m, l, acc) for its chunk of rows, and the merge of the chunks.
//
// On the TPU one grid step per head walked every row tile in order and
// carried (m, l, acc) from tile to tile. Here a head's rows are cut into
// chunks that run as separate blocks (flash-decoding): each block writes
// the partial state of its chunk and a second kernel merges the chunks in
// chunk order. Every sum is taken by one thread (or one fixed shuffle tree)
// in one order, so two runs give bit-identical results.
//
// Masked scores are -inf, not the TPU kernels' finite -1e30: a chunk (or a
// query row of it) that nothing attends keeps m = -inf, l = 0, acc = 0 and
// adds nothing to the merge, and where no chunk attends at all the merge
// returns o = 0, m = -1e30, l = 0 rather than dividing by zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr int kThreads = 256;      // threads per block of both attention kernels
constexpr int kMaxRows = 32;       // rows of a tile: one lane each in the softmax step
constexpr int kDotLanes = 8;       // lanes that share one q.k dot product
constexpr float kEmptyM = -1e30f;  // m reported for a query row that nothing attends
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Running state of T query rows, in shared memory.
struct State {
    float* acc;    // (T, D)
    float* m;      // (T,)
    float* l;      // (T,)
    float* alpha;  // (T,) rescale of the last update
    float* sc;     // (T, rows) scores, then weights

    __device__ void init(int T, int D) const { init(T, D, threadIdx.x, blockDim.x); }

    // The same, by the `n` threads tid = 0 .. n - 1 of a part of the block (the wgmma kernels' consumers).
    __device__ void init(int T, int D, int tid, int n) const {
        for (int e = tid; e < T * D; e += n) acc[e] = 0.f;
        for (int t = tid; t < T; t += n) {
            m[t] = neg_inf();
            l[t] = 0.f;
        }
    }
};

// sc[t][r] = allowed(t, r) ? post * (qs[t] . kv[r]) : -inf, for a tile of
// `rows` rows of kv (row stride ld). kDotLanes lanes share each dot product
// (lane g takes d = g, g + 8, ...) and sum it with a fixed shuffle tree.
template <typename Allowed>
__device__ __forceinline__ void scores(const float* __restrict__ qs, const float* __restrict__ kv,
                                       int ld, int T, int D, int rows, float post, Allowed allowed,
                                       float* __restrict__ sc) {
    const int items = T * rows * kDotLanes;
    for (int base = 0; base < items; base += blockDim.x) {  // whole warps iterate together
        const int it = base + threadIdx.x;
        const bool live = it < items;
        const int dot = it / kDotLanes;
        const int g = it % kDotLanes;
        const int t = dot / rows;
        const int r = dot - t * rows;
        float s = 0.f;
        if (live) {
            for (int d = g; d < D; d += kDotLanes) s = fmaf(qs[t * D + d], kv[r * ld + d], s);
        }
        s += __shfl_xor_sync(kFull, s, 4);
        s += __shfl_xor_sync(kFull, s, 2);
        s += __shfl_xor_sync(kFull, s, 1);
        if (live && g == 0) sc[t * rows + r] = allowed(t, r) ? s * post : neg_inf();
    }
}

// One online-softmax step over the tile's scores: one warp per query row,
// one lane per tile row (rows <= 32). Turns sc into the weights
// p = exp(s - m_new), updates m and l, and leaves the rescale of the old
// state in alpha. A row with nothing allowed so far keeps m = -inf, l = 0.
__device__ __forceinline__ void softmax_update(const State& st, int T, int rows) {
    const int lane = threadIdx.x % 32;
    for (int t = threadIdx.x / 32; t < T; t += blockDim.x / 32) {
        const float s = lane < rows ? st.sc[t * rows + lane] : neg_inf();
        float mx = s;
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_old = st.m[t];
        const float m_new = fmaxf(m_old, mx);
        float p = 0.f;
        float a = 1.f;
        if (m_new != neg_inf()) {
            p = expf(s - m_new);  // 0 where s = -inf
            a = expf(m_old - m_new);
        }
        float ps = p;
        for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
        if (lane < rows) st.sc[t * rows + lane] = p;
        if (lane == 0) {
            st.l[t] = a * st.l[t] + ps;
            st.m[t] = m_new;
            st.alpha[t] = a;
        }
    }
}

// softmax_update for a tile of any rows: one warp per query row, lane l
// taking tile rows l, l + 32, ... in order. Turns sc into the weights
// p = exp(s - m_new), updates m and l, and leaves the rescale of the old
// state in alpha. A row with nothing allowed so far keeps m = -inf, l = 0.
// By the n threads tid = 0 .. n - 1 (whole warps) of a part of the block; the overload below by all of it.
__device__ __forceinline__ void softmax_update_rows(const State& st, int T, int rows, int tid, int n) {
    const int lane = tid % 32;
    for (int t = tid / 32; t < T; t += n / 32) {
        float* sc = st.sc + t * rows;
        float mx = neg_inf();
        for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, sc[r]);
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_old = st.m[t];
        const float m_new = fmaxf(m_old, mx);
        const bool some = m_new != neg_inf();
        float ps = 0.f;
        for (int r = lane; r < rows; r += 32) {
            const float p = some ? expf(sc[r] - m_new) : 0.f;  // 0 where s = -inf
            sc[r] = p;
            ps += p;
        }
        for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
        if (lane == 0) {
            const float a = some ? expf(m_old - m_new) : 1.f;
            st.l[t] = a * st.l[t] + ps;
            st.m[t] = m_new;
            st.alpha[t] = a;
        }
    }
}

__device__ __forceinline__ void softmax_update_rows(const State& st, int T, int rows) {
    softmax_update_rows(st, T, rows, threadIdx.x, blockDim.x);
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// acc[t][j] = alpha[t] * acc[t][j] + sum_r p[t][r] * v[r][j] (v row stride ld).
// BF16: p and v rounded to bf16 first, the p.V of the JAX kernels'
// compute_dtype=bfloat16 mode (siren_attention_pallas.py:121-123); a product
// of two bf16 values is exact in fp32, so the sums are fp32 as there. l stays
// the sum of the unrounded p, as there. v fp32, or bf16 (values already rounded,
// which BF16 rounds again to themselves); by the n threads tid = 0 .. n - 1.
template <bool BF16, typename V>
__device__ __forceinline__ void acc_update(const State& st, const V* __restrict__ v, int ld, int T, int D,
                                           int rows, int tid, int n) {
    for (int e = tid; e < T * D; e += n) {
        const int t = e / D;
        const int j = e - t * D;
        const float* p = st.sc + t * rows;
        float a = st.acc[e] * st.alpha[t];
        for (int r = 0; r < rows; ++r)
            a = BF16 ? fmaf(round_bf16(p[r]), round_bf16(as_float(v[r * ld + j])), a)
                     : fmaf(p[r], as_float(v[r * ld + j]), a);
        st.acc[e] = a;
    }
}

template <bool BF16 = false>
__device__ __forceinline__ void acc_update(const State& st, const float* __restrict__ v, int ld,
                                           int T, int D, int rows) {
    acc_update<BF16>(st, v, ld, T, D, rows, (int)threadIdx.x, (int)blockDim.x);
}

// The block's partial state for its chunk: ml (T, 2) = (m, l), acc (T, D).
// By the n threads tid = 0 .. n - 1 of a part of the block; the overload below by all of it.
__device__ __forceinline__ void write_partial(const State& st, int T, int D, float* __restrict__ ml,
                                              float* __restrict__ acc, int tid, int n) {
    for (int e = tid; e < T * D; e += n) acc[e] = st.acc[e];
    for (int t = tid; t < T; t += n) {
        ml[2 * t] = st.m[t];
        ml[2 * t + 1] = st.l[t];
    }
}

__device__ __forceinline__ void write_partial(const State& st, int T, int D, float* __restrict__ ml,
                                              float* __restrict__ acc) {
    write_partial(st, T, D, ml, acc, threadIdx.x, blockDim.x);
}

// One block per head: merges the C chunks' partials in chunk order.
// part_ml (N, C, T, 2), part_acc (N, C, T, D) -> out (N, T, D) and, when
// m_out / l_out are not null, the merged m (the running max over every
// attended score) and l = sum exp(s - m), each (N, T). Static: each object of
// a library built in parts (ops/_build.py's PARTS) holds its own copy.
static __global__ void __launch_bounds__(kThreads) merge_chunks_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int C, int T, int D) {
    const int n = blockIdx.x;
    const float* ml = part_ml + (size_t)n * C * T * 2;
    const float* pa = part_acc + (size_t)n * C * T * D;
    for (int e = threadIdx.x; e < T * D; e += blockDim.x) {
        const int t = e / D;
        const int j = e - t * D;
        float big = neg_inf();
        for (int c = 0; c < C; ++c) big = fmaxf(big, ml[((size_t)c * T + t) * 2]);
        float l = 0.f;
        float a = 0.f;
        if (big != neg_inf()) {
            for (int c = 0; c < C; ++c) {
                const float w = expf(ml[((size_t)c * T + t) * 2] - big);  // 0 for an empty chunk
                l = fmaf(ml[((size_t)c * T + t) * 2 + 1], w, l);
                a = fmaf(pa[((size_t)c * T + t) * D + j], w, a);
            }
        }
        out[(size_t)n * T * D + e] = l > 0.f ? a / l : 0.f;
        if (j == 0 && m_out != nullptr) {
            m_out[(size_t)n * T + t] = l > 0.f ? big : kEmptyM;
            l_out[(size_t)n * T + t] = l;
        }
    }
}

// Shared-memory floats of a State for T rows, D columns and `rows` tile rows.
__host__ __device__ constexpr int state_floats(int T, int D, int rows) {
    return T * D + 3 * T + T * rows;
}

__device__ __forceinline__ State carve_state(float* base, int T, int D, int rows) {
    State st;
    st.acc = base;
    st.m = st.acc + T * D;
    st.l = st.m + T;
    st.alpha = st.l + T;
    st.sc = st.alpha + T;
    return st;
}

}  // namespace attn
