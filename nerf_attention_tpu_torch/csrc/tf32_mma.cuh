// Tensor-core products in error-compensated TF32 ("3xTF32") for the
// layer-wise SIREN training step (csrc/siren_train.cu).
//
// A product C (M x N) = A (M x K) . B (K x N) of fp32 operands, per fit of a
// batch, on mma.sync m16n8k8 TF32 with fp32 accumulation. Each operand
// value x is split into a TF32 high part and a TF32 remainder,
//     hi = tf32(x),  lo = tf32(x - hi),
// and every product is accumulated as a_lo b_hi + a_hi b_lo + a_hi b_hi
// (the a_lo b_lo term, below 2^-22 of a b, is dropped), as CUTLASS's
// OpMultiplyAddFastF32 does: within rounding of an fp32 product at three
// tensor-core passes. tf32() rounds to nearest, ties away from zero, to 10
// mantissa bits: add 0x1000 to the bit pattern and clear the low 13 bits
// (integer ops, not the quarter-rate cvt; the CPU tests emulate the same).
//
// Why mma.sync and not wgmma: wgmma reads 32-bit operands from shared memory
// K-major only (only 16-bit types may be transposed), and the step's three
// product shapes need h.W, da.W^T and h^T.da: each operand would have to be
// written twice (in both layouts) or the hi/lo parts kept as two tiles in
// shared memory. mma.sync takes its fragments from registers, so each
// operand is staged once, in the layout it has in device memory, the
// transposition is only the index a fragment is read with, and the hi/lo
// split happens in registers. The price is mma.sync's lower peak on Hopper.
//
// Block tile: 64 rows x BN (64 or 128) columns, 4 warps as 2 x 2, each
// warp 32 x BN/2; depth 32 per stage, 3 stages of cp.async (16 bytes a
// thread, L2 only) in flight. Shared rows are padded (K-major rows by 4
// floats, M/N-major rows by 8), so every fragment load of a warp hits 32
// distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int kBM = 64;        // rows of a block tile
constexpr int kBK = 32;        // depth of one pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps, 2 x 2

// ---- TF32 split and the tensor-core instruction ----

__device__ __forceinline__ uint32_t tf32_round(uint32_t bits) { return (bits + 0x1000u) & 0xFFFFE000u; }

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_round(__float_as_uint(x));
    lo = tf32_round(__float_as_uint(x - __uint_as_float(hi)));
}

// d += a . b for one 16x8x8 tile: a row-major (16 x 8), b column-major (8 x 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- cp.async ----

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- Operand layouts in shared memory ----

// One operand's stage: E (64 rows of A, or BN columns of B) by kBK of depth.
// KMAJOR: the operand is K-contiguous in device memory (A as (M, K), B as
// (N, K)); its stage is [e][k], rows padded to kBK + 4. Otherwise it is
// E-contiguous (A as (K, M), B as (K, N)); its stage is [k][e], rows padded
// to E + 8. Either way a stage row is a device-memory row, so a 16-byte
// cp.async lands in one piece, and at(e, k) reads the transposed layout.
template <bool KMAJOR, int E>
struct Tile {
    static constexpr int kStride = KMAJOR ? kBK + 4 : E + 8;
    static constexpr int kFloats = (KMAJOR ? E : kBK) * kStride;
    static constexpr int kRowVecs = (KMAJOR ? kBK : E) / 4;  // 16-byte pieces per stage row
    static constexpr int kVecs = E * kBK / 4;

    __device__ static float at(const float* s, int e, int k) {
        return KMAJOR ? s[e * kStride + k] : s[k * kStride + e];
    }
};

// An operand in device memory: per fit, a row-major (rows, ld) matrix at
// base + fit * fit_stride. fill() copies the 4 floats at (row, col).
struct MemSrc {
    const float* base;
    long long fit_stride;
    int ld;

    __device__ __forceinline__ void fill(float* smem, int fit, int row, int col) const {
        cp_async16(smem, base + fit * fit_stride + (long long)row * ld + col);
    }
};

// Where a thread's accumulators sit in the block tile: acc[mi][ni][2 * half + q]
// is row row(mi, half), column col(ni) + q.
template <int BN>
struct Frag {
    int wm, wn, g, t;

    __device__ int row(int mi, int half) const { return wm * 32 + mi * 16 + g + half * 8; }
    __device__ int col(int ni) const { return wn * (BN / 2) + ni * 8 + 2 * t; }
};

template <bool AK, bool BK_, int BN>
constexpr int smem_floats() {
    return kStages * (Tile<AK, kBM>::kFloats + Tile<BK_, BN>::kFloats);
}

// The block's product: grid (M / 64, N / BN, fits * chunks); block z takes fit
// z / chunks and the depth range [chunk * kchunk, min(K, (chunk + 1) * kchunk)),
// a multiple of kBK. The accumulators go to epi(fit, chunk, m0, n0, acc,
// smem, frag) with the stages free for the epilogue's reductions.
// AK / BK_: whether A / B are K-contiguous (see Tile).
template <bool AK, bool BK_, int BN, class Epi>
__global__ void __launch_bounds__(kThreads) gemm_3xtf32(MemSrc a, MemSrc b, Epi epi, int K, int kchunk, int chunks) {
    using TA = Tile<AK, kBM>;
    using TB = Tile<BK_, BN>;
    constexpr int NI = BN / 16;  // 8-column tiles per warp
    static_assert(TA::kVecs % kThreads == 0 && TB::kVecs % kThreads == 0, "whole pieces per thread");
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);

    const int fit = blockIdx.z / chunks;
    const int chunk = blockIdx.z - fit * chunks;
    const int m0 = blockIdx.x * kBM;
    const int n0 = blockIdx.y * BN;
    const int k_begin = chunk * kchunk;
    const int nk = (min(K, k_begin + kchunk) - k_begin) / kBK;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const Frag<BN> f{warp >> 1, warp & 1, lane >> 2, lane & 3};

    float acc[2][NI][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

    auto stage_a = [&](int s) { return smem + s * (TA::kFloats + TB::kFloats); };
    auto stage_b = [&](int s) { return smem + s * (TA::kFloats + TB::kFloats) + TA::kFloats; };
    auto load = [&](int s, int kt) {
        const int k0 = k_begin + kt * kBK;
        float* sa = stage_a(s);
        float* sb = stage_b(s);
#pragma unroll
        for (int i = 0; i < TA::kVecs / kThreads; ++i) {
            const int v = threadIdx.x + i * kThreads;
            const int r = v / TA::kRowVecs;
            const int c = (v - r * TA::kRowVecs) * 4;
            a.fill(sa + r * TA::kStride + c, fit, (AK ? m0 : k0) + r, (AK ? k0 : m0) + c);
        }
#pragma unroll
        for (int i = 0; i < TB::kVecs / kThreads; ++i) {
            const int v = threadIdx.x + i * kThreads;
            const int r = v / TB::kRowVecs;
            const int c = (v - r * TB::kRowVecs) * 4;
            b.fill(sb + r * TB::kStride + c, fit, (BK_ ? n0 : k0) + r, (BK_ ? k0 : n0) + c);
        }
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) load(s, s);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // stage kt has landed, and every warp is done with stage kt - 1
        if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, kt + kStages - 1);
        cp_async_commit();
        const float* sa = stage_a(kt % kStages);
        const float* sb = stage_b(kt % kStages);
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
            uint32_t ah[2][4], al[2][4], bh[NI][2], bl[NI][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int r = 0; r < 4; ++r)  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
                    split_tf32(TA::at(sa, f.wm * 32 + mi * 16 + f.g + (r & 1) * 8, kk + f.t + (r >> 1) * 4),
                               ah[mi][r], al[mi][r]);
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                for (int r = 0; r < 2; ++r)  // b0 (k = t, n = g), b1 (k = t + 4, n = g)
                    split_tf32(TB::at(sb, f.wn * (BN / 2) + ni * 8 + f.g, kk + f.t + r * 4), bh[ni][r], bl[ni][r]);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < NI; ++ni) {
                    mma_tf32(acc[mi][ni], al[mi], bh[ni]);
                    mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
                    mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
                }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    epi(fit, chunk, m0, n0, acc, smem, f);
}

template <bool AK, bool BK_, int BN, class Epi>
int launch_3xtf32(dim3 grid, const MemSrc& a, const MemSrc& b, const Epi& epi, int K, int kchunk, int chunks,
                  cudaStream_t stream) {
    constexpr int bytes = smem_floats<AK, BK_, BN>() * (int)sizeof(float);
    static bool configured = false;  // the attribute is per kernel, set once per process
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(gemm_3xtf32<AK, BK_, BN, Epi>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    gemm_3xtf32<AK, BK_, BN, Epi><<<grid, kThreads, bytes, stream>>>(a, b, epi, K, kchunk, chunks);
    return (int)cudaGetLastError();
}

// ---- Fixed-order block reductions for the epilogues ----

// v[ni][q]: this thread's sum over its rows of column col(ni) + q. Writes the
// block's 64-row column sums, BN of them, to out[0..BN). The rows are summed
// in the same order in every run: within a thread, then over the 8 row
// groups of a warp (butterfly), then warp row 0 + warp row 1.
template <int BN, int NI>
__device__ void colsum_block(float (&v)[NI][2], float* red, float* out, const Frag<BN>& f) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            float x = v[ni][q];
            x += __shfl_xor_sync(0xffffffffu, x, 4);
            x += __shfl_xor_sync(0xffffffffu, x, 8);
            x += __shfl_xor_sync(0xffffffffu, x, 16);
            if (f.g == 0) red[f.wm * BN + f.col(ni) + q] = x;
        }
    __syncthreads();
    for (int c = threadIdx.x; c < BN; c += kThreads) out[c] = red[c] + red[BN + c];
    __syncthreads();
}

// The block's sum of x, in a fixed order; every thread gets it.
__device__ __forceinline__ float sum_block(float x, float* red) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    const float total = (red[0] + red[1]) + (red[2] + red[3]);
    __syncthreads();
    return total;
}

}  // namespace tc
