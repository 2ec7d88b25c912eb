// SIREN training step: per-fit MSE loss and every (W, b) gradient of N
// SIRENs, layer by layer on the tensor cores.
//
// Replaces: nerf_attention_tpu/ops/siren_train_pallas.py, siren_train_grads
// (_train_kernel, kernel 2A). The backward is the one written out there:
//
//     y    = h_{L-2} @ Wf + bf,   h_i = sin(z_i),  z_i = omega * (h_{i-1} @ W_i + b_i)
//     dy   = 2 (y - t) / (S * D)          masked past S
//     dWf  = h_{L-2}^T dy, dbf = colsum dy, dh_{L-2} = dy Wf^T
//     da_i = dh_i * omega * cos(z_i)      (omega * mult on layer 0 with FM)
//     dW_i = h_{i-1}^T da_i, db_i = colsum da_i, dh_{i-1} = da_i W_i^T
//
// The step is a fixed sequence of 3 (L - 1) + 2 launches (L = 4: 11): a
// small kernel for the first sine layer, then batched products over the N
// fits on the tensor cores (csrc/tf32_mma.cuh: mma.sync m16n8k8 TF32 in
// three passes, "3xTF32", fp32 accumulation) with their elementwise work
// fused into the epilogue, then one pass of fixed-order sums:
//
//   layer 0   h_0 = sin(z_0), z_0 = scale_j (x_s w0_j + b0_j), x_s = s / (S - 1),
//             scale_j = omega mult_j (FM) or omega, written once (fan-in 1:
//             no product). Computing it instead where the two products that
//             read it load their operand was slower on the H100, side by
//             side: the sines, repeated for each block column, sat in the
//             products' main loops.
//   forward   a_i = h_{i-1} W_i (i = 1..L-2): the epilogue adds b_i and
//             writes h_i = sin(z_i) and g_i = omega cos(z_i) from one range
//             reduction.
//   output    y = h_{L-2} Wf: the epilogue reads the targets, writes dy
//             (0 past S), and the block's loss and column-of-dy partials. An
//             output width D that is not a multiple of 64 is padded with
//             zero columns (W_f and b_f copied into the workspace by one more
//             small kernel; err = 0 there).
//   backward  dW_i = h_{i-1}^T da_i, the reduction over the S rows being
//             the product's depth; dh_{i-1} = da_i W_i^T, whose epilogue
//             multiplies by g_{i-1} into da_{i-1} and writes the block's
//             column partials (db); for layer 0 it multiplies by
//             omega mult cos(z_0), computed there, and reduces straight to
//             dW_0 = sum x da_0 and db_0 = sum da_0 partials: da_0 never goes
//             to memory either.
//   finish    one pass sums every partial (loss, biases, layer 0, and the
//             depth chunks of a split dW) over its chunks in a fixed order.
//
// Activations (h_i, g_i, dy, da) go through device memory (L2 for most of
// it): one workspace that the wrapper allocates, laid out by plan_step. The
// S rows are padded to the 64-row tile; padded rows carry finite values
// forward and exact zeros backward (dy = 0 there), so no product masks.
// Where a dW product's output tiles fill fewer than the card's SMs (few
// fits, narrow nets), its depth is split into chunks that the finish pass
// adds in order. No atomics: two runs give bit-identical losses and
// gradients.
//
// Every product takes mma.sync, not wgmma: its operands are read as they lie
// in memory, transposed or not, and split into TF32 pairs in registers
// (csrc/tf32_mma.cuh says why in full).
//
// What bounds it on an H100: the products, 6 flops per multiply-add of the
// net per row (medium, N = 40, S = 2048: 80.6 GFLOP, 0.163 ms at the 495
// TFLOP/s TF32 peak, 0.49 ms as three passes). mma.sync reaches only part of
// that peak, so the three passes set the pace; the activations (~1.5 GB per
// medium step, mostly from L2) come second. Elementwise work (sines,
// cosines, bias, loss) stays fp32.

#include <cuda_runtime.h>

#include <algorithm>

#include "fastmath.cuh"
#include "siren_common.cuh"
#include "tf32_mma.cuh"

using siren::Layout;
using tc::Frag;
using tc::MemSrc;

namespace {

constexpr int kMaxLayers = 8;
constexpr int kFlatThreads = 256;  // threads per block of the elementwise kernels

// The first sine layer's argument z_0 = scale_j (x_s w0_j + b0_j), with
// x_s = s / (S - 1) and scale_j = omega mult_j (FM) or omega.
struct FirstLayer {
    const float* params;
    long long P;
    const float* mult;  // (H,) or null
    float omega, xden;
    int H;

    __device__ __forceinline__ float x(int s) const { return (float)s / xden; }
    // (scale, w0, b0) of columns j..j+3, j a multiple of 4.
    __device__ __forceinline__ void columns4(const float* w0, int j, float4* sc, float4* w, float4* b) const {
        const float4 m = mult != nullptr ? *reinterpret_cast<const float4*>(mult + j) : make_float4(1.f, 1.f, 1.f, 1.f);
        *sc = make_float4(omega * m.x, omega * m.y, omega * m.z, omega * m.w);
        *w = *reinterpret_cast<const float4*>(w0 + j);
        *b = *reinterpret_cast<const float4*>(w0 + H + j);
    }
};

// Forward hidden layer: h = sin(z), g = omega cos(z), z = omega (acc + b).
template <bool FAST>
struct SineEpi {
    const float* bias;
    long long P;
    float* h;
    float* g;
    long long act;  // per-fit stride of h and g
    int ld;
    float omega;

    template <int BN, int NI>
    __device__ void operator()(int fit, int, int m0, int n0, float (&acc)[2][NI][4], float*,
                               const Frag<BN>& f) const {
        const float* b = bias + fit * P;
        float* hf = h + fit * act;
        float* gf = g + fit * act;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const long long row = m0 + f.row(mi, half);
#pragma unroll
                for (int ni = 0; ni < NI; ++ni) {
                    const int col = n0 + f.col(ni);
                    float s[2], c[2];
#pragma unroll
                    for (int q = 0; q < 2; ++q)
                        siren::act_sincos<FAST>(omega * (acc[mi][ni][2 * half + q] + b[col + q]), &s[q], &c[q]);
                    *reinterpret_cast<float2*>(hf + row * ld + col) = make_float2(s[0], s[1]);
                    *reinterpret_cast<float2*>(gf + row * ld + col) = make_float2(omega * c[0], omega * c[1]);
                }
            }
    }
};

// Output layer: y = acc + bf; err = y - t (0 past S and past D); dy = 2 err / (S D).
// Writes dy, the block's sum of err^2 and its column sums of dy.
struct LossEpi {
    const float* bias;
    long long P;
    const float* targets;  // (N, S, D)
    float* dy;             // (N, S_pad, ld)
    long long dy_stride;
    float* loss_part;  // (N, mt, ld / BN)
    float* dbf_part;   // (N, mt, ld)
    int S, D, ld, mt;  // ld: D rounded up to the block width
    float two_inv_n;

    template <int BN, int NI>
    __device__ void operator()(int fit, int, int m0, int n0, float (&acc)[2][NI][4], float* smem,
                               const Frag<BN>& f) const {
        const float* b = bias + fit * P;
        const float* t = targets + (long long)fit * S * D;
        float* d = dy + fit * dy_stride;
        float sq = 0.f;
        float cs[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) cs[ni][0] = cs[ni][1] = 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const long long row = m0 + f.row(mi, half);
#pragma unroll
                for (int ni = 0; ni < NI; ++ni) {
                    const int col = n0 + f.col(ni);
                    float e[2];
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        e[q] = row < S && col < D ? (acc[mi][ni][2 * half + q] + b[col + q]) - t[row * D + col + q]
                                                  : 0.f;
                        sq = fmaf(e[q], e[q], sq);
                        e[q] *= two_inv_n;
                        cs[ni][q] += e[q];
                    }
                    *reinterpret_cast<float2*>(d + row * ld + col) = make_float2(e[0], e[1]);
                }
            }
        const long long tile = (long long)fit * mt + blockIdx.x;
        tc::colsum_block(cs, smem, dbf_part + tile * ld + n0, f);
        const float total = tc::sum_block(sq, smem);
        if (threadIdx.x == 0) loss_part[tile * gridDim.y + blockIdx.y] = total;
    }
};

// Backward through hidden layer i: da = acc * g_i; writes da and the block's
// column sums of it (db_i).
struct DaEpi {
    const float* g;
    float* da;
    long long act;
    int ld, mt;
    float* db_part;  // (N, mt, H)

    template <int BN, int NI>
    __device__ void operator()(int fit, int, int m0, int n0, float (&acc)[2][NI][4], float* smem,
                               const Frag<BN>& f) const {
        const float* gf = g + fit * act;
        float* out = da + fit * act;
        float cs[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) cs[ni][0] = cs[ni][1] = 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const long long row = m0 + f.row(mi, half);
#pragma unroll
                for (int ni = 0; ni < NI; ++ni) {
                    const int col = n0 + f.col(ni);
                    const float2 gv = *reinterpret_cast<const float2*>(gf + row * ld + col);
                    const float d0 = acc[mi][ni][2 * half] * gv.x;
                    const float d1 = acc[mi][ni][2 * half + 1] * gv.y;
                    cs[ni][0] += d0;
                    cs[ni][1] += d1;
                    *reinterpret_cast<float2*>(out + row * ld + col) = make_float2(d0, d1);
                }
            }
        tc::colsum_block(cs, smem, db_part + ((long long)fit * mt + blockIdx.x) * ld + n0, f);
    }
};

// Backward through layer 0: da_0 = acc * scale cos(z_0), reduced at once to
// the block's partials of dW_0 = sum_s x_s da_0 and db_0 = sum_s da_0.
template <bool FAST>
struct FirstLayerEpi {
    FirstLayer l0;
    int mt;
    float* part0;  // (N, mt, 2H): dW_0 then db_0

    template <int BN, int NI>
    __device__ void operator()(int fit, int, int m0, int n0, float (&acc)[2][NI][4], float* smem,
                               const Frag<BN>& f) const {
        const float* w0 = l0.params + fit * l0.P;
        float x[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int half = 0; half < 2; ++half) x[mi][half] = l0.x(m0 + f.row(mi, half));
        float sw[NI][2], sb[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
            const int col = n0 + f.col(ni);  // even: (col, col + 1) lie in one aligned group of 4
            float4 sc4, w4, b4;
            l0.columns4(w0, col & ~3, &sc4, &w4, &b4);
            const bool hi = col & 2;
            const float sc[2] = {hi ? sc4.z : sc4.x, hi ? sc4.w : sc4.y};
            const float w[2] = {hi ? w4.z : w4.x, hi ? w4.w : w4.y};
            const float b[2] = {hi ? b4.z : b4.x, hi ? b4.w : b4.y};
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                sw[ni][q] = sb[ni][q] = 0.f;
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const float z = sc[q] * fmaf(x[mi][half], w[q], b[q]);
                        const float d = acc[mi][ni][2 * half + q] * sc[q] * siren::act_cos<FAST>(z);
                        sw[ni][q] = fmaf(x[mi][half], d, sw[ni][q]);
                        sb[ni][q] += d;
                    }
            }
        }
        float* out = part0 + ((long long)fit * mt + blockIdx.x) * 2 * l0.H + n0;
        tc::colsum_block(sw, smem, out, f);
        tc::colsum_block(sb, smem, out + l0.H, f);
    }
};

// A weight gradient (or one depth chunk of it): dst + fit * stride_n + chunk * stride_c, row-major (H, ld);
// columns from ld on (the zero padding of a narrow output layer) are not written.
struct DwEpi {
    float* dst;
    long long stride_n, stride_c;
    int ld;

    template <int BN, int NI>
    __device__ void operator()(int fit, int chunk, int m0, int n0, float (&acc)[2][NI][4], float*,
                               const Frag<BN>& f) const {
        float* out = dst + fit * stride_n + chunk * stride_c;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const long long row = m0 + f.row(mi, half);
#pragma unroll
                for (int ni = 0; ni < NI; ++ni) {
                    const int col = n0 + f.col(ni);  // even, and so is ld
                    if (col < ld)
                        *reinterpret_cast<float2*>(out + row * ld + col) =
                            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
                }
            }
    }
};

// dst[n * dst_stride + q] = scale * sum_{c < chunks} src[(n * chunks + c) * stride + q], q < len <= stride,
// c in order.
struct Segment {
    float* dst;
    const float* src;
    long long dst_stride;
    int len, chunks, stride;
    float scale;
};

struct Segments {
    Segment s[2 * kMaxLayers];
};

__global__ void __launch_bounds__(kFlatThreads) finish_kernel(Segments segs, int N) {
    const Segment sg = segs.s[blockIdx.y];
    const long long total = (long long)N * sg.len;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += (long long)gridDim.x * blockDim.x) {
        const long long n = idx / sg.len;
        const long long q = idx - n * sg.len;
        const float* s = sg.src + n * sg.chunks * sg.stride + q;
        float acc = 0.f;
        for (int c = 0; c < sg.chunks; ++c) acc += s[(long long)c * sg.stride];
        sg.dst[n * sg.dst_stride + q] = acc * sg.scale;
    }
}

// (W_f, b_f) copied into an (H + 1, Dp) block per fit, zero past column D: the output layer of a net
// whose D is not a multiple of 64, in the layout the products read.
__global__ void __launch_bounds__(kFlatThreads) pad_output_layer(const float* __restrict__ params, long long P,
                                                                  long long wf_at, float* __restrict__ out, int N,
                                                                  int H, int D, int Dp) {
    const long long per = (long long)(H + 1) * Dp;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < N * per;
         idx += (long long)gridDim.x * blockDim.x) {
        const long long n = idx / per;
        const long long e = idx - n * per;
        const int r = (int)(e / Dp);
        const int c = (int)(e - (long long)r * Dp);
        out[idx] = c < D ? params[n * P + wf_at + (long long)r * D + c] : 0.f;  // row H is b_f, which follows W_f
    }
}

// h_0 (N, S_pad, H) = sin(z_0), 4 consecutive j a thread.
template <bool FAST>
__global__ void __launch_bounds__(kFlatThreads) first_layer_kernel(FirstLayer l0, float* __restrict__ h0, int N,
                                                                    int S_pad) {
    const int quads = l0.H / 4;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < (long long)N * S_pad * quads;
         idx += (long long)gridDim.x * blockDim.x) {
        const long long row = idx / quads;  // fit * S_pad + s
        const int j = (int)(idx - row * quads) * 4;
        const int fit = (int)(row / S_pad);
        float4 sc, w, b;
        l0.columns4(l0.params + fit * l0.P, j, &sc, &w, &b);
        const float x = l0.x((int)(row - (long long)fit * S_pad));
        *reinterpret_cast<float4*>(h0 + row * l0.H + j) =
            make_float4(siren::act_sin<FAST>(sc.x * fmaf(x, w.x, b.x)), siren::act_sin<FAST>(sc.y * fmaf(x, w.y, b.y)),
                        siren::act_sin<FAST>(sc.z * fmaf(x, w.z, b.z)), siren::act_sin<FAST>(sc.w * fmaf(x, w.w, b.w)));
    }
}

// The workspace and the launch shapes of one step. Offsets are in floats.
struct Plan {
    int S_pad, mt, Dp, bn_h, bn_d;  // Dp: D rounded up to 64
    int chunks[kMaxLayers], kchunk[kMaxLayers];  // dW of layer i = 1..L-1
    long long h[kMaxLayers], g[kMaxLayers], db[kMaxLayers], dw[kMaxLayers];
    long long dy, da[2], part0, dbf, loss, wf, total;  // wf: the padded output layer, -1 when D = Dp
};

int plan_step(int N, int S, int H, int D, int L, int sms, Plan* p) {
    if (N < 1 || N > 65535 || S < 1 || H < 64 || H % 64 || D < 4 || D % 4 || L < 3 || L > kMaxLayers || sms < 1)
        return (int)cudaErrorInvalidValue;
    p->S_pad = (S + tc::kBM - 1) / tc::kBM * tc::kBM;
    p->mt = p->S_pad / tc::kBM;
    p->Dp = (D + 63) / 64 * 64;
    // 64-column blocks (about 110 registers: 4 blocks of 4 warps on an SM) for nets up to 256 wide; 128
    // columns (about 170 registers, 2 blocks) from 512 on, where the larger tile ran faster side by side.
    p->bn_h = H >= 512 ? 128 : 64;
    p->bn_d = p->bn_h == 128 && p->Dp % 128 == 0 ? 128 : 64;
    const int Dp = p->Dp;
    long long off = 0;
    auto take = [&](long long floats) {
        const long long at = off;
        off += (floats + 63) / 64 * 64;  // 256-byte aligned regions
        return at;
    };
    const long long act = (long long)N * p->S_pad * H;
    p->h[0] = take(act);
    for (int i = 1; i <= L - 2; ++i) {
        p->h[i] = take(act);
        p->g[i] = take(act);
        p->db[i] = take((long long)N * p->mt * H);
    }
    p->dy = take((long long)N * p->S_pad * Dp);
    p->da[0] = take(act);
    p->da[1] = take(act);
    p->part0 = take((long long)N * p->mt * 2 * H);
    p->dbf = take((long long)N * p->mt * Dp);
    p->loss = take((long long)N * p->mt * (Dp / p->bn_d));
    p->wf = Dp != D ? take((long long)N * (H + 1) * Dp) : -1;
    for (int i = 1; i <= L - 1; ++i) {
        const int out = i == L - 1 ? D : H;
        const int tiles = N * (H / tc::kBM) * ((i == L - 1 ? Dp : H) / (i == L - 1 ? p->bn_d : p->bn_h));
        int c = 1;
        if (tiles < sms) c = std::max(1, std::min((2 * sms + tiles - 1) / tiles, p->S_pad / 128));
        const int per = ((p->S_pad + c - 1) / c + tc::kBK - 1) / tc::kBK * tc::kBK;
        p->kchunk[i] = per;
        p->chunks[i] = (p->S_pad + per - 1) / per;
        if ((long long)N * p->chunks[i] > 65535) return (int)cudaErrorInvalidValue;
        p->dw[i] = p->chunks[i] > 1 ? take((long long)N * p->chunks[i] * H * out) : -1;
    }
    p->total = off;
    return 0;
}

// One batched product with the block width that divides its output columns.
template <bool AK, bool BK_, class Epi>
int product(int bn, int m_tiles, int cols, int fits, const MemSrc& a, const MemSrc& b, const Epi& epi, int K,
            int kchunk, int chunks, cudaStream_t st) {
    if (bn == 128) {
        return tc::launch_3xtf32<AK, BK_, 128>(dim3(m_tiles, cols / 128, fits * chunks), a, b, epi, K, kchunk,
                                               chunks, st);
    }
    return tc::launch_3xtf32<AK, BK_, 64>(dim3(m_tiles, cols / 64, fits * chunks), a, b, epi, K, kchunk, chunks, st);
}

#define RETURN_IF_ERROR(x)                \
    do {                                  \
        const int status_ = (x);          \
        if (status_ != 0) return status_; \
    } while (0)

template <bool FAST>
int step(const Plan& p, const float* params, const float* targets, const float* mult, float* ws, float* grads,
         float* loss, int N, int S, int H, int D, int L, float omega, cudaStream_t st) {
    const Layout lay{H, D, L};
    const long long P = (long long)lay.size();
    const long long act = (long long)p.S_pad * H;  // per-fit stride of an (S_pad, H) activation
    const int Dp = p.Dp;
    const long long dys = (long long)p.S_pad * Dp;
    const float inv_n = 1.0f / ((float)S * (float)D);
    const FirstLayer l0{params, P, mult, omega, (float)std::max(S - 1, 1), H};

    // ---- Forward ----
    {
        const long long blocks = ((long long)N * p.S_pad * (H / 4) + kFlatThreads - 1) / kFlatThreads;
        first_layer_kernel<FAST><<<(unsigned)std::min<long long>(blocks, 8192), kFlatThreads, 0, st>>>(
            l0, ws + p.h[0], N, p.S_pad);
        RETURN_IF_ERROR((int)cudaGetLastError());
    }
    for (int i = 1; i <= L - 2; ++i) {
        const MemSrc w{params + lay.w(i), P, H};  // (in, out): N-contiguous
        const SineEpi<FAST> epi{params + lay.b(i), P, ws + p.h[i], ws + p.g[i], act, H, omega};
        RETURN_IF_ERROR((product<true, false>(p.bn_h, p.mt, H, N, MemSrc{ws + p.h[i - 1], act, H}, w, epi,
                                              H, H, 1, st)));
    }
    // The output layer as the products read it: in place, or padded to Dp columns.
    MemSrc wf{params + lay.w(L - 1), P, D};
    if (p.wf >= 0) {
        wf = MemSrc{ws + p.wf, (long long)(H + 1) * Dp, Dp};
        const long long blocks = (N * wf.fit_stride + kFlatThreads - 1) / kFlatThreads;
        pad_output_layer<<<(unsigned)std::min<long long>(blocks, 2048), kFlatThreads, 0, st>>>(
            params, P, (long long)lay.w(L - 1), ws + p.wf, N, H, D, Dp);
        RETURN_IF_ERROR((int)cudaGetLastError());
    }
    const MemSrc h_last{ws + p.h[L - 2], act, H};
    const LossEpi loss_epi{wf.base + (long long)H * wf.ld, wf.fit_stride, targets, ws + p.dy, dys, ws + p.loss,
                           ws + p.dbf, S, D, Dp, p.mt, 2.0f * inv_n};
    RETURN_IF_ERROR((product<true, false>(p.bn_d, p.mt, Dp, N, h_last, wf, loss_epi, H, H, 1, st)));

    // ---- Backward ----
    Segments segs{};
    int nseg = 0;
    segs.s[nseg++] = Segment{loss, ws + p.loss, 1, 1, p.mt * (Dp / p.bn_d), 1, inv_n};
    segs.s[nseg++] = Segment{grads, ws + p.part0, P, 2 * H, p.mt, 2 * H, 1.0f};
    segs.s[nseg++] = Segment{grads + lay.b(L - 1), ws + p.dbf, P, D, p.mt, Dp, 1.0f};
    // dW_i = A^T da_i with A (S_pad, H) read as (H, S_pad): both operands are row-contiguous along their columns.
    auto weight_grad = [&](int i, const MemSrc& a_src, const MemSrc& da) {
        const int out = i == L - 1 ? D : H;
        const bool split = p.chunks[i] > 1;
        const long long len = (long long)H * out;
        const DwEpi epi = split ? DwEpi{ws + p.dw[i], p.chunks[i] * len, len, out} : DwEpi{grads + lay.w(i), P, 0, out};
        if (split) segs.s[nseg++] = Segment{grads + lay.w(i), ws + p.dw[i], P, (int)len, p.chunks[i], (int)len, 1.0f};
        return product<false, false>(i == L - 1 ? p.bn_d : p.bn_h, H / tc::kBM, i == L - 1 ? Dp : H, N, a_src, da,
                                     epi, p.S_pad, p.kchunk[i], p.chunks[i], st);
    };
    RETURN_IF_ERROR(weight_grad(L - 1, h_last, MemSrc{ws + p.dy, dys, Dp}));
    // dh_{L-2} = dy Wf^T: Wf (H, Dp) is Wf^T's K-contiguous layout.
    RETURN_IF_ERROR((product<true, true>(p.bn_h, p.mt, H, N, MemSrc{ws + p.dy, dys, Dp}, wf,
                                         DaEpi{ws + p.g[L - 2], ws + p.da[0], act, H, p.mt, ws + p.db[L - 2]}, Dp, Dp,
                                         1, st)));
    for (int i = L - 2, cur = 0; i >= 1; --i, cur ^= 1) {
        const MemSrc da{ws + p.da[cur], act, H};
        segs.s[nseg++] = Segment{grads + lay.b(i), ws + p.db[i], P, H, p.mt, H, 1.0f};
        RETURN_IF_ERROR(weight_grad(i, MemSrc{ws + p.h[i - 1], act, H}, da));
        const MemSrc w{params + lay.w(i), P, H};
        if (i > 1) {
            const DaEpi epi{ws + p.g[i - 1], ws + p.da[cur ^ 1], act, H, p.mt, ws + p.db[i - 1]};
            RETURN_IF_ERROR((product<true, true>(p.bn_h, p.mt, H, N, da, w, epi, H, H, 1, st)));
        } else {
            RETURN_IF_ERROR((product<true, true>(p.bn_h, p.mt, H, N, da, w, FirstLayerEpi<FAST>{l0, p.mt, ws + p.part0},
                                                 H, H, 1, st)));
        }
    }

    // ---- Fixed-order sums of the partials ----
    int widest = 1;
    for (int k = 0; k < nseg; ++k) widest = std::max(widest, segs.s[k].len);
    const long long per = ((long long)N * widest + kFlatThreads - 1) / kFlatThreads;
    finish_kernel<<<dim3((unsigned)std::min<long long>(per, 2048), nseg), kFlatThreads, 0, st>>>(segs, N);
    return (int)cudaGetLastError();
}

}  // namespace

// Floats of workspace a step needs (N fits, S rows, width H, out D, L layers,
// on a card of `sms` SMs); -1 for a shape the kernels do not take (H not a
// multiple of 64, D not a multiple of 4, fewer than 3 or more than 8 layers).
extern "C" long long siren_train_workspace(int N, int S, int H, int D, int L, int sms) {
    Plan p;
    return plan_step(N, S, H, D, L, sms, &p) == 0 ? p.total : -1;
}

// params: (N, P) fp32 in the Layout order, 16-byte aligned; targets: (N, S, D)
// fp32; mult: (H,) fp32 or null; ws: siren_train_workspace(...) floats;
// grads: (N, P) fp32; loss: (N,) fp32. Launches the step on `stream` and
// returns the first failed launch's cudaGetLastError(), or 0.
extern "C" int siren_train_launch(const float* params, const float* targets, const float* mult, float* ws,
                                  float* grads, float* loss, int N, int S, int H, int D, int L, float omega,
                                  int fast, int sms, void* stream) {
    Plan p;
    const int status = plan_step(N, S, H, D, L, sms, &p);
    if (status != 0) return status;
    cudaStream_t st = (cudaStream_t)stream;
    return fast ? step<true>(p, params, targets, mult, ws, grads, loss, N, S, H, D, L, omega, st)
                : step<false>(p, params, targets, mult, ws, grads, loss, N, S, H, D, L, omega, st);
}

extern "C" const char* error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
