// Shared pieces of the SIREN kernels: the flat parameter layout (2A), the
// per-layer weight descriptors and loaders (dense fp32 or group-quantized
// codes), and the layer stack that runs a row tile through one net on the
// tensor cores, which the decode kernel (2B/2C/2E, siren_decode.cu) and the
// attention kernel (2D/2F, siren_attention.cu) share.
//
// The stack. A block of kThreads threads (16 warps for decode, 8 for
// attention) owns a tile of 16 to 128 rows. Its activations stay in one
// (rows x Hp) fp32 buffer in shared memory, Hp the hidden width padded to
// kHidMult. Layer 0, a (rows, 1) .
// (1, H) broadcast, is one SIMT FMA per value. Every hidden and final product
// is mma.sync m16n8k8 TF32 in three passes ("3xTF32", tf32_mma.cuh: a_lo b_hi
// + a_hi b_lo + a_hi b_hi, fp32 accumulation), with the activations as A
// (read from shared memory K-contiguous, as they lie) and the layer's (in,
// out) row-major W as B. The warps hold the whole layer's output in their
// accumulators (64 a thread at 16 warps), so the sine epilogue writes the
// next layer's activations over this layer's, once every warp has read them:
// one buffer, not two, which is what lets a tile reach 128 rows and halve
// the weights each row streams from L2.
//
// Wide nets. Where a layer's output no longer fits the accumulators of a
// 16-row tile (padded widths above 512 at 16 warps, 256 at 8), the tile
// kind is kTileWide: 16 rows whose two activation buffers lie in a scratch
// area of device memory the wrapper allocates (one per block; the blocks
// walk chunks of tiles), and each product runs in passes of kWideCols
// output columns, each pass writing its columns to the other buffer. Shared
// memory then holds only the weight stages, so no width is refused.
//
// W streams through shared memory in slabs of sk (8 to 32) rows and a pass's
// columns, in a ring of kStages stages that runs kStages - 1 slabs ahead of
// the products across layers, nets and tiles (SlabRing), so all warps of the
// block share one copy per tile and no product waits for its first slab. A
// dense slab lands by cp.async; a packed slab is dequantized as it is stored, code x scale
// rounded once in fp32 (__fmul_rn, the product ops/quantize.py takes on the
// host), before any hi/lo split. So the fp32 values that reach the tensor
// cores, and the order of every sum, are the same for packed weights and for
// the host-dequantized dense ones: 2E equals 2C and 2F equals 2D bit for bit.
//
// Widths. The stack computes Hp = H rounded up to kHidMult and Dp = D rounded
// up to kOutMult. Weight rows k >= rows and columns j >= cols of a layer, and
// bias entries j >= cols, read as zero: zero units carry exact zeros forward
// (sin 0 = 0 and their weights out are zero), so any width is taken as it
// lies. A dense layer whose rows are whole 16-byte pieces is staged by
// cp.async, any other layer value by value (LayerSlabs).
//
// What bounds it: the products at mma.sync's rate, then the weight stream
// (each tile reads its net's weights from L2 once, 0.66 MB for medium) and
// the barrier a slab costs, which small tiles cannot hide.
//
// bf16 (BF16, the decode kernel's compute_dtype=bfloat16 mode, the casting
// points of nerf_attention_tpu/ops/siren_pallas.py:_layer_stack and
// _flat_weights): every weight and bias is rounded to bf16 (round to nearest
// even) as it is read; the position and layer 0 stay fp32 (x * bf16(w0) +
// bf16(b0), then the fp32 sine); every hidden and final product is one
// mma.sync m16n8k16 bf16 pass with fp32 sums, in place of 3xTF32's three
// m16n8k8 passes; each hidden activation is rounded to bf16 after its fp32
// sine and kept in the fp32 buffer, where it is exact; the caller rounds the
// output. The weights stay fp32 in memory and in the stages (rounded in the
// fragment loads), so the ring, the tiles and the wide path are the fp32
// path's; slabs are at least 16 rows deep (one k16 step).
//
// bf16 activations (ACT16, the compute_dtype=bfloat16 mode of the kernels
// over packed weights, nerf_attention_tpu/ops/siren_quant_pallas.py: their
// weight views hand _layer_stack fp32 values, so jnp.dot(bf16 h, fp32 W)
// promotes to an fp32 product): weights and biases stay fp32, the products
// are the fp32 path's 3xTF32, and only the activations are rounded to bf16,
// layer 0's and each hidden layer's after its fp32 sine. A bf16 value is
// exact in TF32, so its lo part is 0 and the three passes give the fp32
// product of the rounded activation and the fp32 weight. Packed and dense
// records take it alike, so 2F in this mode on packed weights equals 2F on
// the host-dequantized weights as dense records bit for bit.
//
// Every sum is taken by one thread (a tensor-core fragment) in one order, so
// results do not change from run to run, nor with the tile's rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fastmath.cuh"
#include "tf32_mma.cuh"

namespace siren {

constexpr int kMaxLayers = 16;  // layers of a net a kernel takes
// Threads of a block: the including kernel may set SIREN_STACK_THREADS first
// (the attention kernel takes 256, as measured; the decode kernel 512).
#ifndef SIREN_STACK_THREADS
#define SIREN_STACK_THREADS 512
#endif
constexpr int kThreads = SIREN_STACK_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 64 * 512 / kThreads;  // accumulators a thread: a 128 x 256 layer output over the block
constexpr int kStages = 5;      // stages of the weight ring: kStages - 1 slabs in flight
constexpr int kMaxSlab = 32;    // weight rows of a slab, at most
constexpr int kHidMult = 32;    // hidden widths are padded to this (whole slabs of depth 8, 16 or 32)
constexpr int kOutMult = 8;     // output widths to this (one n8 fragment)
constexpr int kWideCols = 512;  // output columns a pass of a kTileWide product
constexpr int kMaxSmemBytes = 232448 - 2048;  // a block's, less SlabRing's static table

// The stack's arithmetic (the header's notes): fp32 (3xTF32 products), BF16
// (weights, biases and activations rounded to bf16, one bf16 pass a product)
// or ACT16 (fp32 weights and products, activations rounded to bf16).
enum Precision { kF32 = 0, kBF16 = 1, kAct16 = 2 };

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

enum WeightKind { kDense = 0, kInt8 = 1, kInt4 = 2, kInt6 = 3 };

// One layer of one net stack, as ops/siren_attention_cuda.py fills it: every
// field an int64, pointers included. Per-net strides are in elements.
// dense: w holds fp32 (R, C). int8: w holds signed codes (R, C). int4: w
// holds the nibble plane (ceil(R/2), C), row k in the low nibble of byte k,
// row k + ceil(R/2) in the high one. int6: w as int4 (the low four bits), w2
// the quarter plane (ceil(R/4), C) holding the top two bits of rows
// k + p ceil(R/4) at bit 2p. scale: (ceil(R/group), C) fp32; b: (C,) fp32.
struct LayerDesc {
    long long kind, rows, cols, group, qmax;
    long long w, w_stride, w2, w2_stride, scale, scale_stride, b, b_stride;
};

struct NetDesc {
    LayerDesc layer[kMaxLayers];
};

template <typename T>
__device__ __forceinline__ const T* at(long long ptr, long long stride, int n) {
    return reinterpret_cast<const T*>(ptr) + (size_t)n * stride;
}

struct Int8Codes {
    const signed char* __restrict__ c;
    int J;
    __device__ __forceinline__ int operator()(int k, int j) const { return __ldg(c + (size_t)k * J + j); }
};

struct Nibbles {
    const unsigned char* __restrict__ c;
    int J, half;
    __device__ __forceinline__ int operator()(int k, int j) const {
        const bool hi = k >= half;
        const int b = __ldg(c + (size_t)(hi ? k - half : k) * J + j);
        return hi ? b >> 4 : b & 0xF;
    }
};

struct Int4Codes {
    Nibbles low;
    int qmax;
    __device__ __forceinline__ int operator()(int k, int j) const { return low(k, j) - qmax; }
};

struct Int6Codes {
    Nibbles low;
    const unsigned char* __restrict__ top;
    int quarter, qmax;
    __device__ __forceinline__ int operator()(int k, int j) const {
        const int p = (k >= quarter) + (k >= 2 * quarter) + (k >= 3 * quarter);  // k / quarter
        const int t = (__ldg(top + (size_t)(k - p * quarter) * low.J + j) >> (2 * p)) & 0x3;
        return (low(k, j) | (t << 4)) - qmax;
    }
};

// W[k][j] = code(k, j) * scale[k / group][j], rounded once in fp32. gshift =
// log2(group) for a power of two (the usual case: k / group is a shift), else -1.
template <typename Codes>
struct GroupW {
    Codes code;
    const float* __restrict__ scale;
    int J, group, gshift;

    __device__ __forceinline__ float operator()(int k, int j) const {
        const int g = gshift >= 0 ? k >> gshift : k / group;
        return __fmul_rn((float)code(k, j), __ldg(scale + (size_t)g * J + j));
    }
};

template <typename Codes>
__device__ __forceinline__ GroupW<Codes> group_weights(Codes code, const float* scale, int J, int group) {
    return GroupW<Codes>{code, scale, J, group, (group & (group - 1)) == 0 ? __ffs(group) - 1 : -1};
}

// The per-warp product shapes the kernels are compiled for, as (MI, NI): MI
// m16 row fragments by at most NI n8 column fragments a warp (4 MI NI
// accumulators a thread). With 512 threads: rows 128 as 2 x 8 warps of 64 x
// 32 (4, 4), widths to 256; rows 64 as 2 x 8 of 32 x 64 (2, 8), widths to
// 512; rows 32 and 16 as 2 x 8 or 1 x 16 warps of 16 rows, (1, 4), widths to
// 256 and 512. These hold the whole layer's output. Wider nets take 16 rows
// as kTileWide, (1, 4) over passes of kWideCols columns. 256 threads halve
// the warps and double NI (kTile16 stays (1, 4), widths to 128 and 256).
enum TileKind { kTile128 = 0, kTile64 = 1, kTile16 = 2, kTileWide = 3, kInvalidTile = -1 };

// The shapes one tile runs at: true widths H, D; padded Hp, Dp; the tile's
// rows; its warp grid (wm warp rows by kWarps / wm warp columns); the slab
// depth sk; the activation row stride lda, the output columns of a product's
// pass cw and the slab row stride lds. lda is the wider of Hp and Dp rounded
// up to 32, plus 4, and lds is cw plus 8: an A fragment load of a warp (rows
// g, columns t) then hits banks 4g + t and a B fragment load (rows t, columns
// g) banks 8t + g, all 32 distinct.
struct StackShape {
    int H, D, Hp, Dp, rows, wm, sk, lda, lds, kind, cw;

    __host__ __device__ bool wide() const { return kind == kTileWide; }
    __host__ __device__ int stage_floats() const { return sk * lds; }
    // Shared-memory floats of the stack: the activations (but for a wide tile's) and the weight stages.
    __host__ __device__ int floats() const { return (wide() ? 0 : rows * lda) + kStages * stage_floats(); }
    // Device-memory floats a block of a wide tile needs for its two activation buffers.
    __host__ __device__ int scratch_floats() const { return wide() ? 2 * rows * lda : 0; }
    __host__ __device__ int wn() const { return kWarps / wm; }
    __host__ __device__ int passes(int J) const { return (J + cw - 1) / cw; }
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr int tile_mi(int kind) { return kind == kTile128 ? 4 : kind == kTile64 ? 2 : 1; }
__host__ __device__ constexpr int tile_ni(int kind) {
    return kind == kTile16 ? 4 : kind == kTileWide ? kWideCols / 8 / kWarps : kAcc / 4 / tile_mi(kind);
}

// The stack's shape for a tile of `rows` rows (16, 32, 64 or 128), its
// kernel instance, and the deepest slab (32, 16 or 8 weight rows, at least
// min_sk: fewer barriers a layer) that keeps it and `extra_floats` of the
// caller's within a block's shared memory; sk = 0 when the tile does not take
// these widths.
__host__ __device__ inline StackShape stack_shape(int H, int D, int rows, int extra_floats, int min_sk = 8) {
    StackShape sh{H, D, round_up(H, kHidMult), round_up(D, kOutMult), rows, rows == 16 ? 1 : 2, 0, 0, 0,
                  kInvalidTile, 0};
    const int wide = round_up(sh.Hp > sh.Dp ? sh.Hp : sh.Dp, 32);
    sh.lda = wide + 4;
    const int cols = wide / 8;  // n8 column fragments of the widest layer
    if (rows == 128 || rows == 64) {
        sh.kind = rows == 128 ? kTile128 : kTile64;
    } else if (rows == 32 || rows == 16) {
        sh.kind = cols <= tile_ni(kTile16) * sh.wn() ? kTile16 : rows == 16 ? kTileWide : kInvalidTile;
    }
    if (sh.kind == kInvalidTile || (!sh.wide() && cols > tile_ni(sh.kind) * sh.wn())) return sh;
    sh.cw = sh.wide() ? kWideCols : wide;
    sh.lds = sh.cw + 8;
    for (int sk = kMaxSlab; sk >= min_sk; sk /= 2) {
        sh.sk = sk;
        if ((sh.floats() + extra_floats) * (int)sizeof(float) <= kMaxSmemBytes) return sh;
    }
    sh.sk = 0;
    return sh;
}

// Calls f(value) with the layer's weight reader for net n, value(k, j) = W[k][j] in fp32 (k < rows, j < cols):
// the dense fp32 value, or code x scale rounded once (GroupW) for packed codes. The one dispatch on the weight
// kind: the stack's slab loader and the wgmma kernels' piece split (siren_wgmma.cuh) both read through it.
template <typename F>
__device__ __forceinline__ void layer_weights(const LayerDesc& d, int n, F f) {
    const int rows = (int)d.rows, cols = (int)d.cols, group = (int)d.group, qmax = (int)d.qmax;
    const float* scale = at<float>(d.scale, d.scale_stride, n);
    const int half = (rows + 1) / 2;
    switch ((int)d.kind) {
        case kInt8:
            f(group_weights(Int8Codes{at<signed char>(d.w, d.w_stride, n), cols}, scale, cols, group));
            break;
        case kInt4:
            f(group_weights(Int4Codes{{at<unsigned char>(d.w, d.w_stride, n), cols, half}, qmax}, scale, cols,
                            group));
            break;
        case kInt6:
            f(group_weights(Int6Codes{{at<unsigned char>(d.w, d.w_stride, n), cols, half},
                                      at<unsigned char>(d.w2, d.w2_stride, n), (rows + 3) / 4, qmax},
                            scale, cols, group));
            break;
        default: {
            const float* w = at<float>(d.w, d.w_stride, n);
            f([&](int k, int j) { return __ldg(w + (size_t)k * cols + j); });
        }
    }
}

// One layer's weights as slabs: fill(s, k0, c0, n_cols) puts W[k0 + r][c0 +
// c], r < sk, c < n_cols (a multiple of 8), into s[r * lds + c], zero outside the
// layer's rows and cols: a packed slab dequantized, a dense one whose rows
// are not 16-byte aligned loaded one value at a time. (Aligned dense slabs
// go by cp.async: SlabRing.)
struct LayerSlabs {
    const LayerDesc& d;  // in the kernel's parameter space (__grid_constant__)
    int n;               // which net

    // Scalar stores: thread i takes rows i / 64 + kRowStep q, columns i % 64 +
    // 64 c; the rows of one column are loaded before any is stored.
    template <typename Value>
    __device__ __forceinline__ void store(float* s, int lds, int sk, int k0, int c0, int n_cols,
                                          Value value) const {
        constexpr int kRowStep = kThreads / 64;
        constexpr int kRowsPer = kMaxSlab / kRowStep;
        const int rows = (int)d.rows, cols = (int)d.cols;
        const int r0 = threadIdx.x / 64;
        for (int c = threadIdx.x % 64; c < n_cols; c += 64) {
            float v[kRowsPer];
#pragma unroll
            for (int q = 0; q < kRowsPer; ++q) {
                const int r = r0 + kRowStep * q;
                v[q] = r < sk && k0 + r < rows && c0 + c < cols ? value(k0 + r, c0 + c) : 0.f;
            }
#pragma unroll
            for (int q = 0; q < kRowsPer; ++q)
                if (r0 + kRowStep * q < sk) s[(r0 + kRowStep * q) * lds + c] = v[q];
        }
    }

    __device__ void fill(float* s, int lds, int sk, int k0, int c0, int n_cols) const {
        layer_weights(d, n, [&](auto value) { store(s, lds, sk, k0, c0, n_cols, value); });
    }

    __device__ __forceinline__ float bias(int j) const {
        return j < (int)d.cols ? __ldg(at<float>(d.b, d.b_stride, n) + j) : 0.f;
    }
};

// A layer's slab source, resolved once per kernel: its descriptor, the
// width J its product computes at (Hp, or Dp for the final layer), and for a
// dense layer whose rows are whole 16-byte pieces (direct) this net's W, its
// rows and cols; any other layer goes through LayerSlabs::fill. `next` is the
// source of the layer that follows in the block's run.
struct SlabSrc {
    const LayerDesc* desc;
    const float* w;
    int J, rows, cols, direct, next;
};

// The weight slabs of a block's whole run, in the order its products take
// them: for each of `tiles` row tiles, for each net (one, or the key net then
// the value net), layers 1..L-1, each pass of each layer in Hp / sk slabs of
// the pass's columns (one pass but on a wide tile). They stream through a
// ring of kStages stages, kStages - 1 slabs ahead of the products, across
// layer, net and tile boundaries: no product waits for its first slab. Every
// thread holds the same few counters; the rest is in a shared table.
struct SlabRing {
    const StackShape& sh;  // the kernel's (__grid_constant__)
    float* stages;
    SlabSrc* srcs;  // (net, layer) -> source, in shared memory
    int n, left;    // the net index of the block, slabs left to fill
    int fetch = 0;  // the next slab to fill: its stage,
    int src = 1;    // its layer's source
    int k0 = 0;     // its first weight row
    int c0 = 0;     // and its pass's first column
    int use = 0;    // the next slab a product takes

    // Resolves the layers' sources (every thread takes part; ends with a
    // barrier), then fills the first kStages - 1 slabs.
    __device__ SlabRing(const NetDesc* a, const NetDesc* b, int n_nets, int L, int n_, int tiles,
                        const StackShape& sh_, float* stages_, SlabSrc* srcs_)
        : sh(sh_), stages(stages_), srcs(srcs_), n(n_) {
        left = tiles * n_nets * ((L - 2) * sh.passes(sh.Hp) + sh.passes(sh.Dp)) * (sh.Hp / sh.sk);
        for (int e = threadIdx.x; e < n_nets * kMaxLayers; e += blockDim.x) {
            const int net = e / kMaxLayers, i = e % kMaxLayers;
            if (i == 0 || i >= L) continue;
            const LayerDesc& d = (net == 0 ? a : b)->layer[i];
            const int next = i + 1 < L ? e + 1 : (net + 1) % n_nets * kMaxLayers + 1;
            srcs[e] = SlabSrc{&d, at<float>(d.w, d.w_stride, n), i == L - 1 ? sh.Dp : sh.Hp, (int)d.rows,
                              (int)d.cols,
                              d.kind == kDense && d.cols % 4 == 0 && d.w % 16 == 0 && d.w_stride % 4 == 0, next};
        }
        __syncthreads();
        for (int s = 0; s < kStages - 1; ++s) fill_next();
    }

    __device__ float* stage(int slab) const { return stages + (slab % kStages) * sh.stage_floats(); }

    // Fills the next slab (if any is left) and commits it as one cp.async group.
    __device__ void fill_next() {
        if (left > 0) {
            float* s = stage(fetch);
            const SlabSrc& l = srcs[src];
            const int n_cols = min(sh.cw, l.J - c0);
            if (l.direct) {
                // 16-byte pieces: thread i takes piece i % pieces of rows i / pieces + step q.
                const int pieces = n_cols / 4;
                const int step = kThreads / pieces;
                if (threadIdx.x < step * pieces) {
                    const int c = (threadIdx.x % pieces) * 4;
                    for (int r = threadIdx.x / pieces; r < sh.sk; r += step) {
                        float* dst = s + r * sh.lds + c;
                        if (k0 + r < l.rows && c0 + c < l.cols) {
                            tc::cp_async16(dst, l.w + (size_t)(k0 + r) * l.cols + c0 + c);
                        } else {
                            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
                        }
                    }
                }
            } else {
                LayerSlabs{*l.desc, n}.fill(s, sh.lds, sh.sk, k0, c0, n_cols);
            }
            --left;
            k0 += sh.sk;
            if (k0 == sh.Hp) {
                k0 = 0;
                c0 += sh.cw;
                if (c0 >= l.J) {
                    c0 = 0;
                    src = l.next;
                }
            }
        }
        ++fetch;
        tc::cp_async_commit();
    }

    // Waits for slab `use`, refills the stage every warp has just finished
    // with, and returns slab `use`'s stage.
    __device__ const float* next() {
        tc::cp_async_wait<kStages - 2>();
        __syncthreads();  // slab `use` has landed, and every warp is done with slab use - 1
        fill_next();
        return stage(use++);
    }
};

// bf16 helpers: x rounded to bf16 (to nearest even) and back; two floats as
// one register of two bf16 (lo in the low half, as a fragment holds the lower
// column or k index there); d += a . b for one 16x8x16 tile, a row-major
// (16 x 16) bf16, b column-major (16 x 8) bf16, fp32 sums.
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a . b over one slab in bf16 (sk a multiple of 16), the operands
// rounded to bf16 as their fragments load: a0 (row g, k 2t, 2t + 1), a1 (g +
// 8, the same k), a2, a3 (g, g + 8; k 2t + 8, 2t + 9); b0 (k 2t, 2t + 1, column
// g), b1 (k 2t + 8, 2t + 9). The loop order is slab_mma's.
template <int MI, int NI>
__device__ __forceinline__ void slab_mma_bf16(float (&acc)[MI][NI][4], const float* a, int lda,
                                              const float* __restrict__ b, int lds, int sk, int wn, int ni_n) {
    const int g = (threadIdx.x % 32) / 4;
    const int t = threadIdx.x % 4;
    auto load_a = [&](int mi, int kk, uint32_t (&f)[4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float* p = a + (mi * 16 + g + (r & 1) * 8) * lda + kk + 2 * t + (r >> 1) * 8;
            f[r] = pack_bf16(p[0], p[1]);
        }
    };
    auto load_b = [&](int ni, int kk, uint32_t (&f)[2]) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float* p = b + (kk + 2 * t + r * 8) * lds + ni * wn * 8 + g;
            f[r] = pack_bf16(p[0], p[lds]);
        }
    };
    for (int kk = 0; kk < sk; kk += 16) {
        if (MI * 2 > NI) {
            uint32_t bf[NI][2];
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
                if (ni < ni_n) load_b(ni, kk, bf[ni]);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
                uint32_t af[4];
                load_a(mi, kk, af);
#pragma unroll
                for (int ni = 0; ni < NI; ++ni)
                    if (ni < ni_n) mma_bf16(acc[mi][ni], af, bf[ni]);
            }
        } else {
            uint32_t af[MI][4];
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) load_a(mi, kk, af[mi]);
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
                if (ni < ni_n) {
                    uint32_t bf[2];
                    load_b(ni, kk, bf);
#pragma unroll
                    for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][ni], af[mi], bf);
                }
        }
    }
}

// acc += a . b over one slab: a the warp's MI x 16 rows of the activations
// (row stride lda, from the slab's first column; in shared memory, or in a
// wide tile's device scratch, which this block wrote), b the slab (row stride lds)
// at the warp's first column; the warp's n8 fragments are every wn-th, ni_n
// of them. Each value is split into TF32 hi/lo as it is read; each product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi in that order. The loop order keeps the
// fewer fragments live (all of B and one row fragment of A at a time when A
// has more; else all of A and one column fragment of B); every accumulator
// sees the same products in the same order either way.
template <int MI, int NI>
__device__ __forceinline__ void slab_mma(float (&acc)[MI][NI][4], const float* a, int lda,
                                         const float* __restrict__ b, int lds, int sk, int wn, int ni_n) {
    const int g = (threadIdx.x % 32) / 4;
    const int t = threadIdx.x % 4;
    auto load_a = [&](int mi, int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r)  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
            tc::split_tf32(a[(mi * 16 + g + (r & 1) * 8) * lda + kk + t + (r >> 1) * 4], hi[r], lo[r]);
    };
    auto load_b = [&](int ni, int kk, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
#pragma unroll
        for (int r = 0; r < 2; ++r)  // b0 (k = t, n = g), b1 (k = t + 4, n = g)
            tc::split_tf32(b[(kk + t + r * 4) * lds + ni * wn * 8 + g], hi[r], lo[r]);
    };
    auto mma3 = [&](float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], const uint32_t (&bh)[2],
                    const uint32_t (&bl)[2]) {
        tc::mma_tf32(d, al, bh);
        tc::mma_tf32(d, ah, bl);
        tc::mma_tf32(d, ah, bh);
    };
    for (int kk = 0; kk < sk; kk += 8) {
        if (MI * 2 > NI) {
            uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
                if (ni < ni_n) load_b(ni, kk, bh[ni], bl[ni]);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
                uint32_t ah[4], al[4];
                load_a(mi, kk, ah, al);
#pragma unroll
                for (int ni = 0; ni < NI; ++ni)
                    if (ni < ni_n) mma3(acc[mi][ni], ah, al, bh[ni], bl[ni]);
            }
        } else {
            uint32_t ah[MI][4], al[MI][4];
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) load_a(mi, kk, ah[mi], al[mi]);
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
                if (ni < ni_n) {
                    uint32_t bh[2], bl[2];
                    load_b(ni, kk, bh, bl);
#pragma unroll
                    for (int mi = 0; mi < MI; ++mi) mma3(acc[mi][ni], ah[mi], al[mi], bh, bl);
                }
        }
    }
}

// One product of the tile: acc = act (rows x Hp) . W (Hp x J) over the
// layer's slabs from the ring, in passes of sh.cw columns (one but on a
// wide tile, WIDE); after each pass, once every warp is done reading act,
// epi(r, j, acc + b_j) for each element (r < rows, j of the pass), which may
// overwrite act when there is one pass. The warp's rows are (warp / wn) * MI
// * 16 on; its columns of a pass are the n8 blocks warp % wn + wn * ni.
// BF16: the products in bf16 and b_j rounded to bf16.
template <int MI, int NI, bool WIDE, bool BF16 = false, typename Epi>
__device__ __forceinline__ void product(SlabRing& ring, const float* act, const LayerSlabs& W, int J,
                                        const StackShape& sh, Epi epi) {
    const int warp = threadIdx.x / 32;
    const int wn = sh.wn();
    const int row0 = (warp / wn) * MI * 16;
    const int col0 = (warp % wn) * 8;
    const int g = (threadIdx.x % 32) / 4;
    const int t = threadIdx.x % 4;
    for (int p0 = 0; p0 < (WIDE ? J : 1); p0 += sh.cw) {
        const int cols = WIDE ? min(sh.cw, J - p0) : J;
        const int ni_n = (cols / 8 - warp % wn + wn - 1) / wn;  // the warp's n8 blocks of the pass
        float acc[MI][NI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
        for (int k0 = 0; k0 < sh.Hp; k0 += sh.sk) {
            const float* b = ring.next();
            if (BF16) {
                slab_mma_bf16<MI, NI>(acc, act + row0 * sh.lda + k0, sh.lda, b + col0, sh.lds, sh.sk, wn, ni_n);
            } else {
                slab_mma<MI, NI>(acc, act + row0 * sh.lda + k0, sh.lda, b + col0, sh.lds, sh.sk, wn, ni_n);
            }
        }
        __syncthreads();  // every warp is done reading act
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
            if (ni < ni_n) {
                const int j = p0 + col0 + ni * wn * 8 + 2 * t;
                const float b0 = BF16 ? round_bf16(W.bias(j)) : W.bias(j);
                const float b1 = BF16 ? round_bf16(W.bias(j + 1)) : W.bias(j + 1);
#pragma unroll
                for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                    for (int q = 0; q < 4; ++q)  // c0, c1 (g, 2t + q), c2, c3 (g + 8, 2t + q)
                        epi(row0 + mi * 16 + g + (q >> 1) * 8, j + (q & 1), acc[mi][ni][q] + (q & 1 ? b1 : b0));
            }
    }
}

// One net (n of the NetDesc, whose slabs come next in the ring) over the
// tile's positions xs: layer 0 into act, the hidden sine layers in place (a
// layer's whole output is in registers before act is overwritten) or, on a
// wide tile (WIDE), from one of act and act2 into the other, then the final linear
// handed to epi(r, j, y) for j < D. Layer 0 must be dense. FM multipliers
// mult (H,) or null. Starts with act free and xs written (the caller's
// barrier); ends after epi, which the caller fences. PREC: the arithmetic
// (Precision; with kBF16 y is an fp32 sum of bf16 products plus bf16(b)).
template <int MI, int NI, bool WIDE, bool FAST, int PREC = kF32, typename Epi>
__device__ __forceinline__ void net_tile(SlabRing& ring, const NetDesc& net, int L, int n, const StackShape& sh,
                                         const float* xs, const float* mult, float omega, float* act, float* act2,
                                         Epi epi) {
    constexpr bool BF16 = PREC == kBF16;
    constexpr bool ROUND_ACT = PREC != kF32;
    const LayerDesc& l0 = net.layer[0];
    const float* w0 = at<float>(l0.w, l0.w_stride, n);
    const float* b0 = at<float>(l0.b, l0.b_stride, n);
    // Element e = r * Hp + j, walked with a stride of blockDim.x without dividing in the loop.
    const int step_r = blockDim.x / sh.Hp, step_j = blockDim.x % sh.Hp;
    for (int r = threadIdx.x / sh.Hp, j = threadIdx.x % sh.Hp; r < sh.rows;) {
        float h = 0.f;
        if (j < sh.H) {
            const float scale = mult != nullptr ? omega * mult[j] : omega;
            h = BF16        ? round_bf16(act_sin<FAST>(scale * (xs[r] * round_bf16(w0[j]) + round_bf16(b0[j]))))
                : ROUND_ACT ? round_bf16(act_sin<FAST>(scale * (xs[r] * w0[j] + b0[j])))
                            : act_sin<FAST>(scale * (xs[r] * w0[j] + b0[j]));
        }
        act[r * sh.lda + j] = h;
        r += step_r;
        j += step_j;
        if (j >= sh.Hp) {
            j -= sh.Hp;
            ++r;
        }
    }
    float* cur = act;
    float* nxt = WIDE ? act2 : act;
    for (int i = 1; i < L - 1; ++i) {
        product<MI, NI, WIDE, BF16>(ring, cur, LayerSlabs{net.layer[i], n}, sh.Hp, sh, [&](int r, int j, float z) {
            const float h = act_sin<FAST>(omega * z);
            nxt[r * sh.lda + j] = ROUND_ACT ? round_bf16(h) : h;
        });
        if (WIDE) {
            float* done = cur;
            cur = nxt;
            nxt = done;
        }
    }
    product<MI, NI, WIDE, BF16>(ring, cur, LayerSlabs{net.layer[L - 1], n}, sh.Dp, sh, [&](int r, int j, float y) {
        if (j < sh.D) epi(r, j, y);
    });
}

// Whether the kernels take this net: 2..kMaxLayers layers, layer 0 dense.
inline bool net_ok(const NetDesc& net, int L) {
    return L >= 2 && L <= kMaxLayers && net.layer[0].kind == kDense;
}

}  // namespace siren
