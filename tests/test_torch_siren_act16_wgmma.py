"""The bf16 modes of kernels 2E and 2F on Hopper (``csrc/siren_decode_act16.cu``,
``csrc/siren_attention_wgmma.cu``, over ``csrc/siren_wgmma.cuh``), emulated on the CPU.

Their arithmetic (the header's note): each fp32 weight, dense or dequantized
(code x scale rounded once), is split into three bf16 pieces, w1 = bf16(w),
w2 = bf16(w - w1), w3 = bf16(w - w1 - w2), whose sum is w exactly; every
hidden and final product is three bf16 chains into one fp32 accumulator set,
w3's first. These tests mirror the kernels' index arithmetic and order in
numpy / torch:

* the split, exact over fp32 magnitudes from 1e-30 to 1e30;
* the split pre-pass's weight reads for every scheme the port packs (the
  loaders of ``csrc/siren_common.cuh``: int8 codes, int4 nibble planes, int6
  nibble and quarter planes, fp16-valued group scales), equal bit for bit to
  ``ops/quantize.py``'s host dequant;
* the pieces as the pre-pass writes them (wgmma's B layout, the consumers'
  order), read back through the descriptor;
* whole 2E nets and 2F calls computed the kernels' way, against the plain
  versions and against the JAX package's Pallas kernels in interpret mode, held
  to ULPS bf16 ulps of the largest |output| (ULPS * 2^-8 * max|y|);
* the rule that sends a call to these kernels (``attention_route``, and
  ``bf16_route`` for 2E), and the standing difference from the layer stack:
  the three pieces keep all 24 bits of w where 3xTF32 keeps about 22.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_attention_tpu.ops.siren_quant_pallas import (
    siren_attention_decode_quant as jax_attn_quant,
    siren_decode_batch_quant as jax_decode_quant,
)
from nerf_attention_tpu_torch.models.siren import fm_frequency_multipliers, positions
from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
from nerf_attention_tpu_torch.ops import siren_cuda
from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
from nerf_attention_tpu_torch.ops._launch import chunking
from nerf_attention_tpu_torch.ops.fastmath import fast_sin
from nerf_attention_tpu_torch.ops.qat import fake_quant_int4
from nerf_attention_tpu_torch.ops.quantize import quantize_params
from test_torch_siren_attention import attention_inputs, siren_heads, to_jax, to_torch
from test_torch_siren_decode import _matmul_3xtf32
from test_torch_siren_decode_bf16_route import _b_tile_through_descriptor, _sin_reduced

torch.set_num_threads(1)

CSRC = Path(siren_cuda.__file__).resolve().parent.parent / "csrc"
HEADER = (CSRC / "siren_wgmma.cuh").read_text()
ULPS = 4  # tests/test_torch_siren_attention_bf16.py
PIECE = 64
BF16 = torch.bfloat16
SMS = 132  # an H100's SMs: the attention kernel's chunking


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).float()


def split3(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """split3 of csrc/siren_wgmma.cuh in fp32: (w3, w2, w1), the chains' order."""
    w = w.float()
    w1 = _bf16(w)
    r1 = w - w1
    w2 = _bf16(r1)
    return _bf16(r1 - w2), w2, w1


def _ulps(got, want) -> float:
    """|got - want| in bf16 ulps of max|want|, asserted within ULPS."""
    got, want = (np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32), np.float64)
                 for x in (got, want))
    gap = float(np.abs(got - want).max()) / (2.0**-8 * float(np.abs(want).max()))
    assert gap <= ULPS, gap
    return gap


# ---- the split ----

@pytest.mark.parametrize("magnitude", [1e-30, 1e-20, 1e-8, 1e-3, 0.05, 1.0, 3e3, 1e20, 1e30],
                         ids=lambda m: f"{m:g}")
def test_three_pieces_sum_to_the_weight_exactly(magnitude):
    """w1 + w2 + w3 = w for every fp32 value of the range (random sign and significand, exponents within a factor
    of 2^8 around the magnitude, so above the header's 2^-110, where w3's bits would reach bf16's subnormals);
    each piece a bf16 value, each no larger than the last."""
    rng = np.random.default_rng(int(np.log10(magnitude) * 10) % 2**32)
    sign = rng.choice([-1.0, 1.0], 20_000)
    w = (sign * rng.uniform(1, 2, 20_000) * magnitude * 2.0 ** rng.integers(-8, 8, 20_000)).astype(np.float32)
    w3, w2, w1 = split3(torch.from_numpy(w))
    for piece in (w1, w2, w3):
        assert torch.equal(piece, _bf16(piece))
    total = w1.double() + w2.double() + w3.double()
    assert torch.equal(total, torch.from_numpy(w).double())
    assert torch.equal((w3 + w2) + w1, torch.from_numpy(w))  # the chains' order, in fp32: exact too
    assert bool((w2.abs() <= w1.abs()).all() and (w3.abs() <= w2.abs()).all())


# ---- the pre-pass's weight reads ----

def _loader_weights(entry, layer_ops, n: int) -> np.ndarray:
    """W of net n as siren_common.cuh's loaders read it (layer_weights): dense fp32, or code(k, j) x scale[k /
    group][j] rounded once in fp32, the codes read as the device reads them: int8 signed; int4 row k in byte k's low
    nibble (k < ceil(R/2)) or byte k - ceil(R/2)'s high one, minus qmax; int6 the same four bits or'd with bits 2p,
    2p + 1 of quarter-plane byte k - p ceil(R/4), p = k / ceil(R/4)."""
    kind = entry[0]
    if kind == "dense":
        return layer_ops[0][n].float().numpy()
    _, rows, cols, group, qmax = entry
    k = np.arange(rows)[:, None]
    j = np.arange(cols)[None, :]
    if kind == "int8":
        code = layer_ops[0][n].numpy().astype(np.int64)
    else:
        plane = layer_ops[0][n].numpy().view(np.uint8).astype(np.int64)
        half = (rows + 1) // 2
        hi = k >= half
        byte = plane[np.where(hi, k - half, k), j]
        low = np.where(hi, byte >> 4, byte & 0xF)
        if kind == "int6":
            quarter = (rows + 3) // 4
            top = layer_ops[1][n].numpy().view(np.uint8).astype(np.int64)
            p = (k >= quarter).astype(np.int64) + (k >= 2 * quarter) + (k >= 3 * quarter)
            low = low | (((top[k - p * quarter, j] >> (2 * p)) & 3) << 4)
        code = low - qmax
    scale = layer_ops[-2][n].numpy()
    return code.astype(np.float32) * scale[k // group, j]


SCHEMES = ["fp32", "bf16", "fp16", "int8", "int4", "int6_g64", "int8_g32_l0fp32", "int4_qat", "int4_g6"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_prepass_reads_the_host_dequant_then_splits_it_exactly(scheme):
    """The pre-pass's fp32 weights of every layer it splits (1..L-1) equal ops/quantize.py's host dequant bit for
    bit (so packed weights and their dequant shipped dense give the kernels the same pieces), and their three pieces
    sum to them. int4_qat: weights on the int4 grid, as QAT leaves them, packed as int4."""
    params = [(torch.tensor(w), torch.tensor(b)) for w, b in siren_heads(2, 76, 2, seed=5, d=20)]
    packer = scheme
    if scheme == "int4_qat":
        params = [params[0]] + [(fake_quant_int4(w), b) for w, b in params[1:]]
        packer = "int4"
    ops, layout = sq.pack_resident_params(params, packer)
    layers = list(sq._layers(ops, layout))
    for n in range(2):
        dequant = quantize_params([(w[n].numpy(), b[n].numpy()) for w, b in params], packer)[1]
        for li in range(1, len(layout)):
            entry, layer_ops = layers[li]
            got = _loader_weights(entry, layer_ops, n)
            want = np.asarray(dequant[li][0], np.float32)
            assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32)), (li, entry)
            w3, w2, w1 = split3(torch.from_numpy(got))
            assert torch.equal(w1.double() + w2.double() + w3.double(), torch.from_numpy(got).double())
    kinds = {e[0] for e in layout[1:]}
    assert kinds == ({"int4"} if scheme in ("int4", "int4_qat", "int4_g6") else {"int6"} if scheme == "int6_g64"
                     else {"int8"} if scheme == "int8_g32_l0fp32" else {"dense"})


# ---- the pieces: layout and order ----

def _region_pieces(w: torch.Tensor, ka: int, c: int) -> list[np.ndarray]:
    """split_kernel's three pieces of region (k atom ka, chunk c) of W (rows, cols), as it writes them: 4096 bf16
    bits each (w3, w2, w1); item e (row e / 16, quad e % 16) stores columns 4 quad .. + 3 of the row at byte row * 128
    + ((quad >> 1) ^ (row % 8)) * 16 + (quad & 1) * 8, zero past the layer's rows and columns."""
    rows, cols = w.shape
    region = torch.zeros(PIECE, PIECE)
    r, cc = min(PIECE, rows - ka * PIECE), min(PIECE, cols - c * PIECE)
    region[:r, :cc] = w[ka * PIECE:ka * PIECE + r, c * PIECE:c * PIECE + cc]
    out = []
    for piece in split3(region):
        bits = piece.to(BF16).view(torch.int16).numpy().astype(np.uint16)
        stage = np.zeros(PIECE * PIECE, np.uint16)
        for e in range(PIECE * PIECE // 4):
            row, quad = e // 16, e % 16
            byte = row * 128 + (((quad >> 1) ^ (row & 7)) << 4) + (quad & 1) * 8
            stage[byte // 2:byte // 2 + 4] = bits[row, 4 * quad:4 * quad + 4]
        out.append(stage)
    return out


def _read_back(stage: np.ndarray) -> torch.Tensor:
    """A piece as wgmma's B operand reads it, k step by k step, through the descriptor."""
    tile = np.concatenate([_b_tile_through_descriptor(stage, kk) for kk in range(4)])
    return torch.from_numpy(tile.astype(np.int16)).view(BF16).float()


@pytest.mark.parametrize("rows, cols, ka, c", [(256, 256, 2, 1), (96, 20, 1, 0), (64, 128, 0, 1), (76, 76, 1, 1)],
                         ids=["medium", "partial", "final", "corner"])
def test_pieces_read_back_through_the_descriptor(rows, cols, ka, c):
    w = torch.randn(rows, cols, generator=torch.Generator().manual_seed(rows * cols)) * 0.1
    want = torch.zeros(PIECE, PIECE)
    r, cc = min(PIECE, rows - ka * PIECE), min(PIECE, cols - c * PIECE)
    want[:r, :cc] = w[ka * PIECE:ka * PIECE + r, c * PIECE:c * PIECE + cc]
    got = [_read_back(stage) for stage in _region_pieces(w, ka, c)]
    for g, expected in zip(got, split3(want)):
        assert torch.equal(g, expected)
    assert torch.equal(got[0].double() + got[1].double() + got[2].double(), want.double())


def _pieces_per_net(hidden: int, d: int, n_layers: int) -> int:
    ka, dch = -(-hidden // PIECE), -(-d // PIECE)
    return 3 * ka * ((n_layers - 2) * ka + dch)


@pytest.mark.parametrize("hidden, d, n_layers", [(256, 128, 4), (128, 128, 3), (96, 20, 5)],
                         ids=["medium", "small", "odd-deep"])
def test_prepass_writes_the_pieces_in_the_consumers_order(hidden, d, n_layers):
    """Every region the pre-pass's blocks split (block q: layer i, chunk c, k atom ka) lands where the consumers'
    walk (layer, chunk, split w3 / w2 / w1, k atom) takes it, and the walk covers the net's pieces once. The index
    expressions are the sources' own."""
    assert "const int first = ((i - 1) * hch + c) * SPLITS * KA + ka;" in HEADER
    assert "const int pc = p + (c * SPLITS + sp) * KA + ka;" in HEADER
    assert "return splits * KA * ((L - 2) * KA + dch);" in HEADER
    assert "split_launch<SPLITS>(knet, vnet, N, 2 * N, L, H, D, pieces, st)" in (CSRC / "siren_attention_wgmma.cu"
                                                                                ).read_text()
    assert "split_launch<kSplits>(net, net, N, N, L, H, D, pieces, st)" in (CSRC / "siren_decode_act16.cu").read_text()
    gen = torch.Generator().manual_seed(hidden + d)
    weights = [torch.randn(hidden, hidden if i < n_layers - 1 else d, generator=gen) for i in range(1, n_layers)]
    ka_n, hch, dch = -(-hidden // PIECE), -(-hidden // PIECE), -(-d // PIECE)
    buffer: dict[int, np.ndarray] = {}
    hidden_regions = (n_layers - 2) * hch * ka_n
    for q in range(hidden_regions + dch * ka_n):  # split_kernel's blocks
        i = 1 + q // (hch * ka_n) if q < hidden_regions else n_layers - 1
        rem = q % (hch * ka_n) if q < hidden_regions else q - hidden_regions
        c, ka = rem // ka_n, rem % ka_n
        first = ((i - 1) * hch + c) * 3 * ka_n + ka
        for sp, stage in enumerate(_region_pieces(weights[i - 1], ka, c)):
            assert first + sp * ka_n not in buffer
            buffer[first + sp * ka_n] = stage
    assert sorted(buffer) == list(range(_pieces_per_net(hidden, d, n_layers)))
    p = 0
    for i in range(1, n_layers):  # Consumer::layer's walk
        nch = dch if i == n_layers - 1 else hch
        for c in range(nch):
            for sp in range(3):
                for ka in range(ka_n):
                    pc = p + (c * 3 + sp) * ka_n + ka
                    want = torch.zeros(PIECE, PIECE)
                    w = weights[i - 1]
                    r, cc = min(PIECE, w.shape[0] - ka * PIECE), min(PIECE, w.shape[1] - c * PIECE)
                    want[:r, :cc] = w[ka * PIECE:ka * PIECE + r, c * PIECE:c * PIECE + cc]
                    assert torch.equal(_read_back(buffer[pc]), split3(want)[sp]), (i, c, sp, ka)
        p += nch * 3 * ka_n
    assert p == _pieces_per_net(hidden, d, n_layers)



@pytest.mark.parametrize("hidden, d, n_layers", [(256, 128, 4), (128, 128, 3), (96, 20, 5), (64, 128, 3)],
                         ids=["medium", "small", "odd-deep", "tiny"])
def test_card_pieces_emulation_is_the_split_pass(hidden, d, n_layers):
    """tests/test_torch_cuda.py's ``act16_pieces``, which the card test holds the split pass's device buffer to bit
    for bit, equals the region-by-region emulation above laid out in the consumers' order, over weights whose
    magnitudes span 1e-6 to 1e3 (so w2 and w3 are not zero)."""
    from test_torch_cuda import act16_pieces

    gen = torch.Generator().manual_seed(hidden * n_layers + d)
    weights = []
    for i in range(1, n_layers):
        shape = (hidden, hidden if i < n_layers - 1 else d)
        weights.append(torch.randn(*shape, generator=gen) * 10.0 ** (torch.rand(*shape, generator=gen) * 9 - 6))
    ka_n = -(-hidden // PIECE)
    want = []
    for w in weights:
        for c in range(-(-w.shape[1] // PIECE)):
            regions = [_region_pieces(w, ka, c) for ka in range(ka_n)]
            want += [regions[ka][sp] for sp in range(3) for ka in range(ka_n)]
    got = act16_pieces(weights, hidden)
    assert got.shape == (_pieces_per_net(hidden, d, n_layers) * PIECE * PIECE,)
    assert np.array_equal(got, np.concatenate(want))
    assert np.count_nonzero(got.reshape(-1, 3 * ka_n, PIECE * PIECE)[:, :ka_n]) > 0  # the w3 pieces hold bits

# ---- whole nets and calls the kernels' way ----

def _sine(sin_impl: str):
    """The kernels' sines: the polynomial (fastmath), or the exact sine's branch-free path (sin_reduced)."""
    if sin_impl == "fast":
        return fast_sin
    return lambda z: torch.from_numpy(_sin_reduced(z.numpy()))


def _three_chains(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (bf16 values) . W as the kernels take it: w3's chain, then w2's, then w1's into one fp32 sum."""
    w3, w2, w1 = split3(w)
    return ((h @ w3) + (h @ w2)) + (h @ w1)


def act16_net(params, omega: float, seq_len: int, fm_mult, sin_impl: str) -> torch.Tensor:
    """(N, S, D) fp32, unrounded: layer 0 in fp32 (x * w0 + b0, times the scale, each op rounded once), its sine
    rounded to bf16; each hidden layer three chains plus the fp32 bias, times omega, its sine, bf16; the final
    layer three chains plus the bias."""
    sin = _sine(sin_impl)
    (w0, b0), *hidden, (wf, bf) = [(w.float(), b.float()) for w, b in params]
    x = positions(seq_len)
    scale = omega if fm_mult is None else omega * fm_frequency_multipliers(w0.shape[-1], fm_mult)
    h = _bf16(sin(scale * (x * w0 + b0[:, None, :])))
    for w, b in hidden:
        h = _bf16(sin(omega * (_three_chains(h, w) + b[:, None, :])))
    return _three_chains(h, wf) + bf[:, None, :]


def act16_attention(k_params, v_params, k_mean, k_std, v_mean, v_std, q, omega: float, seq_len: int, *,
                    sin_impl: str, fm_mult, causal: bool, net=act16_net):
    """(out, m, l) in the attention kernel's order: K, V from the nets (V rounded to bf16), per 128-row tile the
    scores chunk by chunk of 64 columns, masked to -inf, the online softmax (m, l, alpha), acc += bf16(p) . V; the
    tiles cut into chunks as the kernel's launch does on SMS SMs, each chunk's (m, l, acc) merged in order. ``net``:
    the nets' arithmetic (ACT16's three chains; the rounded one-chain net of 2D's bf16 mode)."""
    n, t, d = q.shape
    k = net(k_params, omega, seq_len, fm_mult, sin_impl) * k_std + k_mean
    v = _bf16(net(v_params, omega, seq_len, fm_mult, sin_impl) * v_std + v_mean)
    qs = q * (1.0 / math.sqrt(d))
    pos = torch.arange(seq_len)
    last = (seq_len - t + torch.arange(t)) if causal else torch.full((t,), seq_len - 1)
    chunks, rows_per_chunk = chunking(n, seq_len, 128, SMS)
    parts = []
    for c in range(chunks):
        m = torch.full((n, t), -math.inf)
        l = torch.zeros(n, t)
        acc = torch.zeros(n, t, d)
        for t0 in range(c * rows_per_chunk, min((c + 1) * rows_per_chunk, seq_len), 128):
            rows = slice(t0, min(t0 + 128, seq_len))
            sc = sum(qs[..., c0:c0 + 64] @ k[:, rows, c0:c0 + 64].transpose(-2, -1) for c0 in range(0, d, 64))
            sc = torch.where(pos[rows][None, :] <= last[:, None], sc, -math.inf)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            some = m_new > -math.inf
            p = torch.where(some[..., None], torch.exp(sc - torch.where(some, m_new, 0.0)[..., None]), 0.0)
            alpha = torch.where(some, torch.exp(m - torch.where(some, m_new, 0.0)), 1.0)
            l = alpha * l + p.sum(dim=-1)
            acc = alpha[..., None] * acc + _bf16(p) @ v[:, rows]
            m = m_new
        parts.append((m, l, acc))
    big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    weights = [torch.exp(m - big) for m, _, _ in parts]
    l = sum(w * lc for w, (_, lc, _) in zip(weights, parts))
    out = sum(w[..., None] * a for w, (_, _, a) in zip(weights, parts)) / l[..., None]
    return out, big, l


DECODE_CASES = [  # (scheme, hidden, hidden layers, n, seq_len, sin_impl, fm)
    ("int4_g128", 128, 1, 3, 300, "fast", None),
    ("int8_g32", 64, 2, 2, 160, "exact", None),
    ("int6_g64", 96, 2, 2, 200, "fast", 16.0),
    ("int4_g32_l0fp32", 64, 1, 2, 129, "exact", None),
]


@pytest.mark.parametrize("scheme, hidden, layers, n, seq_len, sin_impl, fm", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_2e_the_kernels_way_matches_plain_and_jax(scheme, hidden, layers, n, seq_len, sin_impl, fm):
    params = siren_heads(n, hidden, layers, seed=hidden + layers, d=32)
    packed = sq.pack_resident_params([(torch.tensor(w), torch.tensor(b)) for w, b in params], scheme)
    dequant = sq.unpack_resident_params(*packed)
    got = act16_net(dequant, 30.0, seq_len, fm, sin_impl).to(BF16)
    plain = sq.siren_decode_batch_quant_plain(packed, 30.0, seq_len, sin_impl=sin_impl, fm_mult=fm,
                                              compute_dtype=BF16)
    want = jax_decode_quant([(jnp.asarray(w), jnp.asarray(b)) for w, b in params], scheme, 30.0, seq_len, tile=128,
                            interpret=True, compute_dtype=jnp.bfloat16, sin_impl=sin_impl, fm_mult=fm)
    assert got.shape == plain.shape == (n, seq_len, 32)
    _ulps(got, plain)
    _ulps(got, want)


ATTN_CASES = [  # (scheme, n, t, seq_len, sin_impl, fm, causal, hidden)
    ("int4_g128", 2, 1, 300, "fast", None, False, 64),
    ("int8_g32", 2, 16, 257, "fast", None, True, 64),
    ("int6_g64", 1, 4, 150, "fast", 64.0, True, 96),
    ("fp32", 1, 3, 130, "exact", None, True, 64),
]


@pytest.mark.parametrize("scheme, n, t, seq_len, sin_impl, fm, causal, hidden", ATTN_CASES,
                         ids=["single_query", "T16_causal", "fm_odd_hidden", "exact_dense"])
def test_2f_the_kernels_way_matches_plain_and_jax(scheme, n, t, seq_len, sin_impl, fm, causal, hidden):
    args = attention_inputs(n, t, hidden=hidden, seed=n * 10 + t)
    kp, vp, *rest = to_torch(args)
    packed = (sq.pack_resident_params(kp, scheme), sq.pack_resident_params(vp, scheme))
    kw = dict(sin_impl=sin_impl, fm_mult=fm, causal=causal)
    got, m, l = act16_attention(*(sq.unpack_resident_params(*p) for p in packed), *rest, 30.0, seq_len, **kw)
    plain, pm, pl = sq.siren_attention_decode_quant_plain(packed, *rest, 30.0, seq_len, return_stats=True,
                                                          compute_dtype=BF16, **kw)
    want, wm, wl = jax_attn_quant(*to_jax(args), scheme, 30.0, seq_len, tile=128, interpret=True, return_stats=True,
                                  compute_dtype=jnp.bfloat16, **kw)
    _ulps(got, plain)
    _ulps(got, want)
    np.testing.assert_allclose((m + torch.log(l)).numpy(), (pm + torch.log(pl)).numpy(), atol=1e-4)
    np.testing.assert_allclose((m + torch.log(l)).numpy(), np.asarray(wm) + np.log(np.asarray(wl)), atol=1e-4)


# ---- the standing difference: all 24 bits of w ----

@pytest.mark.parametrize("w", [1 + 2.0**-11 + 2.0**-23, -(3 + 2.0**-10 + 2.0**-22), 0.75 + 2.0**-12 + 2.0**-24],
                         ids=["one", "three", "three_quarters"])
def test_three_pieces_keep_every_bit_3xtf32_drops(w):
    """One bf16 activation times one weight whose low bits 3xTF32's hi + lo cannot hold (hi keeps 11 significant
    bits, lo 11 more): the three bf16 pieces give the fp32 product exactly, as the plain version and JAX compute
    it; the layer stack's 3xTF32 product misses it. (ROADMAP.md queue 3 keeps this standing difference.)"""
    h = torch.tensor([[1.5]])
    weight = torch.tensor([[w]], dtype=torch.float32)
    exact = h @ weight
    assert torch.equal(_three_chains(h, weight), exact)
    assert not torch.equal(_matmul_3xtf32(h, weight), exact)


# ---- the route, the constants and the CPU ----

@pytest.mark.parametrize("hidden, d, t, want", [
    (256, 128, 1, "wgmma"), (256, 128, 16, "wgmma"), (128, 128, 4, "wgmma"), (96, 20, 4, "wgmma"),
    (64, 32, 2, "wgmma"), (64, 4, 1, "wgmma"), (256, 128, 17, "stack"), (256, 256, 1, "stack"),
    (512, 128, 1, "stack"), (96, 18, 4, "stack"), (98, 32, 1, "stack"), (2048, 128, 1, "stack"),
])
def test_attention_route(hidden, d, t, want):
    """2F's bf16 mode takes csrc/siren_attention_wgmma.cu for nets 2E's rule takes, D <= 128 and T <= 16; others
    keep the layer stack."""
    assert sq.attention_route(hidden, d, t) == want
    if want == "wgmma":
        assert siren_cuda.bf16_route(hidden, d) == "wgmma"


def test_route_constants_are_the_kernels():
    attention = (CSRC / "siren_attention_wgmma.cu").read_text()
    for name, value in (("kMaxQueries", sa.WGMMA_MAX_QUERIES), ("kMaxHeadDim", sa.WGMMA_MAX_HEAD_DIM)):
        assert re.search(rf"constexpr int {name} = (\d+);", attention).group(1) == str(value), name
    assert re.search(r"constexpr int kSplits = (\d+);", HEADER).group(1) == "3"
    decode = (CSRC / "siren_decode_act16.cu").read_text()
    assert "act16_net_ok(net, L, H, D)" in decode and "act16_net_ok(knet, L, H, D)" in attention
    mult = siren_cuda.WGMMA_WIDTH_MULT
    assert f"H % {mult} != 0 ||\n        D % {mult} != 0" in HEADER  # the launches refuse what the rule does not send


def test_cpu_calls_run_the_plain_versions_uncounted():
    args = to_torch(attention_inputs(1, 2, seed=4))
    counts = [dict(c) for c in (sq.launches, sq.bf16_launches, sq.wgmma_launches)]
    kw = dict(compute_dtype=BF16, sin_impl="fast")
    got = sq.siren_attention_decode_quant(*args, "int4_g128", 30.0, 40, **kw)
    packed = (sq.pack_resident_params(args[0], "int4_g128"), sq.pack_resident_params(args[1], "int4_g128"))
    assert torch.equal(got, sq.siren_attention_decode_quant_plain(packed, *args[2:], 30.0, 40, **kw))
    dec = sq.siren_decode_batch_quant(args[0], "int4_g128", 30.0, 40, **kw)
    assert torch.equal(dec, sq.siren_decode_batch_quant_plain(packed[0], 30.0, 40, **kw))
    assert [dict(c) for c in (sq.launches, sq.bf16_launches, sq.wgmma_launches)] == counts


# ---- the trace tool over the new kernels ----

@pytest.mark.parametrize("kernel, own_stamps", [("2C", 2), ("2E", 0), ("2F", 1), ("2D", 1)])
def test_trace_tool_stamps_each_kernel(kernel, own_stamps):
    """tools/bf16_decode_trace.py finds each of its anchors once in the shared header and in the kernel's source."""
    from nerf_attention_tpu_torch.tools import bf16_decode_trace as tool

    spec = tool.KERNELS[kernel]
    source = (CSRC / spec["source"]).read_text()
    assert all(source.count(old) == 1 for old, _ in spec["anchors"])
    srcs = tool.instrumented_sources(kernel)
    assert srcs[tool.HEADER].count("clock64()") == 11
    assert srcs[spec["source"]].count("clock64()") == own_stamps
    assert 'extern "C" int read_trace' in srcs[spec["source"]]


# ---- tools/siren_kernel_outputs.py over the new kernels' cases ----

def _tiny_tool(tool, monkeypatch):
    monkeypatch.setattr(tool, "DECODE_CASES", {})
    monkeypatch.setattr(tool, "TRAIN_CASES", {})
    monkeypatch.setattr(tool, "BF16_CASES", {})
    monkeypatch.setattr(tool, "MODE_NETS", (1,))
    monkeypatch.setattr(tool, "MODE_SHAPE", (32, 1, 40))
    monkeypatch.setattr(tool, "D", 8)
    monkeypatch.setattr(tool, "ATTENTION_CASES", {"2F": (2, 3, 40, True, "int8_g32"),
                                                  "2E decode small": (2, 0, 40, False, "int4_g32", (32, 1))})
    monkeypatch.setattr(tool, "ACT16_MODES", {"2E tiny": (2, 40, 32, 1), "2F tiny": (2, 40, 32, 1)})


def test_kernel_outputs_tool_holds_the_act16_cases_to_their_plain_versions(tmp_path, monkeypatch, capsys):
    """--compare of two dumps that differ only in 2F's bf16 output exits 1 on that case alone and prints both
    files' ulps against the plain output saved beside it."""
    from nerf_attention_tpu_torch.tools import siren_kernel_outputs as tool

    _tiny_tool(tool, monkeypatch)
    a, b = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    assert tool.main(["--out", a, "--device", "cpu", "--attention"]) == 0
    dump = torch.load(a)
    assert dump["2E decode small bf16"][0].shape == (2, 40, 8) and len(dump["2E decode small bf16"]) == 2
    dump["2F bf16"][0][0, 0, 0] += 2.0**-8 * dump["2F bf16"][-1].abs().max()  # one bf16 ulp of the largest |o|
    torch.save(dump, b)
    capsys.readouterr()
    assert tool.main(["--compare", a, b]) == 1
    out = capsys.readouterr().out
    assert "2F bf16: bit-identical = False" in out and "2E decode small bf16: bit-identical = True" in out
    assert "2F: bit-identical = True" in out
    assert "2F bf16: 0.000 / 1.000 bf16 ulps against the plain version" in out
    assert "2E decode small bf16: 0.000 / 0.000 bf16 ulps against the plain version" in out


def test_kernel_outputs_tool_times_the_act16_modes(monkeypatch, capsys):
    from nerf_attention_tpu_torch.tools import siren_kernel_outputs as tool

    _tiny_tool(tool, monkeypatch)
    assert tool.main(["--modes", "--attention", "--device", "cpu"]) == 0
    rows = [eval(line, {}) for line in capsys.readouterr().out.splitlines() if line.startswith("{'case'")]
    assert [r["case"] for r in rows] == ["2E tiny", "2F tiny"]
    assert all(r["ulps_vs_plain"] == 0.0 and r["float32_ms"] > 0 and r["bfloat16_ms"] > 0 for r in rows)
