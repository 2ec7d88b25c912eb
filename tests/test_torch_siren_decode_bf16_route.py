"""Kernel 2B/2C's bf16 mode on the card: which kernel a net's widths take
(``ops/siren_cuda.py:bf16_route``), how ``csrc/siren_decode_bf16.cu`` splits a
call into blocks, and that kernel's layouts and sine, emulated on the CPU.

Nets whose hidden width (padded to 64) and output width are at most
``WGMMA_MAX_WIDTH``, and multiples of 4, take ``csrc/siren_decode_bf16.cu``;
wider or unaligned ones keep the layer stack's bf16 mode in
``csrc/siren_decode.cu``. The rule is plain Python:
no library is loaded here, and a CPU tensor runs the plain version with no
launch counted.

The emulations mirror the kernel's index arithmetic in numpy: a weight piece
(64 weight rows by 64 columns) as a producer warp converts it into the ring
(bf16, 128-byte rows, 16-byte chunk j of row k at j ^ (k % 8)), read back as
wgmma's MN-major B operand through its descriptor (groups of 8 rows 1024 bytes
apart, a k16 step 2048 bytes on), held to the rounded weights of
``siren_apply_bf16``; an m64n64 product's accumulators repacked as the next
product's A fragments; and the exact sine's branch-free path
(``sin_reduced``, its constants read from the kernel's source) against the
fp64 sine, alone and through whole nets against the plain version at the
bf16 mode's tolerance. The kernel itself is held to the plain version on the
card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_attention_tpu_torch.models.siren import SirenStack, fm_frequency_multipliers, init_siren, positions
from nerf_attention_tpu_torch.ops import siren_cuda
from nerf_attention_tpu_torch.types import CONFIGS_FULL, SIRENConfig

torch.set_num_threads(1)

CSRC = Path(siren_cuda.__file__).resolve().parent.parent / "csrc"
KERNEL = CSRC / "siren_decode_bf16.cu"
HEADER = CSRC / "siren_wgmma.cuh"  # the layer machinery, the sine and the constants the bf16 kernels share
BF16_ULPS = 4  # tests/test_torch_siren_decode_bf16.py
PIECE = 64


def _bf16(x):
    return torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16).float()


# ---- the width rule ----

@pytest.mark.parametrize("config", CONFIGS_FULL, ids=[c.name for c in CONFIGS_FULL])
def test_every_config_up_to_256_wide_takes_the_wgmma_kernel(config):
    want = "wgmma" if config.hidden_features <= 256 else "stack"
    assert siren_cuda.bf16_route(config.hidden_features, 128) == want


@pytest.mark.parametrize("hidden, d_out, want", [
    (256, 256, "wgmma"), (96, 20, "wgmma"), (100, 4, "wgmma"), (192, 252, "wgmma"), (32, 8, "wgmma"),
    (1, 1, "stack"), (96, 18, "stack"), (192, 3, "stack"), (98, 128, "stack"), (256, 254, "stack"),
    (257, 128, "stack"), (256, 260, "stack"), (512, 128, "stack"), (2048, 128, "stack"), (3632, 100, "stack"),
])
def test_route_by_width(hidden, d_out, want):
    assert siren_cuda.bf16_route(hidden, d_out) == want


def test_route_constants_are_the_kernels():
    header, src = HEADER.read_text(), KERNEL.read_text()
    for name, value in (("kMaxWidth", siren_cuda.WGMMA_MAX_WIDTH), ("kRows", siren_cuda.WGMMA_TILE_ROWS),
                        ("kPiece", siren_cuda.WGMMA_HIDDEN_MULT)):
        assert re.search(rf"constexpr int {name} = (\d+);", header).group(1) == str(value), name
    mult = siren_cuda.WGMMA_WIDTH_MULT
    assert f"H % {mult} != 0 || D % {mult} != 0" in src  # the launch refuses what the rule does not send


@pytest.mark.parametrize("n, seq_len, sms, want", [
    (512, 2048, 132, (1, 16)), (1, 2048, 132, (16, 1)), (40, 2048, 132, (16, 1)), (1, 32768, 132, (128, 2)),
    (1, 50, 132, (1, 1)), (8, 777, 132, (7, 1)), (512, 32768, 132, (1, 256)),
])
def test_wgmma_chunking(n, seq_len, sms, want):
    chunks, tiles_per_chunk = siren_cuda.wgmma_chunking(n, seq_len, sms)
    assert (chunks, tiles_per_chunk) == want
    tiles = -(-seq_len // siren_cuda.WGMMA_TILE_ROWS)
    assert chunks * tiles_per_chunk >= tiles > (chunks - 1) * tiles_per_chunk  # every chunk holds a tile


def test_bf16_kernel_launch_names_its_counting_wrapper():
    """A launch routed to csrc/siren_decode_bf16.cu is counted where it launches, under the wrapper that asked:
    without one it is refused before anything is built or launched."""
    params = init_siren(SIRENConfig(64, 1, 30.0, "t"), 16, generator=torch.Generator().manual_seed(3))
    stack = SirenStack.from_params(params)
    with pytest.raises(ValueError, match="wrapper"):
        siren_cuda.decode_launch([], len(stack.dims), 1, 64, 16, torch.device("cpu"), 30.0, 40, "exact", None,
                                 compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("batch", [False, True], ids=["2B", "2C"])
def test_cpu_tensors_run_the_plain_version_uncounted(batch):
    params = init_siren(SIRENConfig(64, 1, 30.0, "t"), 16, generator=torch.Generator().manual_seed(3), n=2)
    stack = SirenStack.from_params(params)
    counts = [dict(c) for c in (siren_cuda.launches, siren_cuda.bf16_launches, siren_cuda.wgmma_launches)]
    kw = dict(compute_dtype=torch.bfloat16, sin_impl="fast")
    if batch:
        got = siren_cuda.siren_decode_batch(stack, 30.0, 40, **kw)
        want = siren_cuda.siren_decode_plain(stack, 30.0, 40, **kw)
    else:
        one = SirenStack(stack.flat[:1].contiguous(), stack.dims)
        got = siren_cuda.siren_decode(one, 30.0, 40, **kw)
        want = siren_cuda.siren_decode_plain(one, 30.0, 40, **kw)[0]
    assert torch.equal(got, want)
    assert [dict(c) for c in (siren_cuda.launches, siren_cuda.bf16_launches, siren_cuda.wgmma_launches)] == counts


# ---- the ring's layout ----

def _piece_as_converted(w: torch.Tensor, ka: int, c: int) -> np.ndarray:
    """The ring's piece (ka, c) of W (rows, cols) as a producer warp writes it: 4096 bf16 (uint16), lane (r0, quad)
    storing columns 4 quad .. + 3 of row k at byte k * 128 + ((quad >> 1) ^ (k % 8)) * 16 + (quad & 1) * 8."""
    rows, cols = w.shape
    land = torch.zeros(PIECE, PIECE)  # the landing slot: the tensor copy's box, zero past rows and columns
    r, cc = min(PIECE, rows - ka * PIECE), min(PIECE, cols - c * PIECE)
    land[:r, :cc] = w[ka * PIECE:ka * PIECE + r, c * PIECE:c * PIECE + cc]
    bits = land.to(torch.bfloat16).view(torch.int16).numpy().astype(np.uint16)
    stage = np.zeros(PIECE * PIECE, np.uint16)
    for k in range(PIECE):
        for quad in range(16):
            byte = k * 128 + (((quad >> 1) ^ (k & 7)) << 4) + (quad & 1) * 8
            stage[byte // 2:byte // 2 + 4] = bits[k, 4 * quad:4 * quad + 4]
    return stage


def _b_tile_through_descriptor(stage: np.ndarray, kk: int) -> np.ndarray:
    """The (k16, n64) B tile that wgmma reads at k step kk of a piece: MN-major, the 128-byte swizzle (address bits
    4-6 xor bits 7-9, the piece 1024-byte aligned), 8-row groups 1024 bytes apart, the step's start 2048 bytes on."""
    out = np.zeros((16, PIECE), np.uint16)
    for k in range(16):
        for n in range(PIECE):
            addr = kk * 2048 + (k // 8) * 1024 + (k % 8) * 128 + 2 * n
            addr ^= ((addr >> 7) & 7) << 4
            out[k, n] = stage[addr // 2]
    return out


@pytest.mark.parametrize("rows, cols, ka, c", [(256, 256, 2, 1), (96, 20, 1, 0), (64, 128, 0, 1), (72, 72, 1, 1)],
                         ids=["medium", "partial", "final", "corner"])
def test_ring_piece_reads_back_as_the_rounded_weights(rows, cols, ka, c):
    w = torch.randn(rows, cols, generator=torch.Generator().manual_seed(rows + cols))
    want = torch.zeros(PIECE, PIECE)
    r, cc = min(PIECE, rows - ka * PIECE), min(PIECE, cols - c * PIECE)
    want[:r, :cc] = _bf16(w)[ka * PIECE:ka * PIECE + r, c * PIECE:c * PIECE + cc]  # siren_apply_bf16's rw(w)
    stage = _piece_as_converted(w, ka, c)
    got = np.concatenate([_b_tile_through_descriptor(stage, kk) for kk in range(4)])
    got = torch.from_numpy(got.astype(np.int16)).view(torch.bfloat16).float()
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_accumulators_repack_as_the_next_a_fragments(seed):
    """m64n64 accumulators (warp w, lane g t: n8 block j holds rows 16w + g at 4j, 4j + 1 and 16w + g + 8 at 4j + 2,
    4j + 3, columns 8j + 2t, + 1) packed as the kernel does (h[j / 2][2 (j % 2)] = (4j, 4j + 1), h[j / 2][2 (j %
    2) + 1] = (4j + 2, 4j + 3)) are the A fragments of the chunk's 4 k16 steps (register 0 row g, 1 row g + 8, 2
    row g at + 8 columns, 3 row g + 8 at + 8; k 2t, 2t + 1 in each)."""
    m = torch.randn(64, 64, generator=torch.Generator().manual_seed(seed))
    back = torch.full((64, 64), float("nan"))
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            acc = [0.0] * 32
            for j in range(8):
                for q in range(4):
                    acc[4 * j + q] = m[16 * w + g + 8 * (q >> 1), 8 * j + 2 * t + (q & 1)]
            h = [[None] * 4 for _ in range(4)]
            for j in range(8):
                h[j // 2][2 * (j & 1)] = (acc[4 * j], acc[4 * j + 1])
                h[j // 2][2 * (j & 1) + 1] = (acc[4 * j + 2], acc[4 * j + 3])
            for ks in range(4):
                for reg in range(4):
                    row = 16 * w + g + 8 * (reg & 1)
                    col = 16 * ks + 2 * t + 8 * (reg >> 1)
                    back[row, col], back[row, col + 1] = h[ks][reg]
    assert torch.equal(back, m)


# ---- the exact sine ----

def _sin_reduced_constants() -> list[float]:
    src = HEADER.read_text()
    body = src[src.index("float sin_reduced(float x) {"):]
    body = body[:body.index("\n}")]
    return [float(v) for v in re.findall(r"([-+]?\d+\.\d*(?:e[-+]?\d+)?)f", body)]


def _fma(a, b, c):
    """fp32 fma: the exact product and sum in fp64, rounded once to fp32 (fp32 products are exact in fp64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _sin_reduced(x: np.ndarray) -> np.ndarray:
    """The kernel's sin_reduced in fp32 (its constants in source order)."""
    inv, p1, p2, p3, s1, s2, s3, c1, c2, c3, c4, one = (np.float32(v) for v in _sin_reduced_constants())
    x = x.astype(np.float32)
    j = np.rint((x * inv).astype(np.float32)).astype(np.float32)
    r = _fma(j, p1, x)
    r = _fma(j, p2, r)
    r = _fma(j, p3, r)
    s = (r * r).astype(np.float32)
    ps = _fma(_fma(s1, s, s2), s, s3)
    sn = _fma((ps * s).astype(np.float32), r, r)
    pc = _fma(_fma(_fma(c1, s, c2), s, c3), s, c4)
    cs = _fma(pc, s, one)
    q = j.astype(np.int64)
    v = np.where(q & 1, cs, sn)
    return np.where(q & 2, -v, v).astype(np.float32)


def test_sin_reduced_constants():
    assert len(_sin_reduced_constants()) == 12
    inv, p1, p2, p3 = (float(np.float32(v)) for v in _sin_reduced_constants()[:4])  # as the compiler rounds them
    assert abs(1 / inv - np.pi / 2) < 1e-7 and abs(-(p1 + p2 + p3) - np.pi / 2) < 1e-15


@pytest.mark.parametrize("span", [4.0, 200.0, 105615.0], ids=["small", "siren", "reduction-limit"])
def test_sin_reduced_is_full_accuracy(span):
    """Within 2 fp32 ulps of 1 (the largest |sin|) of the fp64 sine, as CUDA's sinf, up to kReduceMax."""
    x = np.random.default_rng(7).uniform(-span, span, 200_000).astype(np.float32)
    err = np.abs(_sin_reduced(x).astype(np.float64) - np.sin(x.astype(np.float64))).max()
    assert err <= 2 * 2.0**-24, err


def _emulated_net(params, omega, seq_len, fm_mult, total_len):
    """One net in the kernel's bf16 arithmetic with the exact sine's branch-free path: layer 0 in fp32 (x * bf16(w0),
    + bf16(b0), times the scale, each op rounded once), hidden layers 64 columns at a time, bf16 output."""
    sin = lambda z: torch.from_numpy(_sin_reduced(z.numpy()))
    (w0, b0), *hidden, (wf, bf) = params
    x = positions(seq_len, total_len=total_len)
    scale = omega if fm_mult is None else omega * fm_frequency_multipliers(w0.shape[-1], fm_mult)
    h = _bf16(sin(scale * (x * _bf16(w0) + _bf16(b0))))
    for w, b in hidden:
        chunks = [h @ _bf16(w[:, c:c + PIECE]) + _bf16(b[c:c + PIECE]) for c in range(0, w.shape[1], PIECE)]
        h = _bf16(sin(omega * torch.cat(chunks, dim=1)))
    return (h @ _bf16(wf) + _bf16(bf)).to(torch.bfloat16)


@pytest.mark.parametrize("hidden, layers, d, seq_len, fm, total_len", [
    (256, 2, 128, 300, None, None), (64, 1, 16, 200, 64.0, None), (96, 3, 20, 150, None, 400),
], ids=["medium", "fm", "padded-total_len"])
def test_exact_sine_path_within_the_modes_tolerance(hidden, layers, d, seq_len, fm, total_len):
    params = init_siren(SIRENConfig(hidden, layers, 30.0, "t"), d, generator=torch.Generator().manual_seed(hidden))
    got = _emulated_net(params, 30.0, seq_len, fm, total_len).float()
    want = siren_cuda.siren_decode_plain(params, 30.0, seq_len, fm_mult=fm, total_len=total_len,
                                         compute_dtype=torch.bfloat16).float()
    err = (got - want).abs().max().item()
    assert err <= BF16_ULPS * 2.0**-8 * want.abs().max().item(), err


# ---- the trace tool ----

def test_trace_tool_anchors_each_occur_once():
    """tools/bf16_decode_trace.py stamps the committed kernel and the shared header at points it finds exactly
    once."""
    from nerf_attention_tpu_torch.tools import bf16_decode_trace as tool

    kernel, header = KERNEL.read_text(), HEADER.read_text()
    assert all(kernel.count(old) == 1 for old, _ in tool.KERNELS["2C"]["anchors"])
    assert all(header.count(old) == 1 for old, _ in tool.HEADER_ANCHORS)
    srcs = tool.instrumented_sources("2C")
    assert srcs[HEADER.name].count("clock64()") == 11 and srcs[KERNEL.name].count("clock64()") == 2
    assert 'extern "C" int read_trace' in srcs[KERNEL.name] and "clock64()" not in kernel + header


def test_trace_tool_breakdown():
    from nerf_attention_tpu_torch.tools import bf16_decode_trace as tool

    counters = np.zeros(tool.TRACE_SLOTS, np.int64)
    counters[[0, 1, 2, 3, 4, 5, 6, 8]] = [400, 40, 800, 200, 1000, 2600, 16, 160]
    counters[tool.WG_SLOTS:tool.WG_SLOTS + 9] = counters[:9] * 2
    counters[40:42] = [900, 3]
    got = tool.breakdown(counters, 4)
    assert got["wg1"] == {"total": 400.0, "layer0": 50.0, "wait": 100.0, "wait_first_tile": 160.0,
                          "wait_later_tiles": 80.0, "full_wait": 0.0, "wgmma": 10.0, "epilogue": 200.0,
                          "between": 4.0}
    assert got["wg2"]["total"] == 800.0 and got["producer_warp0"] == {"copies_back": 3, "empty_wait_each": 300.0}
