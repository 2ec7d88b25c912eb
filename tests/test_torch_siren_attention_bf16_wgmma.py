"""Kernel 2D's bf16 mode on Hopper (``csrc/siren_attention_wgmma.cu`` over
``csrc/siren_wgmma.cuh`` with one piece a weight), emulated on the CPU.

2D's bf16 mode rounds its weights (``siren_attention_pallas.py:_flat_weights``
casts W and b to bf16), so the kernel's split pass writes one piece a weight,
w1 = bf16(w), and each hidden and final product is one bf16 chain into fp32
accumulators; the bias tables and layer 0's row hold bf16-rounded values. The
rest is 2F's kernel: scores from the key net's accumulators by 64-column
chunks, the online softmax over 128-row tiles, p and V rounded to bf16 for p.V,
the launch's chunks merged in order. These tests mirror that in numpy / torch:

* the one-piece pass: each region's piece is the w1 of the three-piece mode's
  region-by-region emulation (``tests/test_torch_siren_act16_wgmma.py``), laid out in the
  consumers' order, and equal bit for bit to the card test's emulation
  (``tests/test_torch_cuda.py:act16_pieces`` with one split);
* whole calls computed the kernel's way against the plain version
  (``siren_attention_decode_plain``, bf16) and against the JAX package's Pallas
  kernel in interpret mode, held to ULPS bf16 ulps of the largest |output|;
* the route: calls ``attention_route`` sends to the Hopper kernel reach it with
  the weights rounded and are counted in ``wgmma_launches``, other calls keep
  the layer stack (traced on ``meta`` tensors, which launch nothing);
* CPU calls run the plain version and count nothing.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_attention_tpu.ops.siren_attention_pallas import siren_attention_decode_fused as jax_fused
from nerf_attention_tpu_torch.models.siren import SirenStack, fm_frequency_multipliers
from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
from test_torch_cuda import TABLE_GAIN, act16_pieces, table_gaps
from test_torch_siren_act16_wgmma import (
    CSRC,
    HEADER,
    PIECE,
    _bf16,
    _read_back,
    _region_pieces,
    _sine,
    _tiny_tool,
    _ulps,
    act16_attention,
)
from test_torch_siren_attention import D, attention_inputs, to_jax, to_torch

torch.set_num_threads(1)

BF16 = torch.bfloat16
ATTENTION = (CSRC / "siren_attention_wgmma.cu").read_text()


# ---- the one-piece pass ----

def test_the_one_piece_pass_is_in_the_sources():
    """The split pass's one-piece form writes bf16_rn(w), and the kernel takes one chain over it; the launch's
    ``rounded`` flag (the wrapper's ``round_weights``) picks one piece a weight for the buffer, the split pass and
    the kernel alike."""
    assert "p[0] = __float2bfloat16_rn(w);" in HEADER
    assert "split<SPLITS>(k < rows && j0 + u < cols ? value(k, j0 + u) : 0.f, s[u]);" in HEADER
    assert "Consumer<FAST, SPLITS, kAttnStages, float>" in ATTENTION
    assert "fill_net_tables<SPLITS == 1>(knet, n, L, H, kbias, kfirst);" in ATTENTION
    assert "split_launch<SPLITS>(knet, vnet, N, 2 * N, L, H, D, pieces, st);" in ATTENTION
    assert "pieces_per_net(H, D, L, rounded ? 1 : kSplits) * kStageBytes * 2 * N" in ATTENTION
    assert "rounded ? (fast ? run(launch<true, 1>) : run(launch<false, 1>))" in ATTENTION


@pytest.mark.parametrize("rows, cols, ka, c", [(256, 256, 2, 1), (96, 20, 1, 0), (76, 76, 1, 1)],
                         ids=["medium", "partial", "corner"])
def test_one_piece_is_the_first_of_three(rows, cols, ka, c):
    """A region's one piece is w1, the last of the three the three-piece emulation writes (w3, w2, w1): bf16(w), zero
    past the layer's rows and columns, read back through the descriptor."""
    w = torch.randn(rows, cols, generator=torch.Generator().manual_seed(rows + cols)) * 0.1
    w1 = _region_pieces(w, ka, c)[2]
    want = torch.zeros(PIECE, PIECE)
    r, cc = min(PIECE, rows - ka * PIECE), min(PIECE, cols - c * PIECE)
    want[:r, :cc] = w[ka * PIECE:ka * PIECE + r, c * PIECE:c * PIECE + cc]
    assert torch.equal(_read_back(w1), _bf16(want))


def _one_piece_buffer(weights, hidden: int, d: int, n_layers: int) -> dict[int, np.ndarray]:
    """split_kernel<1>'s buffer of one net: block q (layer i, chunk c, k atom ka) writes its region's w1 at ((i - 1)
    hch + c) KA + ka, as the source computes ``first`` with SPLITS = 1."""
    ka_n, hch, dch = -(-hidden // PIECE), -(-hidden // PIECE), -(-d // PIECE)
    hidden_regions = (n_layers - 2) * hch * ka_n
    buffer: dict[int, np.ndarray] = {}
    for q in range(hidden_regions + dch * ka_n):
        i = 1 + q // (hch * ka_n) if q < hidden_regions else n_layers - 1
        rem = q % (hch * ka_n) if q < hidden_regions else q - hidden_regions
        c, ka = rem // ka_n, rem % ka_n
        first = ((i - 1) * hch + c) * 1 * ka_n + ka
        assert first not in buffer
        buffer[first] = _region_pieces(weights[i - 1], ka, c)[2]
    return buffer


@pytest.mark.parametrize("hidden, d, n_layers", [(256, 128, 4), (128, 128, 3), (96, 20, 5), (64, 128, 3)],
                         ids=["medium", "small", "odd-deep", "tiny"])
def test_one_piece_pass_writes_the_rounded_weights_in_the_consumers_order(hidden, d, n_layers):
    """The pass's regions cover pieces_per_net(H, D, L, 1) once; the consumers' walk with one split (layer, chunk,
    k atom) reads bf16(W) region by region; and the buffer equals the card test's emulation bit for bit."""
    assert "const int first = ((i - 1) * hch + c) * SPLITS * KA + ka;" in HEADER
    assert "const int pc = p + (c * SPLITS + sp) * KA + ka;" in HEADER
    gen = torch.Generator().manual_seed(hidden * n_layers + d)
    weights = []
    for i in range(1, n_layers):
        shape = (hidden, hidden if i < n_layers - 1 else d)
        weights.append(torch.randn(*shape, generator=gen) * 10.0 ** (torch.rand(*shape, generator=gen) * 9 - 6))
    buffer = _one_piece_buffer(weights, hidden, d, n_layers)
    ka_n, dch = -(-hidden // PIECE), -(-d // PIECE)
    per_net = ka_n * ((n_layers - 2) * ka_n + dch)
    assert sorted(buffer) == list(range(per_net))
    p = 0
    for i in range(1, n_layers):  # Consumer::layer's walk, SPLITS = 1
        w = weights[i - 1]
        for c in range(dch if i == n_layers - 1 else ka_n):
            for ka in range(ka_n):
                want = torch.zeros(PIECE, PIECE)
                r, cc = min(PIECE, w.shape[0] - ka * PIECE), min(PIECE, w.shape[1] - c * PIECE)
                want[:r, :cc] = w[ka * PIECE:ka * PIECE + r, c * PIECE:c * PIECE + cc]
                assert torch.equal(_read_back(buffer[p + c * ka_n + ka]), _bf16(want)), (i, c, ka)
        p += (dch if i == n_layers - 1 else ka_n) * ka_n
    assert p == per_net
    got = act16_pieces(weights, hidden, splits=1)
    assert np.array_equal(got, np.concatenate([buffer[k] for k in range(per_net)]))
    assert act16_pieces(weights, hidden).size == 3 * got.size  # three pieces a weight in 2E's and 2F's mode


# ---- whole calls the kernel's way ----

def rounded_net(params, omega: float, seq_len: int, fm_mult, sin_impl: str, round_tables: bool = True
                ) -> torch.Tensor:
    """(N, S, D) fp32, unrounded, as the kernel computes a net with one rounded piece a weight: x = r / (S - 1);
    layer 0 in fp32 (x * bf16(w0) + bf16(b0), times the scale, each op rounded once), its sine rounded to bf16; each
    hidden layer one chain over bf16(W) plus bf16(b), times omega, its sine, bf16; the final layer one chain plus
    bf16(b). ``round_tables=False``: a kernel that left its bias tables and layer 0 row fp32."""
    sin = _sine(sin_impl)
    table = _bf16 if round_tables else (lambda x: x)
    (w0, b0), *hidden, (wf, bf) = [(table(w.float()) if i == 0 else _bf16(w.float()), table(b.float()))
                                   for i, (w, b) in enumerate(params)]
    x = (torch.arange(seq_len, dtype=torch.float32) / max(seq_len - 1, 1))[:, None]
    scale = omega if fm_mult is None else omega * fm_frequency_multipliers(w0.shape[-1], fm_mult)
    h = _bf16(sin(scale * (x * w0 + b0[:, None, :])))
    for w, b in hidden:
        h = _bf16(sin(omega * (h @ w + b[:, None, :])))
    return h @ wf + bf[:, None, :]


CASES = [  # (n, t, seq_len, sin_impl, fm, causal, hidden)
    (2, 8, 300, "fast", None, True, 64),
    (2, 1, 257, "fast", None, False, 64),
    (2, 4, 150, "fast", 64.0, True, 64),
    (1, 2, 100, "exact", None, True, 64),
    (1, 4, 200, "fast", None, True, 96),
    (2, 16, 300, "fast", None, True, 64),
]


@pytest.mark.parametrize("n, t, seq_len, sin_impl, fm, causal, hidden", CASES,
                         ids=["causal_T8", "single_query_whole_window", "fm64", "exact", "odd_hidden96", "T16"])
def test_2d_bf16_the_kernels_way_matches_plain_and_jax(n, t, seq_len, sin_impl, fm, causal, hidden):
    args = attention_inputs(n, t, hidden=hidden, seed=n * 10 + t + hidden)
    kp, vp, *rest = to_torch(args)
    kw = dict(sin_impl=sin_impl, fm_mult=fm, causal=causal)
    got, m, l = act16_attention(kp, vp, *rest, 30.0, seq_len, net=rounded_net, **kw)
    plain, pm, pl = sa.siren_attention_decode_plain(kp, vp, *rest, 30.0, seq_len, return_stats=True,
                                                    compute_dtype=BF16, **kw)
    want = jax_fused(*to_jax(args), 30.0, seq_len, tile=128, interpret=True, compute_dtype=jnp.bfloat16, **kw)
    assert got.shape == plain.shape == (n, t, D)
    _ulps(got, plain)
    _ulps(got, want)
    np.testing.assert_allclose((m + torch.log(l)).numpy(), (pm + torch.log(pl)).numpy(), atol=1e-4)
    fp32 = sa.siren_attention_decode_plain(kp, vp, *rest, 30.0, seq_len, **kw)
    assert not torch.equal(got, fp32)


# ---- the card test's check of the rounded tables ----

@pytest.mark.parametrize("n, t, seq_len, sin_impl, fm, causal, hidden", [CASES[i] for i in (0, 2, 3, 4)],
                         ids=["causal_T8", "fm64", "exact", "odd_hidden96"])
def test_the_table_check_tells_rounded_tables_from_unrounded(n, t, seq_len, sin_impl, fm, causal, hidden):
    """tests/test_torch_cuda.py's check that the kernel rounds its bias tables and layer 0 row (``table_gaps``), run
    on the kernel's way computed here: the kernel's way passes it, each unrounded-table plain version at least
    TABLE_GAIN times farther from the bf16 plain version on both nets' sides, and the same computed with fp32 tables
    fails it."""
    args = attention_inputs(n, t, hidden=hidden, seed=n * 10 + t + hidden)
    kp, vp, *stats, q = to_torch(args)
    k, v = SirenStack.from_params(kp), SirenStack.from_params(vp)
    kw = dict(sin_impl=sin_impl, fm_mult=fm, causal=causal)

    def gaps(round_tables: bool) -> dict[str, float]:
        net = functools.partial(rounded_net, round_tables=round_tables)
        _, got_m, _ = act16_attention(kp, vp, *stats, q, 30.0, seq_len, net=net, **kw)
        got_zero = act16_attention(kp, vp, *stats, torch.zeros_like(q), 30.0, seq_len, net=net, **kw)[0]
        return table_gaps(got_m, got_zero, k, v, *stats, q, 30.0, seq_len, compute_dtype=BF16, **kw)

    assert min(gaps(True).values()) >= TABLE_GAIN
    assert min(gaps(False).values()) < TABLE_GAIN


# ---- the route ----

ROUTES = [(256, 128, 1, "wgmma"), (256, 128, 16, "wgmma"), (96, 20, 4, "wgmma"), (64, 4, 1, "wgmma"),
          (256, 128, 17, "stack"), (512, 128, 1, "stack"), (64, 256, 1, "stack"), (96, 18, 2, "stack"),
          (98, 32, 1, "stack")]


@pytest.mark.parametrize("hidden, d, t, route", ROUTES, ids=[f"H{h}-D{d}-T{t}-{r}" for h, d, t, r in ROUTES])
def test_the_wrapper_takes_the_hopper_kernel_by_attention_route(monkeypatch, hidden, d, t, route):
    """siren_attention_decode_fused on tensors off the CPU (``meta``: they carry shapes and launch nothing): in bf16,
    calls attention_route sends to "wgmma" reach csrc/siren_attention_wgmma.cu's launch with the weights rounded,
    once, counted in ``wgmma_launches``; the others and every fp32 call reach the layer stack's."""
    calls = []

    def fake(route_name):
        return lambda *args, **kw: calls.append((route_name, kw)) or torch.empty(2, t, d, device="meta")

    monkeypatch.setattr(sa, "wgmma_attention_launch", fake("wgmma"))
    monkeypatch.setattr(sa, "attention_launch", fake("stack"))
    meta = torch.device("meta")
    dims = [(1, hidden), (hidden, hidden), (hidden, d)]
    params = [(torch.empty(2, i, o, device=meta), torch.empty(2, o, device=meta)) for i, o in dims]
    stats = [torch.empty(2, 1, d, device=meta) for _ in range(4)]
    q = torch.empty(2, t, d, device=meta)
    counts = [dict(c) for c in (sa.launches, sa.bf16_launches, sa.wgmma_launches, sq.wgmma_launches)]
    sa.siren_attention_decode_fused(params, params, *stats, q, 30.0, 64, compute_dtype=BF16)
    assert sa.attention_route(hidden, d, t) == sq.attention_route(hidden, d, t) == route
    assert [c[0] for c in calls] == [route]
    if route == "wgmma":
        assert calls[0][1]["round_weights"] is True
    else:
        assert calls[0][1]["compute_dtype"] == BF16
    key = "siren_attention_decode_fused"
    assert sa.wgmma_launches[key] == counts[2][key] + (route == "wgmma")
    assert (sa.launches[key], sa.bf16_launches[key]) == (counts[0][key] + 1, counts[1][key] + 1)
    assert sq.wgmma_launches == counts[3]  # 2F's count is its own
    sa.siren_attention_decode_fused(params, params, *stats, q, 30.0, 64)
    assert [c[0] for c in calls] == [route, "stack"] and calls[1][1]["compute_dtype"] == torch.float32


def test_cpu_calls_run_the_plain_version_uncounted():
    args = to_torch(attention_inputs(1, 2, seed=4))
    counts = [dict(c) for c in (sa.launches, sa.bf16_launches, sa.wgmma_launches, sq.wgmma_launches)]
    kw = dict(compute_dtype=BF16, sin_impl="fast")
    got = sa.siren_attention_decode_fused(*args, 30.0, 40, **kw)
    assert torch.equal(got, sa.siren_attention_decode_plain(*args, 30.0, 40, **kw))
    assert [dict(c) for c in (sa.launches, sa.bf16_launches, sa.wgmma_launches, sq.wgmma_launches)] == counts


# ---- tools/siren_kernel_outputs.py over 2D's bf16 cases ----

def test_kernel_outputs_tool_holds_2d_bf16_to_its_plain_version(tmp_path, monkeypatch, capsys):
    """2D's bf16 case is saved beside its plain output; --compare against a dump that saved the kernel's output
    alone (as before this mode had its Hopper kernel) measures both files against the plain output either holds;
    --modes --attention times 2D's bf16 mode beside 2E's and 2F's."""
    from nerf_attention_tpu_torch.tools import siren_kernel_outputs as tool

    _tiny_tool(tool, monkeypatch)
    monkeypatch.setattr(tool, "ATTENTION_CASES", {"2D": (2, 3, 40, True, None)})
    monkeypatch.setattr(tool, "ACT16_MODES", {"2E tiny": (2, 40, 32, 1), "2F tiny": (2, 40, 32, 1),
                                              "2D tiny": (2, 40, 32, 1)})
    a, b = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    assert tool.main(["--out", b, "--device", "cpu", "--attention"]) == 0
    dump = torch.load(b)
    assert len(dump["2D bf16"]) == 2 and torch.equal(dump["2D bf16"][0], dump["2D bf16"][1])
    older = {**dump, "2D bf16": [dump["2D bf16"][0] + 2.0**-8 * dump["2D bf16"][1].abs().max()]}
    torch.save(older, a)
    capsys.readouterr()
    assert tool.main(["--compare", a, b]) == 1
    out = capsys.readouterr().out
    assert "2D bf16: bit-identical = False" in out and "2D: bit-identical = True" in out
    assert "2D bf16: 1.000 / 0.000 bf16 ulps against the plain version" in out
    assert tool.main(["--modes", "--attention", "--device", "cpu"]) == 0
    rows = [eval(line, {}) for line in capsys.readouterr().out.splitlines() if line.startswith("{'case'")]
    assert [r["case"] for r in rows] == ["2E tiny", "2F tiny", "2D tiny"]
    assert all(r["ulps_vs_plain"] == 0.0 and r["float32_ms"] > 0 and r["bfloat16_ms"] > 0 for r in rows)
