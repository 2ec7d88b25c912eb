"""The bf16 modes of kernels 2D, 2E and 2F: the port's plain versions against
the JAX Pallas kernels (interpret mode, ``compute_dtype=bfloat16``) on the
same numpy-seeded nets.

The casting points are JAX's. 2D rounds every weight, bias and hidden
activation to bf16 (``siren_attention_pallas.py:_flat_weights``); 2E and 2F
round only the activations, since their weight views hand the layer stack
fp32 values and ``jnp.dot(bf16, fp32)`` promotes to fp32. 2D and 2F keep q.k
and the softmax in fp32 and round p and V to bf16 for p.V; their outputs are
fp32, 2E's bf16. The sums run in another order than the kernels' (the online
softmax's running max, the products' order), so a hidden activation near a
rounding boundary may land on the other bf16 neighbour: outputs are held to
ULPS bf16 ulps of the largest |output| (ULPS * 2^-8 * max|y|). The largest
gaps measured on these cases: 2D 0.04 ulps, 2F 0.03, 2E 1.01. Rounding 2E's
weights as 2D does would put it 8.7 ulps from the JAX kernel (int8_g32 case).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_attention_tpu.ops.siren_attention_pallas import siren_attention_decode_fused as jax_fused
from nerf_attention_tpu.ops.siren_quant_pallas import (
    siren_attention_decode_quant as jax_attn_quant,
    siren_decode_batch_quant as jax_decode_quant,
)
from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
from test_torch_siren_attention import D, attention_inputs, siren_heads, to_jax, to_torch

torch.set_num_threads(1)
ULPS = 4
BF16 = torch.bfloat16


def _ulps(got: torch.Tensor, want) -> float:
    """|got - want| in bf16 ulps of max|want|, asserted within ULPS."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    gap = float(np.abs(got.float().numpy() - want).max()) / (2.0**-8 * float(np.abs(want).max()))
    assert gap <= ULPS, gap
    return gap


CASES = [  # (n, t, seq_len, sin_impl, fm_mult, causal)
    (2, 8, 300, "fast", None, True),
    (2, 1, 257, "fast", None, False),
    (2, 4, 150, "fast", 64.0, True),
    (1, 2, 100, "exact", None, True),
]
IDS = ["causal", "single_query", "fm", "exact"]


@pytest.mark.parametrize("n, t, seq_len, sin_impl, fm, causal", CASES, ids=IDS)
def test_2d_bf16_plain_matches_jax_kernel(n, t, seq_len, sin_impl, fm, causal):
    args = attention_inputs(n, t, seed=n * 10 + t)
    kw = dict(sin_impl=sin_impl, fm_mult=fm, causal=causal)
    got = sa.siren_attention_decode_fused(*to_torch(args), 30.0, seq_len, compute_dtype=BF16, **kw)
    want = jax_fused(*to_jax(args), 30.0, seq_len, tile=128, interpret=True, compute_dtype=jnp.bfloat16, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, t, D)
    _ulps(got, want)
    fp32 = sa.siren_attention_decode_fused(*to_torch(args), 30.0, seq_len, **kw)
    assert not torch.equal(fp32, got)  # the modes differ; the default is fp32


@pytest.mark.parametrize("scheme, causal, sin_impl", [("int8_g32", True, "fast"), ("int4_g128", False, "fast"),
                                                      ("int6_g64", True, "exact"), ("fp32", True, "fast")])
def test_2f_bf16_plain_matches_jax_kernel(scheme, causal, sin_impl):
    args = attention_inputs(2, 4, seed=7)
    kw = dict(sin_impl=sin_impl, causal=causal)
    got, m, l = sq.siren_attention_decode_quant(*to_torch(args), scheme, 30.0, 200, return_stats=True,
                                                compute_dtype=BF16, **kw)
    want, want_m, want_l = jax_attn_quant(*to_jax(args), scheme, 30.0, 200, tile=128, interpret=True,
                                          return_stats=True, compute_dtype=jnp.bfloat16, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, D)
    _ulps(got, want)
    np.testing.assert_allclose((m + torch.log(l)).numpy(), np.asarray(want_m) + np.log(np.asarray(want_l)),
                               atol=1e-4)


@pytest.mark.parametrize("scheme, fm, sin_impl", [("int8_g32", None, "exact"), ("int4_g128", 16.0, "fast"),
                                                  ("int6_g64", None, "fast"), ("int4_g32_l0fp32", None, "exact")])
def test_2e_bf16_plain_matches_jax_kernel(scheme, fm, sin_impl):
    params = siren_heads(3, 64, 2, seed=11)
    got = sq.siren_decode_batch_quant([(torch.tensor(w), torch.tensor(b)) for w, b in params], scheme, 30.0, 160,
                                      sin_impl=sin_impl, fm_mult=fm, compute_dtype=BF16)
    want = jax_decode_quant([(jnp.asarray(w), jnp.asarray(b)) for w, b in params], scheme, 30.0, 160, tile=128,
                            interpret=True, compute_dtype=jnp.bfloat16, sin_impl=sin_impl, fm_mult=fm)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16 and tuple(got.shape) == (3, 160, D)
    _ulps(got, want)


def test_2f_bf16_equals_itself_on_dense_dequantized_weights():
    """2F's bf16 mode over packed weights is the host dequant shipped dense (scheme fp32) in the
    same mode, exactly; 2D's bf16 mode, which rounds the weights too, is another result (as in JAX)."""
    args = attention_inputs(2, 3, seed=3)
    k, v, *rest = to_torch(args)
    packed = (sq.pack_resident_params(k, "int4_g128"), sq.pack_resident_params(v, "int4_g128"))
    dequant = [sq.unpack_resident_params(*p) for p in packed]
    dense = tuple(sq.pack_resident_params(p, "fp32") for p in dequant)
    kw = dict(compute_dtype=BF16, sin_impl="fast")
    got = sq.siren_attention_decode_quant(None, None, *rest, "int4_g128", 30.0, 128, packed=packed, **kw)
    twin = sq.siren_attention_decode_quant(None, None, *rest, "fp32", 30.0, 128, packed=dense, **kw)
    assert torch.equal(got, twin)
    rounded = sa.siren_attention_decode_fused(*dequant, *rest, 30.0, 128, **kw)
    assert not torch.equal(got, rounded)
    jax_2f = jax_attn_quant(*to_jax(args), "int4_g128", 30.0, 128, tile=128, interpret=True,
                            compute_dtype=jnp.bfloat16, sin_impl="fast")
    jax_2d = jax_fused(*[[(jnp.asarray(w.numpy()), jnp.asarray(b.numpy())) for w, b in p] for p in dequant],
                       *to_jax(args)[2:], 30.0, 128, tile=128, interpret=True, compute_dtype=jnp.bfloat16,
                       sin_impl="fast")
    assert not np.array_equal(np.asarray(jax_2f), np.asarray(jax_2d))


def test_2e_bf16_rounds_only_activations():
    """A one-unit net whose weights bf16 cannot hold: 2E's bf16 output is the fp32 product
    of the rounded activation and the fp32 weight, rounded once."""
    w1 = torch.tensor([[[1.0 + 2.0**-12, -3.0 + 2.0**-10]]])
    params = [(torch.tensor([[[0.5]]]), torch.tensor([[0.25]])), (w1, torch.tensor([[0.125 + 2.0**-14, 0.0]]))]
    got = sq.siren_decode_batch_quant(params, "fp32", 1.0, 9, compute_dtype=BF16)
    h = torch.sin(torch.linspace(0, 1, 9)[:, None] * 0.5 + 0.25).to(BF16).float()
    assert torch.equal(got[0], (h @ w1[0] + params[1][1]).to(BF16))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_are_refused(dtype):
    args = to_torch(attention_inputs(1, 1, seed=0))
    with pytest.raises(ValueError, match="compute_dtype"):
        sa.siren_attention_decode_fused(*args, 30.0, 16, compute_dtype=dtype)
    with pytest.raises(ValueError, match="compute_dtype"):
        sq.siren_attention_decode_quant(*args[:-1], args[-1], "int8_g32", 30.0, 16, compute_dtype=dtype)
    with pytest.raises(ValueError, match="compute_dtype"):
        sq.siren_decode_batch_quant(args[0], "int8_g32", 30.0, 16, compute_dtype=dtype)


def test_cpu_calls_launch_nothing():
    before = (dict(sa.launches), dict(sa.bf16_launches), dict(sq.launches), dict(sq.bf16_launches))
    args = to_torch(attention_inputs(1, 1, seed=1))
    sa.siren_attention_decode_fused(*args, 30.0, 32, compute_dtype=BF16)
    sq.siren_attention_decode_quant(*args, "int8_g32", 30.0, 32, compute_dtype=BF16)
    sq.siren_decode_batch_quant(args[0], "int8_g32", 30.0, 32, compute_dtype=BF16)
    assert before == (sa.launches, sa.bf16_launches, sq.launches, sq.bf16_launches)


def test_kernel_outputs_tool_attention_cases_on_the_cpu(tmp_path, monkeypatch, capsys):
    """tools/siren_kernel_outputs.py --attention: 2D, 2F (with its stats) and 2E cases in the dump, compared."""
    from nerf_attention_tpu_torch.tools import siren_kernel_outputs as tool

    monkeypatch.setattr(tool, "DECODE_CASES", {"2C tiny": (32, 1, 2, 40, "exact", None)})
    monkeypatch.setattr(tool, "TRAIN_CASES", {})
    monkeypatch.setattr(tool, "BF16_CASES", {})
    monkeypatch.setattr(tool, "ATTENTION_CASES", {"2D": (2, 1, 40, False, None), "2F": (2, 3, 40, True, "int8_g32"),
                                                  "2E decode": (2, 0, 40, False, "int4_g32")})
    monkeypatch.setattr(tool, "D", 8)
    a, b = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    assert tool.main(["--out", a, "--device", "cpu", "--attention"]) == 0
    assert tool.main(["--out", b, "--device", "cpu"]) == 0
    dump = torch.load(a)
    assert [len(dump[k]) for k in ("2C tiny", "2D", "2F", "2E decode")] == [1, 1, 3, 1]
    # the bf16 modes beside, each followed by its plain version's output
    assert [len(dump[k]) for k in ("2D bf16", "2F bf16", "2E decode bf16")] == [2, 4, 2]
    assert dump["2E decode bf16"][0].dtype == torch.bfloat16 and not torch.equal(dump["2D bf16"][0], dump["2D"][0])
    assert tool.main(["--compare", b, a]) == 0 and tool.main(["--compare", a, b]) == 1  # b lacks the attention cases
    assert "7 cases saved" in capsys.readouterr().out


def test_one_attention_library_per_arithmetic():
    """csrc/siren_attention.cuh is built once per mode, each library's source naming its Precision."""
    from nerf_attention_tpu_torch.ops import _build
    from nerf_attention_tpu_torch.ops.siren_cuda import PREC_ACT16, PREC_BF16, PREC_F32

    precs = {PREC_F32: "kF32", PREC_BF16: "kBF16", PREC_ACT16: "kAct16"}
    assert set(sa.LIBRARIES) == set(precs) and len(set(sa.LIBRARIES.values())) == 3
    for prec, name in sa.LIBRARIES.items():
        source = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert f"#define SIREN_ATTENTION_PREC siren::{precs[prec]}" in source
        assert '#include "siren_attention.cuh"' in source
    header = (_build.CSRC_DIR / "siren_common.cuh").read_text()
    assert "enum Precision { kF32 = 0, kBF16 = 1, kAct16 = 2 };" in header  # the Python constants' values
