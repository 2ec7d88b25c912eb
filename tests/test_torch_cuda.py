"""The CUDA kernels against their plain PyTorch versions, on a GPU.

This file imports no JAX, so it runs on a machine that has a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) Without a GPU
every test here skips. The plain versions are held to the JAX package, on
the CPU, by the other ``tests/test_torch_*.py`` files; the tolerances are
theirs.
"""

import numpy as np
import pytest
import torch

from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren
from nerf_attention_tpu_torch.ops import siren_cuda, siren_train_cuda
from nerf_attention_tpu_torch.parallel.sweep import fit_batch, normalize_targets
from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME, SIRENConfig

torch.set_num_threads(1)

DECODE_TOL = dict(atol=2e-5, rtol=1e-5)  # tests/test_torch_siren_decode.py
TRAIN_TOL = {  # tests/test_torch_siren_train.py
    "exact": dict(loss=dict(rtol=1e-5, atol=1e-6), grads=dict(rtol=1e-4, atol=1e-6)),
    "fast": dict(loss=dict(rtol=1e-3, atol=1e-5), grads=dict(rtol=1e-3, atol=1e-5)),
    "fm": dict(loss=dict(rtol=1e-3, atol=1e-4), grads=dict(rtol=1e-3, atol=1e-4)),
}
D = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _stack(config_name, n, device, seed=0):
    params = init_siren(CONFIGS_BY_NAME[config_name], D, generator=torch.Generator().manual_seed(seed), n=n)
    cpu = SirenStack.from_params(params)
    return SirenStack(cpu.flat.to(device), cpu.dims)


def _targets_norm(n, seq_len, device, seed=1):
    targets = torch.randn(n, seq_len, D, generator=torch.Generator().manual_seed(seed)).to(device)
    return normalize_targets(targets)[0].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("seq_len", [2048, 300], ids=["S2048", "ragged"])
@pytest.mark.parametrize("sin_impl, fm", [("exact", None), ("fast", None), ("exact", 64.0)],
                         ids=["exact", "fast", "fm"])
def test_decode_kernel_matches_plain(cuda_device, seq_len, sin_impl, fm):
    stack = _stack("medium", 4, cuda_device)
    kw = dict(sin_impl=sin_impl, fm_mult=fm)
    before = dict(siren_cuda.launches)
    batch = siren_cuda.siren_decode_batch(stack, 30.0, seq_len, **kw)
    one = siren_cuda.siren_decode(SirenStack(stack.flat[2:3].contiguous(), stack.dims), 30.0, seq_len, **kw)
    want = siren_cuda.siren_decode_plain(stack, 30.0, seq_len, **kw)
    torch.cuda.synchronize()
    assert siren_cuda.launches == {k: v + 1 for k, v in before.items()}
    assert batch.shape == (4, seq_len, D) and one.shape == (seq_len, D)
    torch.testing.assert_close(batch, want, **DECODE_TOL)
    torch.testing.assert_close(one, want[2], **DECODE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("config_name", ["tiny", "medium", "large"])
@pytest.mark.parametrize("sin_impl", ["exact", "fast"])
def test_train_kernel_matches_plain(cuda_device, config_name, sin_impl):
    config = CONFIGS_BY_NAME[config_name]
    tol = TRAIN_TOL[sin_impl]
    stack = _stack(config_name, 8, cuda_device)
    targets_norm = _targets_norm(8, 2048, cuda_device)
    kw = dict(omega=config.omega_0, sin_impl=sin_impl)
    loss, grads = siren_train_cuda.siren_train_grads(stack, targets_norm, **kw)
    want_loss, want_grads = siren_train_cuda.siren_train_grads_plain(stack, targets_norm, **kw)
    torch.testing.assert_close(loss, want_loss, **tol["loss"])
    torch.testing.assert_close(grads.flat, want_grads.flat, **tol["grads"])
    loss2, grads2 = siren_train_cuda.siren_train_grads(stack, targets_norm, **kw)
    assert torch.equal(loss, loss2) and torch.equal(grads.flat, grads2.flat)  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("seq_len, fm, tol", [(2048, 64.0, "fm"), (300, None, "exact")], ids=["fm", "ragged"])
def test_train_kernel_fm_and_ragged(cuda_device, seq_len, fm, tol):
    stack = _stack("medium", 3, cuda_device, seed=2)
    targets_norm = _targets_norm(3, seq_len, cuda_device, seed=3)
    before = siren_train_cuda.launches["siren_train_grads"]
    loss, grads = siren_train_cuda.siren_train_grads(stack, targets_norm, omega=30.0, fm_mult=fm)
    want_loss, want_grads = siren_train_cuda.siren_train_grads_plain(stack, targets_norm, omega=30.0, fm_mult=fm)
    assert siren_train_cuda.launches["siren_train_grads"] == before + 1
    torch.testing.assert_close(loss, want_loss, **TRAIN_TOL[tol]["loss"])
    torch.testing.assert_close(grads.flat, want_grads.flat, **TRAIN_TOL[tol]["grads"])


# Kernel 2A's shapes: every width and depth the sweep's configs use, in each
# combination, at small N; then the plan path's shape and a ragged FM case.
TRAIN_SHAPES = [(h, layers) for h in (64, 128, 256, 512) for layers in (3, 4, 5)]


def _train_case(config, n, seq_len, device, seed, d_out=D, **kw):
    """Kernel 2A and its plain version on the same nets and targets; asserts one launch."""
    gen = torch.Generator().manual_seed(seed)
    cpu = SirenStack.from_params(init_siren(config, d_out, generator=gen, n=n))
    stack = SirenStack(cpu.flat.to(device), cpu.dims)
    targets = torch.randn(n, seq_len, d_out, generator=torch.Generator().manual_seed(seed + 1)).to(device)
    targets_norm = normalize_targets(targets)[0].contiguous()
    before = siren_train_cuda.launches["siren_train_grads"]
    got = siren_train_cuda.siren_train_grads(stack, targets_norm, omega=config.omega_0, **kw)
    assert siren_train_cuda.launches["siren_train_grads"] == before + 1
    want = siren_train_cuda.siren_train_grads_plain(stack, targets_norm, omega=config.omega_0, **kw)
    return stack, targets_norm, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, n_layers", TRAIN_SHAPES, ids=[f"H{h}-L{l}" for h, l in TRAIN_SHAPES])
@pytest.mark.parametrize("sin_impl", ["exact", "fast"])
def test_train_kernel_every_width_and_depth(cuda_device, hidden, n_layers, sin_impl):
    config = SIRENConfig(hidden, n_layers - 2, 30.0, f"h{hidden}")
    _, _, (loss, grads), (want_loss, want_grads) = _train_case(config, 3, 2048, cuda_device, hidden + n_layers,
                                                               sin_impl=sin_impl)
    assert grads.dims == want_grads.dims and len(grads.dims) == n_layers
    torch.testing.assert_close(loss, want_loss, **TRAIN_TOL[sin_impl]["loss"])
    torch.testing.assert_close(grads.flat, want_grads.flat, **TRAIN_TOL[sin_impl]["grads"])


@pytest.mark.cuda
@pytest.mark.parametrize("sin_impl", ["fast", "exact"])
def test_train_kernel_at_the_plan_shape(cuda_device, sin_impl):
    """128 `small` nets at S=512, as the plan-rollout tool fits them."""
    _, _, (loss, grads), (want_loss, want_grads) = _train_case(CONFIGS_BY_NAME["small"], 128, 512, cuda_device, 5,
                                                               sin_impl=sin_impl)
    torch.testing.assert_close(loss, want_loss, **TRAIN_TOL[sin_impl]["loss"])
    torch.testing.assert_close(grads.flat, want_grads.flat, **TRAIN_TOL[sin_impl]["grads"])


@pytest.mark.cuda
@pytest.mark.parametrize("sin_impl", ["exact", "fast"])
def test_train_kernel_ragged_fm(cuda_device, sin_impl):
    """S=300 (not a multiple of the 64-row tile) with FM x64."""
    _, _, (loss, grads), (want_loss, want_grads) = _train_case(CONFIGS_BY_NAME["medium"], 4, 300, cuda_device, 6,
                                                               sin_impl=sin_impl, fm_mult=64.0)
    torch.testing.assert_close(loss, want_loss, **TRAIN_TOL["fm"]["loss"])
    torch.testing.assert_close(grads.flat, want_grads.flat, **TRAIN_TOL["fm"]["grads"])


@pytest.mark.cuda
@pytest.mark.parametrize("d_out", [16, 100], ids=["D16", "D100"])
def test_train_kernel_output_width_not_a_multiple_of_64(cuda_device, d_out):
    """The output layer padded to 64 or 128 columns in the workspace, zeros past D."""
    _, _, (loss, grads), (want_loss, want_grads) = _train_case(CONFIGS_BY_NAME["small"], 5, 300, cuda_device, 8,
                                                               d_out=d_out)
    torch.testing.assert_close(loss, want_loss, **TRAIN_TOL["exact"]["loss"])
    torch.testing.assert_close(grads.flat, want_grads.flat, **TRAIN_TOL["exact"]["grads"])


@pytest.mark.cuda
@pytest.mark.parametrize("config_name, n, seq_len, fm", [("large", 4, 2048, None), ("small", 128, 512, None),
                                                         ("tiny", 3, 300, 64.0)], ids=["large", "plan", "ragged_fm"])
def test_train_kernel_is_bit_identical_twice(cuda_device, config_name, n, seq_len, fm):
    config = CONFIGS_BY_NAME[config_name]
    stack, targets_norm, (loss, grads), _ = _train_case(config, n, seq_len, cuda_device, 7, sin_impl="fast",
                                                        fm_mult=fm)
    loss2, grads2 = siren_train_cuda.siren_train_grads(stack, targets_norm, omega=config.omega_0, sin_impl="fast",
                                                       fm_mult=fm)
    assert torch.equal(loss, loss2) and torch.equal(grads.flat, grads2.flat)


@pytest.mark.cuda
def test_train_kernel_rejects_shapes_it_does_not_take(cuda_device):
    for config, d_out in ((SIRENConfig(72, 2, 30.0, "odd"), D), (SIRENConfig(64, 0, 30.0, "shallow"), D),
                          (SIRENConfig(64, 7, 30.0, "too_deep"), D), (CONFIGS_BY_NAME["tiny"], 18)):
        stack = SirenStack.from_params(init_siren(config, d_out, generator=torch.Generator(), n=2, device=cuda_device))
        targets = torch.zeros(2, 128, d_out, device=cuda_device)
        with pytest.raises(ValueError, match="multiples of|divisible by"):
            siren_train_cuda.siren_train_grads(stack, targets, omega=30.0)


@pytest.mark.cuda
def test_train_kernel_rejects_bad_targets(cuda_device):
    stack = _stack("tiny", 2, cuda_device)
    targets_norm = _targets_norm(2, 64, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        siren_train_cuda.siren_train_grads(stack, targets_norm.transpose(1, 2).contiguous().transpose(1, 2),
                                           omega=30.0)
    with pytest.raises(ValueError, match="do not match"):
        siren_train_cuda.siren_train_grads(stack, targets_norm[:1], omega=30.0)


@pytest.mark.cuda
def test_fit_batch_on_gpu_matches_cpu(cuda_device):
    targets = np.random.default_rng(3).standard_normal((4, 256, 16)).astype(np.float32)
    medium = CONFIGS_BY_NAME["medium"]
    gpu, cpu = (fit_batch(targets, medium, epochs=30, seed=5, device=d) for d in (cuda_device, "cpu"))
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(gpu.cosine_mean, cpu.cosine_mean, rtol=0, atol=2e-3)


# ---- attention from parameters (2D, 2F) and over a packed KV cache (2I) ----

ATTN_TOL = dict(atol=5e-5, rtol=1e-4)  # tests/test_torch_siren_attention.py
KV_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_torch_kv_quant.py
LOGZ_ATOL = 1e-4  # log-partition m + log l, tests/test_torch_kv_quant.py
SCHEMES = ["int8_g32", "int6_g64", "int4_g128"]


def _attention_args(n, t, device, seed=0):
    """(k_stack, v_stack, k_mean, k_std, v_mean, v_std, q) for medium nets at D = 128."""
    from nerf_attention_tpu_torch.tools.measure_attention_decode import attention_inputs

    k_stack, v_stack, stats, q = attention_inputs(CONFIGS_BY_NAME["medium"], n, t, D,
                                                  torch.Generator().manual_seed(seed), device)
    return k_stack, v_stack, *stats, q


@pytest.mark.cuda
@pytest.mark.parametrize("seq_len, t, sin_impl, fm, causal", [
    (2048, 1, "fast", None, False), (300, 16, "exact", None, True), (2048, 16, "fast", 64.0, True),
    (300, 1, "fast", None, True),
], ids=["S2048", "T16_exact_ragged", "T16_fm", "ragged"])
def test_attention_kernel_matches_plain(cuda_device, seq_len, t, sin_impl, fm, causal):
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa

    args = _attention_args(4, t, cuda_device, seed=seq_len + t)
    kw = dict(sin_impl=sin_impl, fm_mult=fm, causal=causal)
    before = sa.launches["siren_attention_decode_fused"]
    got = sa.siren_attention_decode_fused(*args, 30.0, seq_len, **kw)
    want = sa.siren_attention_decode_plain(*args, 30.0, seq_len, **kw)
    torch.cuda.synchronize()
    assert sa.launches["siren_attention_decode_fused"] == before + 1
    assert got.shape == (4, t, D)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    assert torch.equal(got, sa.siren_attention_decode_fused(*args, 30.0, seq_len, **kw))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES)
def test_quant_kernel_matches_plain_and_2d_on_dequant(cuda_device, scheme):
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    k_stack, v_stack, *rest = _attention_args(4, 4, cuda_device, seed=5)
    packed = (sq.pack_resident_params(k_stack.params(), scheme), sq.pack_resident_params(v_stack.params(), scheme))
    kw = dict(sin_impl="fast", causal=True)
    before = sq.launches["siren_attention_decode_quant"]
    o, m, l = sq.siren_attention_decode_quant(None, None, *rest, scheme, 30.0, 1000, packed=packed,
                                              return_stats=True, **kw)
    want_o, want_m, want_l = sq.siren_attention_decode_quant_plain(packed, *rest, 30.0, 1000, return_stats=True, **kw)
    assert sq.launches["siren_attention_decode_quant"] == before + 1
    torch.testing.assert_close(o, want_o, **ATTN_TOL)
    torch.testing.assert_close(m + torch.log(l), want_m + torch.log(want_l), atol=LOGZ_ATOL, rtol=0)
    dequant = [SirenStack.from_params(sq.unpack_resident_params(*p)) for p in packed]
    fused = sa.siren_attention_decode_fused(*dequant, *rest, 30.0, 1000, **kw)
    assert torch.equal(o, fused)  # the same fp32 weights through the same products


@pytest.mark.cuda
@pytest.mark.parametrize("scheme, seq_len, sin_impl, fm", [
    ("int8_g32", 512, "fast", None), ("int4_g128", 512, "fast", None), ("int6_g64", 300, "exact", None),
    ("int4_g32", 300, "fast", None), ("int8_g32_l0fp32", 300, "exact", 32.0),
], ids=["int8_g32", "int4_g128", "int6_g64_ragged", "int4_g32_ragged", "l0fp32_fm"])
def test_decode_quant_kernel_matches_plain_and_2c_on_dequant(cuda_device, scheme, seq_len, sin_impl, fm):
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    stack = _stack("small", 6, cuda_device, seed=4)
    packed = sq.pack_resident_params(stack.params(), scheme)
    kw = dict(sin_impl=sin_impl, fm_mult=fm)
    before = sq.launches["siren_decode_batch_quant"]
    got = sq.siren_decode_batch_quant(None, scheme, 30.0, seq_len, packed=packed, **kw)
    want = sq.siren_decode_batch_quant_plain(packed, 30.0, seq_len, **kw)
    torch.cuda.synchronize()
    assert sq.launches["siren_decode_batch_quant"] == before + 1
    assert got.shape == (6, seq_len, D)
    torch.testing.assert_close(got, want, **DECODE_TOL)
    dequant = SirenStack.from_params(sq.unpack_resident_params(*packed))
    assert torch.equal(got, siren_cuda.siren_decode_batch(dequant, 30.0, seq_len, **kw))  # 2C's products exactly
    assert torch.equal(got, sq.siren_decode_batch_quant(None, scheme, 30.0, seq_len, packed=packed, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("seq_len", [2048, 300], ids=["S2048", "ragged"])
def test_kv_quant_kernel_matches_plain(cuda_device, scheme, seq_len):
    from nerf_attention_tpu_torch.ops import kv_quant_cuda as kq

    gen = torch.Generator().manual_seed(seq_len)
    ck, cv = (torch.randn(8, seq_len, D, generator=gen).to(cuda_device) for _ in range(2))
    q = (torch.randn(8, 2, D, generator=gen) * 0.4).to(cuda_device)
    pk, pv = kq.pack_kv_unit_stack(ck, scheme), kq.pack_kv_unit_stack(cv, scheme)
    for pos in (seq_len, seq_len - 37, 1):
        before = kq.launches["kv_cache_attention_quant"]
        o, m, l = kq.kv_cache_attention_quant(q, pk, pv, pos, scale=D ** -0.5, return_stats=True)
        want_o, want_m, want_l = kq.kv_cache_attention_quant_plain(q, pk, pv, pos, scale=D ** -0.5,
                                                                   return_stats=True)
        assert kq.launches["kv_cache_attention_quant"] == before + 1
        torch.testing.assert_close(o, want_o, **KV_TOL)
        torch.testing.assert_close(m + torch.log(l), want_m + torch.log(want_l), atol=LOGZ_ATOL, rtol=0)
        assert torch.equal(o, kq.kv_cache_attention_quant(q, pk, pv, pos, scale=D ** -0.5))


@pytest.mark.cuda
def test_kv_quant_kernel_at_position_zero(cuda_device):
    from nerf_attention_tpu_torch.ops import kv_quant_cuda as kq

    gen = torch.Generator().manual_seed(1)
    ck, cv = (torch.randn(8, 512, D, generator=gen).to(cuda_device) for _ in range(2))
    q = torch.randn(8, 1, D, generator=gen).to(cuda_device)
    pk, pv = kq.pack_kv_unit_stack(ck, "int4_g128"), kq.pack_kv_unit_stack(cv, "int4_g128")
    o, m, l = kq.kv_cache_attention_quant(q, pk, pv, 0, scale=D ** -0.5, return_stats=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(m, torch.full_like(m, -1e30)) and torch.equal(l, torch.zeros_like(l))


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["int6_g24", "int4_g6", "int5_g12"])
def test_quant_kernel_odd_widths_and_groups(cuda_device, scheme):
    """Hidden width 72 (an int6 quarter plane of 18 rows) and groups that are
    not powers of two, or not multiples of 4: the loader's slower paths."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
    from nerf_attention_tpu_torch.types import SIRENConfig

    gen = torch.Generator().manual_seed(9)
    config = SIRENConfig(72, 2, 30.0, "odd")
    k_stack, v_stack = (SirenStack.from_params(init_siren(config, D, generator=gen, n=3, device=cuda_device))
                        for _ in range(2))
    zeros, ones = torch.zeros(3, 1, D, device=cuda_device), torch.ones(3, 1, D, device=cuda_device)
    q = (torch.randn(3, 2, D, generator=gen) * 0.8).to(cuda_device)
    packed = (sq.pack_resident_params(k_stack.params(), scheme), sq.pack_resident_params(v_stack.params(), scheme))
    got = sq.siren_attention_decode_quant(None, None, zeros, ones, zeros, ones, q, scheme, 30.0, 500, packed=packed)
    want = sq.siren_attention_decode_quant_plain(packed, zeros, ones, zeros, ones, q, 30.0, 500)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    dequant = [SirenStack.from_params(sq.unpack_resident_params(*p)) for p in packed]
    assert torch.equal(got, sa.siren_attention_decode_fused(*dequant, zeros, ones, zeros, ones, q, 30.0, 500))


# ---- MLA: absorbed attention over the latent (2G) and over packed latents (2H) ----

MLA_H, MLA_R, MLA_ROPE = 16, 512, 64  # DeepSeek-V2-Lite's attention
MLA_TOL = dict(atol=2e-5, rtol=1e-5)  # fp32: the plain version's sums in another order
# bf16: the kernel rounds each softmax weight to bf16 relative to its 32-row
# tile's running max, the plain version relative to the global max: up to
# 2^-9 of each weight apart (tests/test_torch_mla_absorbed.py). The errors of
# many weights mostly cancel, so o_lat's error is held to this share of the
# case's own largest |o_lat|.
MLA_BF16_REL = 1e-2
MLA_CASES = [(s, p) for s in (0, 1, 37, 300, 2048) for p in sorted({0, 1, s - 5, s}) if 0 <= p <= s]


def _mla_inputs(s_buf, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    d = MLA_R + MLA_ROPE
    q = (torch.randn(MLA_H, d, generator=gen) * 0.1).to(device)
    cache = torch.randn(s_buf, d, generator=gen).to(device)
    new = torch.randn(1, d, generator=gen).to(device)
    return q, cache, new


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("s_buf, position", MLA_CASES, ids=[f"S{s}-pos{p}" for s, p in MLA_CASES])
def test_mla_absorbed_kernel_matches_plain(cuda_device, s_buf, position, dtype):
    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda as ma

    q, cache, new = _mla_inputs(s_buf, cuda_device, seed=s_buf)
    cache = cache.to(dtype)
    args = dict(kv_lora_rank=MLA_R, scale=192 ** -0.5)
    before = ma.launches["mla_absorbed_attention"]
    o, ent = ma.mla_absorbed_attention(q, cache, new, position, **args)
    want_o, want_ent = ma.mla_absorbed_attention_plain(q, cache, new, position, **args)
    torch.cuda.synchronize()
    assert ma.launches["mla_absorbed_attention"] == before + 1
    bf16_tol = dict(rtol=0, atol=MLA_BF16_REL * want_o.abs().max().item())
    torch.testing.assert_close(o, want_o, **(MLA_TOL if dtype == torch.float32 else bf16_tol))
    torch.testing.assert_close(ent, want_ent, **MLA_TOL)
    if position == 0:
        assert torch.equal(o, new[0, :MLA_R].to(dtype).float().expand(MLA_H, MLA_R))
        assert torch.equal(ent, torch.zeros_like(ent))
    o2, ent2 = ma.mla_absorbed_attention(q, cache, new, position, **args)
    assert torch.equal(o, o2) and torch.equal(ent, ent2)  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["int8_g32", "int6_g64", "int4_g64"])
def test_mla_quant_kernel_matches_plain_and_2g_on_dequant(cuda_device, scheme):
    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda as ma
    from nerf_attention_tpu_torch.ops import mla_quant_cuda as mq

    q, latent, new = _mla_inputs(2348, cuda_device, seed=3)  # two 1024-row tiles and a ragged third
    packed = mq.pack_resident_latent(latent, scheme)
    dequant = mq.unpack_resident_latent(*packed)
    args = dict(kv_lora_rank=MLA_R, scale=192 ** -0.5)
    for pos in (2348, 2348 - 37, 1024, 1, 0):
        before = mq.launches["mla_absorbed_attention_quant"]
        o, ent = mq.mla_absorbed_attention_quant(q, packed, new, pos, **args)
        want_o, want_ent = mq.mla_absorbed_attention_quant_plain(q, packed, new, pos, **args)
        torch.cuda.synchronize()
        assert mq.launches["mla_absorbed_attention_quant"] == before + 1
        torch.testing.assert_close(o, want_o, **MLA_TOL)
        torch.testing.assert_close(ent, want_ent, **MLA_TOL)
        o_2g, ent_2g = ma.mla_absorbed_attention(q, dequant, new, pos, **args)
        assert torch.equal(o, o_2g) and torch.equal(ent, ent_2g)  # the same fp32 rows through the same ops


@pytest.mark.cuda
def test_mla_decode_steps_on_the_gpu(cuda_device):
    """A tiny V3 MLA stack with a MoE layer: the absorbed step through 2G and
    the quant step through 2H against their plain versions on the card."""
    from nerf_attention_tpu_torch.models import mla
    from nerf_attention_tpu_torch.ops.mla_quant_cuda import unpack_resident_latent

    cfg = mla.MLAConfig.from_hf_dict(dict(
        model_type="deepseek_v3", vocab_size=64, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        first_k_dense_replace=1, moe_intermediate_size=24, n_routed_experts=4, num_experts_per_tok=2,
        n_shared_experts=1, n_group=2, topk_group=1))
    params = mla.init_random_mla(cfg, seed=1, device=cuda_device)
    lat = (torch.randn(2, 256, cfg.latent_dim, generator=torch.Generator().manual_seed(2)) * 0.5).to(cuda_device)
    h, lat_new, ent = mla.mla_decode_step_absorbed(cfg, params, 5, 200, lat, attn_impl="cuda")
    want = mla.mla_decode_step_absorbed(cfg, params, 5, 200, lat)
    for got, exp in zip((h, lat_new, ent), want):
        torch.testing.assert_close(got, exp, **MLA_TOL)
    ops, layout = mla.pack_mla_latent_stack(lat, "int6_g64")
    h_q, _, ent_q = mla.mla_decode_step_absorbed_quant(cfg, params, 5, 200, ops, layout)
    lat_dq = torch.stack([unpack_resident_latent([o[i] for o in ops], layout) for i in range(2)])
    dequant = mla.mla_decode_step_absorbed(cfg, params, 5, 200, lat_dq, attn_impl="cuda")
    assert torch.equal(h_q, dequant[0]) and torch.equal(ent_q, dequant[2])
