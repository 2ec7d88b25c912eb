"""The CUDA kernels against their plain PyTorch versions, on a GPU.

This file imports no JAX, so it runs on a machine that has a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) Without a GPU
every test here skips. The plain versions are held to the JAX package, on
the CPU, by the other ``tests/test_torch_*.py`` files; the tolerances are
theirs.
"""

import math

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
    assert torch.equal(batch, siren_cuda.siren_decode_batch(stack, 30.0, seq_len, **kw))  # no atomics


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


@pytest.mark.cuda
@pytest.mark.parametrize("seq_len, sin_impl, fm", [(2304, "fast", None), (4096, "exact", None), (300, "fast", 64.0)],
                         ids=["S2304-fast", "S4096-exact", "ragged-fm"])
def test_kernels_with_total_len_match_plain(cuda_device, seq_len, sin_impl, fm):
    """2A and 2C with coordinates pinned to a longer cache (s / (total_len - 1)) against their plain versions;
    total_len == S is the default convention bit for bit."""
    total_len = 4096
    stack = _stack("medium", 4, cuda_device, seed=5)
    targets_norm = _targets_norm(4, seq_len, cuda_device, seed=6)
    kw = dict(omega=30.0, sin_impl=sin_impl, fm_mult=fm)
    loss, grads = siren_train_cuda.siren_train_grads(stack, targets_norm, total_len=total_len, **kw)
    want_loss, want_grads = siren_train_cuda.siren_train_grads_plain(stack, targets_norm, total_len=total_len, **kw)
    tol = TRAIN_TOL["fm" if fm else sin_impl]
    torch.testing.assert_close(loss, want_loss, **tol["loss"])
    torch.testing.assert_close(grads.flat, want_grads.flat, **tol["grads"])
    dkw = dict(sin_impl=sin_impl, fm_mult=fm)
    got = siren_cuda.siren_decode_batch(stack, 30.0, seq_len, total_len=total_len, **dkw)
    want = siren_cuda.siren_decode_plain(stack, 30.0, seq_len, total_len=total_len, **dkw)
    torch.testing.assert_close(got, want, **DECODE_TOL)
    same = siren_cuda.siren_decode_batch(stack, 30.0, seq_len, total_len=seq_len, **dkw)
    assert torch.equal(same, siren_cuda.siren_decode_batch(stack, 30.0, seq_len, **dkw))
    loss_s, grads_s = siren_train_cuda.siren_train_grads(stack, targets_norm, total_len=seq_len, **kw)
    loss_d, grads_d = siren_train_cuda.siren_train_grads(stack, targets_norm, **kw)
    assert torch.equal(loss_s, loss_d) and torch.equal(grads_s.flat, grads_d.flat)
    with pytest.raises(ValueError, match="total_len"):
        siren_cuda.siren_decode_batch(stack, 30.0, seq_len, total_len=seq_len - 1)


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
    """Every width and 2-16 layers are taken; a 17-layer net raises, naming the limit."""
    stack = SirenStack.from_params(init_siren(SIRENConfig(64, 15, 30.0, "too_deep"), D, generator=torch.Generator(),
                                              n=2, device=cuda_device))
    with pytest.raises(ValueError, match="2 to 16 layers"):
        siren_train_cuda.siren_train_grads(stack, torch.zeros(2, 128, D, device=cuda_device), omega=30.0)


# Shapes the kernels compute at only after zero padding (ops/_launch.py:pad_stack):
# hidden 96 (2A pads to 128), no hidden layer, D=3 and 18 (2A pads to 4 and 20;
# the decode stack to 8 and 24), hidden 72, and 16 layers.
PADDED_SHAPES = [(96, 1, D), (64, 0, D), (64, 1, 3), (72, 2, 18), (32, 14, 16)]
PADDED_IDS = ["H96", "no_hidden", "D3", "H72_D18", "L16"]


# Each shape exact, and but for the 16-layer net with fast sine and FM x64: there fp32 rounding, carried
# through 15 sine layers after a first layer at up to 64x the base frequency, exceeds the tolerances; the
# plain version's own error against a float64 evaluation does too (chip_smoke.py: fm_depth_witness).
PADDED_CASES = [(*shape, "exact", None) for shape in PADDED_SHAPES] + [(*shape, "fast", 64.0)
                                                                       for shape in PADDED_SHAPES[:-1]]
PADDED_CASE_IDS = [f"{i}-exact" for i in PADDED_IDS] + [f"{i}-fast_fm" for i in PADDED_IDS[:-1]]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, layers, d_out, sin_impl, fm", PADDED_CASES, ids=PADDED_CASE_IDS)
def test_train_kernel_on_padded_shapes(cuda_device, hidden, layers, d_out, sin_impl, fm):
    config = SIRENConfig(hidden, layers, 30.0, "padded")
    stack, targets_norm, (loss, grads), (want_loss, want_grads) = _train_case(
        config, 3, 300, cuda_device, hidden + layers, d_out=d_out, sin_impl=sin_impl, fm_mult=fm)
    tol = TRAIN_TOL["fm" if fm else sin_impl]
    assert grads.dims == stack.dims
    torch.testing.assert_close(loss, want_loss, **tol["loss"])
    torch.testing.assert_close(grads.flat, want_grads.flat, **tol["grads"])
    loss2, grads2 = siren_train_cuda.siren_train_grads(stack, targets_norm, omega=30.0, sin_impl=sin_impl, fm_mult=fm)
    assert torch.equal(loss, loss2) and torch.equal(grads.flat, grads2.flat)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, layers, d_out, sin_impl, fm", PADDED_CASES, ids=PADDED_CASE_IDS)
def test_decode_kernel_on_padded_shapes(cuda_device, hidden, layers, d_out, sin_impl, fm):
    gen = torch.Generator().manual_seed(hidden + layers)
    stack = SirenStack.from_params(init_siren(SIRENConfig(hidden, layers, 30.0, "padded"), d_out, generator=gen,
                                              n=3, device=cuda_device))
    kw = dict(sin_impl=sin_impl, fm_mult=fm)
    got = siren_cuda.siren_decode_batch(stack, 30.0, 300, **kw)
    want = siren_cuda.siren_decode_plain(stack, 30.0, 300, **kw)
    assert got.shape == (3, 300, d_out)
    torch.testing.assert_close(got, want, **DECODE_TOL)
    assert torch.equal(got, siren_cuda.siren_decode_batch(stack, 30.0, 300, **kw))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, layers, d_out", PADDED_SHAPES, ids=PADDED_IDS)
def test_attention_kernel_on_padded_shapes(cuda_device, hidden, layers, d_out):
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa

    gen = torch.Generator().manual_seed(hidden + layers)
    config = SIRENConfig(hidden, layers, 30.0, "padded")
    k, v = (SirenStack.from_params(init_siren(config, d_out, generator=gen, n=2, device=cuda_device)) for _ in "kv")
    stats = [(torch.rand(2, 1, d_out, generator=gen) + 0.5).to(cuda_device) for _ in range(4)]
    q = torch.randn(2, 4, d_out, generator=gen).to(cuda_device)
    got = sa.siren_attention_decode_fused(k, v, *stats, q, 30.0, 300, causal=True)
    want = sa.siren_attention_decode_plain(k, v, *stats, q, 30.0, 300, causal=True)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    assert torch.equal(got, sa.siren_attention_decode_fused(k, v, *stats, q, 30.0, 300, causal=True))


# Wider than a 16-row tile's accumulators hold (512 at 16 warps, 256 at 8): the stack's wide tile, whose
# activations lie in device scratch and whose products run in passes of 512 columns. 3632 is the widest
# net the fp32 SIMT stack before it took (two 8-row activation buffers in a block's shared memory).
WIDE_SHAPES = [(600, 1, D), (2048, 1, D), (3632, 0, 100)]
WIDE_IDS = ["H600", "H2048", "H3632_no_hidden_D100"]


def _wide_stacks(hidden, layers, d_out, n, device, count=1):
    gen = torch.Generator().manual_seed(hidden + layers)
    config = SIRENConfig(hidden, layers, 30.0, "wide")
    return [SirenStack.from_params(init_siren(config, d_out, generator=gen, n=n, device=device))
            for _ in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, layers, d_out", WIDE_SHAPES, ids=WIDE_IDS)
@pytest.mark.parametrize("sin_impl, fm", [("exact", None), ("fast", 32.0)], ids=["exact", "fast_fm"])
def test_decode_kernel_on_wide_nets(cuda_device, hidden, layers, d_out, sin_impl, fm):
    (stack,) = _wide_stacks(hidden, layers, d_out, 2, cuda_device)
    kw = dict(sin_impl=sin_impl, fm_mult=fm)
    got = siren_cuda.siren_decode_batch(stack, 30.0, 300, **kw)
    want = siren_cuda.siren_decode_plain(stack, 30.0, 300, **kw)
    assert got.shape == (2, 300, d_out)
    torch.testing.assert_close(got, want, **DECODE_TOL)
    assert torch.equal(got, siren_cuda.siren_decode_batch(stack, 30.0, 300, **kw))
    one = siren_cuda.siren_decode(SirenStack(stack.flat[1:].contiguous(), stack.dims), 30.0, 300, **kw)
    torch.testing.assert_close(one, want[1], **DECODE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["int8_g32", "int4_g128"])
def test_decode_quant_kernel_on_wide_nets_equals_2c_on_dequant(cuda_device, scheme):
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    (stack,) = _wide_stacks(2048, 1, D, 2, cuda_device)
    packed = sq.pack_resident_params(stack.params(), scheme)
    got = sq.siren_decode_batch_quant(None, scheme, 30.0, 300, packed=packed, sin_impl="fast")
    torch.testing.assert_close(got, sq.siren_decode_batch_quant_plain(packed, 30.0, 300, sin_impl="fast"),
                               **DECODE_TOL)
    dequant = SirenStack.from_params(sq.unpack_resident_params(*packed))
    assert torch.equal(got, siren_cuda.siren_decode_batch(dequant, 30.0, 300, sin_impl="fast"))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, layers, d_out", WIDE_SHAPES[:2], ids=WIDE_IDS[:2])
def test_attention_kernels_on_wide_nets(cuda_device, hidden, layers, d_out):
    """2D against its plain version, and 2F on packed weights equal to 2D on the dequantized ones."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    k, v = _wide_stacks(hidden, layers, d_out, 2, cuda_device, count=2)
    gen = torch.Generator().manual_seed(hidden)
    stats = [(torch.rand(2, 1, d_out, generator=gen) + 0.5).to(cuda_device) for _ in range(4)]
    q = torch.randn(2, 4, d_out, generator=gen).to(cuda_device)
    got = sa.siren_attention_decode_fused(k, v, *stats, q, 30.0, 300, causal=True)
    want = sa.siren_attention_decode_plain(k, v, *stats, q, 30.0, 300, causal=True)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    assert torch.equal(got, sa.siren_attention_decode_fused(k, v, *stats, q, 30.0, 300, causal=True))
    packed = tuple(sq.pack_resident_params(s.params(), "int4_g128") for s in (k, v))
    quant = sq.siren_attention_decode_quant(None, None, *stats, q, "int4_g128", 30.0, 300, packed=packed)
    dequant = [SirenStack.from_params(sq.unpack_resident_params(*p)) for p in packed]
    assert torch.equal(quant, sa.siren_attention_decode_fused(*dequant, *stats, q, 30.0, 300))


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
@pytest.mark.parametrize("scheme", ["int4_g128", "int8_g32"])
def test_decode_quant_kernel_on_a_compressed_checkpoint_equals_2c_on_it_reloaded(cuda_device, tmp_path, scheme):
    """2E on the resident payload of checkpoints' master weights against 2C on the same checkpoints written by
    compress and reloaded through the loader: the at-rest format and the resident one hold the same grid."""
    from nerf_attention_tpu_torch import compress
    from nerf_attention_tpu_torch.io import checkpoint
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    medium = CONFIGS_BY_NAME["medium"]
    stack = _stack("medium", 3, "cpu", seed=7)
    for i in range(3):
        checkpoint.save_siren_checkpoint(
            tmp_path / "fits" / f"L0_H{i}_key_medium_model.npz", [(w[i].numpy(), b[i].numpy()) for w, b in stack.params()],
            medium, D, np.zeros((1, D), np.float32), np.ones((1, D), np.float32),
            {"name": f"L0_H{i}_key_medium", "layer": 0, "head": i, "kv_type": "key"})
    compress.main(["--siren_dir", str(tmp_path / "fits"), "--out_dir", str(tmp_path / "out"), "--scheme", scheme])
    files = checkpoint.checkpoint_glob(tmp_path / "fits")

    def batched(params_list):
        return [(torch.from_numpy(np.stack([p[i][0] for p in params_list])).to(cuda_device),
                 torch.from_numpy(np.stack([p[i][1] for p in params_list])).to(cuda_device))
                for i in range(len(params_list[0]))]

    master = batched([checkpoint.load_siren_checkpoint(f)["params"] for f in files])
    reloaded = batched([checkpoint.load_siren_checkpoint(tmp_path / "out" / f.name)["params"] for f in files])
    got = sq.siren_decode_batch_quant(None, scheme, 30.0, 2048, packed=sq.pack_resident_params(master, scheme))
    assert torch.equal(got, siren_cuda.siren_decode_batch(reloaded, 30.0, 2048))


KV_CASES = [(scheme, seq_len, t, D) for scheme in SCHEMES for seq_len in (2048, 300) for t in (2, 1, 4, 8)] + [
    ("int4_g128", 2048, 4, 64), ("int8_g32", 2048, 4, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("scheme, seq_len, t, d", KV_CASES, ids=[f"{c[0]}-S{c[1]}-T{c[2]}-D{c[3]}" for c in KV_CASES])
def test_kv_quant_kernel_matches_plain(cuda_device, scheme, seq_len, t, d):
    from nerf_attention_tpu_torch.ops import kv_quant_cuda as kq

    gen = torch.Generator().manual_seed(seq_len + t + d)
    ck, cv = (torch.randn(8, seq_len, d, generator=gen).to(cuda_device) for _ in range(2))
    q = (torch.randn(8, t, d, generator=gen) * 0.4).to(cuda_device)
    pk, pv = kq.pack_kv_unit_stack(ck, scheme), kq.pack_kv_unit_stack(cv, scheme)
    for pos in (seq_len, seq_len - 37, 1):
        before = kq.launches["kv_cache_attention_quant"]
        o, m, l = kq.kv_cache_attention_quant(q, pk, pv, pos, scale=d ** -0.5, return_stats=True)
        want_o, want_m, want_l = kq.kv_cache_attention_quant_plain(q, pk, pv, pos, scale=d ** -0.5,
                                                                   return_stats=True)
        assert kq.launches["kv_cache_attention_quant"] == before + 1
        torch.testing.assert_close(o, want_o, **KV_TOL)
        torch.testing.assert_close(m + torch.log(l), want_m + torch.log(want_l), atol=LOGZ_ATOL, rtol=0)
        assert torch.equal(o, kq.kv_cache_attention_quant(q, pk, pv, pos, scale=d ** -0.5))


@pytest.mark.cuda
def test_kv_quant_kernel_is_bit_identical_twice(cuda_device):
    """Chunks merge in a fixed order; which block merges them does not change a bit."""
    from nerf_attention_tpu_torch.ops import kv_quant_cuda as kq

    gen = torch.Generator().manual_seed(5)
    ck, cv = (torch.randn(8, 32768, D, generator=gen).to(cuda_device) for _ in range(2))
    q = (torch.randn(8, 4, D, generator=gen) * 0.4).to(cuda_device)
    for scheme in SCHEMES:
        pk, pv = kq.pack_kv_unit_stack(ck, scheme), kq.pack_kv_unit_stack(cv, scheme)
        a, b = (kq.kv_cache_attention_quant(q, pk, pv, 32768 - 5, scale=D ** -0.5, return_stats=True)
                for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), scheme


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["int8_g32", "int4_g64"])
def test_kv_quant_kernel_past_the_cache_length(cuda_device, scheme):
    """A position past S is S: rows past S are the packing's padding (tile 64, S 200 of 256)."""
    from nerf_attention_tpu_torch.ops import kv_quant_cuda as kq

    gen = torch.Generator().manual_seed(6)
    ck, cv = (torch.randn(8, 200, D, generator=gen).to(cuda_device) for _ in range(2))
    q = (torch.randn(8, 4, D, generator=gen) * 0.4).to(cuda_device)
    pk, pv = kq.pack_kv_unit_stack(ck, scheme, tile=64), kq.pack_kv_unit_stack(cv, scheme, tile=64)
    at_s = kq.kv_cache_attention_quant(q, pk, pv, 200, scale=D ** -0.5, return_stats=True)
    for pos in (230, 256):
        past = kq.kv_cache_attention_quant(q, pk, pv, pos, scale=D ** -0.5, return_stats=True)
        assert all(torch.equal(x, y) for x, y in zip(past, at_s))


@pytest.mark.cuda
@pytest.mark.parametrize("scheme, d, t, seq_len", [("int6_g24", 36, 20, 500), ("int4_g6", 300, 3, 700)],
                         ids=["int6_g24-D36-T20", "int4_g6-D300-T3"])
def test_kv_quant_kernel_odd_tiles_groups_and_widths(cuda_device, scheme, d, t, seq_len):
    """Tile 96 (stages of 32 rows), groups that do not divide a warp's rows,
    widths off a multiple of 16 and past 256, and more than 16 queries: the
    kernel's general path, unswizzled rows and extra query and column blocks."""
    from nerf_attention_tpu_torch.ops import kv_quant_cuda as kq

    gen = torch.Generator().manual_seed(d + t)
    ck, cv = (torch.randn(2, seq_len, d, generator=gen).to(cuda_device) for _ in range(2))
    q = (torch.randn(2, t, d, generator=gen) * 0.4).to(cuda_device)
    pk, pv = kq.pack_kv_unit_stack(ck, scheme, tile=96), kq.pack_kv_unit_stack(cv, scheme, tile=96)
    for pos in (seq_len, 37):
        o, m, l = kq.kv_cache_attention_quant(q, pk, pv, pos, scale=d ** -0.5, return_stats=True)
        want_o, want_m, want_l = kq.kv_cache_attention_quant_plain(q, pk, pv, pos, scale=d ** -0.5, return_stats=True)
        torch.testing.assert_close(o, want_o, **KV_TOL)
        torch.testing.assert_close(m + torch.log(l), want_m + torch.log(want_l), atol=LOGZ_ATOL, rtol=0)


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


def _mla_case(h, s_buf, d, r, device, seed):
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn(h, d, generator=gen) * 0.1).to(device)
    return q, torch.randn(s_buf, d, generator=gen).to(device), torch.randn(1, d, generator=gen).to(device)


def _check_2g(q, cache, new, position, r, dtype):
    """2G against its plain version (the tolerances above), and twice bit-identical."""
    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda as ma

    args = dict(kv_lora_rank=r, scale=192 ** -0.5)
    before = ma.launches["mla_absorbed_attention"]
    o, ent = ma.mla_absorbed_attention(q, cache, new, position, **args)
    want_o, want_ent = ma.mla_absorbed_attention_plain(q, cache, new, position, **args)
    torch.cuda.synchronize()
    assert ma.launches["mla_absorbed_attention"] == before + 1
    bf16_tol = dict(rtol=0, atol=MLA_BF16_REL * want_o.abs().max().item())
    torch.testing.assert_close(o, want_o, **(MLA_TOL if dtype == torch.float32 else bf16_tol))
    torch.testing.assert_close(ent, want_ent, **MLA_TOL)
    o2, ent2 = ma.mla_absorbed_attention(q, cache, new, position, **args)
    assert torch.equal(o, o2) and torch.equal(ent, ent2)


# Heads in groups of 16: 4 pads M with zero rows, 128 (DeepSeek-V3) is eight groups. Rows at a tile's edge.
MLA_HEAD_CASES = [(h, dtype, edge) for h in (4, 128) for dtype in (torch.float32, torch.bfloat16) for edge in (-1, 0, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("heads, dtype, edge", MLA_HEAD_CASES,
                         ids=[f"H{h}-{str(t)[6:]}-tile{e:+d}" for h, t, e in MLA_HEAD_CASES])
def test_mla_absorbed_kernel_head_groups_and_tile_edges(cuda_device, heads, dtype, edge):
    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda as ma

    s_buf = ma.TILE_ROWS[dtype] + edge
    q, cache, new = _mla_case(heads, s_buf, MLA_R + MLA_ROPE, MLA_R, cuda_device, seed=heads + s_buf)
    for position in (s_buf, s_buf - 5):
        _check_2g(q, cache.to(dtype), new, position, MLA_R, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_mla_absorbed_kernel_at_32768(cuda_device, dtype):
    q, cache, new = _mla_case(MLA_H, 32768, MLA_R + MLA_ROPE, MLA_R, cuda_device, seed=7)
    _check_2g(q, cache.to(dtype), new, 32768 - 3, MLA_R, dtype)


# (heads, width, rank): widths off 16 (40; rank 36 is off 8), and rows too wide for the wide tile's ring
# (the narrow tiles) with a rank past one block's 512 output columns.
MLA_WIDTH_CASES = [(20, 40, 32), (4, 40, 36), (3, 1032, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("heads, d, r", MLA_WIDTH_CASES, ids=[f"H{h}-D{d}-r{r}" for h, d, r in MLA_WIDTH_CASES])
def test_mla_kernels_on_other_widths(cuda_device, heads, d, r):
    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda as ma
    from nerf_attention_tpu_torch.ops import mla_quant_cuda as mq

    q, latent, new = _mla_case(heads, 300, d, r, cuda_device, seed=d + r)
    for dtype in (torch.float32, torch.bfloat16):
        for position in (300, 201, 0):
            _check_2g(q, latent.to(dtype), new, position, r, dtype)
    packed = mq.pack_resident_latent(latent, "int6_g64", tile=128)
    dequant = mq.unpack_resident_latent(*packed)
    args = dict(kv_lora_rank=r, scale=192 ** -0.5)
    for position in (300, 37):
        o, ent = mq.mla_absorbed_attention_quant(q, packed, new, position, **args)
        o_2g, ent_2g = ma.mla_absorbed_attention(q, dequant, new, position, **args)
        assert torch.equal(o, o_2g) and torch.equal(ent, ent_2g)


# Packed tiles: the default 1024, and 192, which the 32-row SIMT kernel refused for int6 (a quarter of 48 rows).
MLA_PACK_CASES = [(scheme, tile) for scheme in ("int8_g32", "int6_g64", "int4_g64") for tile in (1024, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("scheme, tile", MLA_PACK_CASES, ids=[f"{s}-tile{t}" for s, t in MLA_PACK_CASES])
def test_mla_quant_kernel_two_tiles_and_a_ragged_third(cuda_device, scheme, tile):
    from nerf_attention_tpu_torch.ops import mla_absorbed_cuda as ma
    from nerf_attention_tpu_torch.ops import mla_quant_cuda as mq

    s_buf = 2 * tile + tile // 3
    q, latent, new = _mla_case(MLA_H, s_buf, MLA_R + MLA_ROPE, MLA_R, cuda_device, seed=tile)
    packed = mq.pack_resident_latent(latent, scheme, tile=tile)
    dequant = mq.unpack_resident_latent(*packed)
    args = dict(kv_lora_rank=MLA_R, scale=192 ** -0.5)
    for position in (s_buf, tile + 1, tile - 1):
        o, ent = mq.mla_absorbed_attention_quant(q, packed, new, position, **args)
        want_o, want_ent = mq.mla_absorbed_attention_quant_plain(q, packed, new, position, **args)
        torch.cuda.synchronize()
        torch.testing.assert_close(o, want_o, **MLA_TOL)
        torch.testing.assert_close(ent, want_ent, **MLA_TOL)
        o_2g, ent_2g = ma.mla_absorbed_attention(q, dequant, new, position, **args)
        assert torch.equal(o, o_2g) and torch.equal(ent, ent_2g)
        o2, ent2 = mq.mla_absorbed_attention_quant(q, packed, new, position, **args)
        assert torch.equal(o, o2) and torch.equal(ent, ent2)


# ---- the hybrid Llama engine (models/llama_hybrid.py): 2F and 2I inside a model ----

# A small dense Llama with Llama-3.1-8B's query group of 4; `small` nets; the card held to the same functions
# on the CPU at the tolerances of tests/test_llama_hybrid.py (h) and tests/test_kv_quant_pallas.py (new rows).
HYBRID_LLAMA = dict(vocab_size=64, hidden_size=256, intermediate_size=384, num_hidden_layers=3,
                    num_attention_heads=8, num_key_value_heads=2, head_dim=64)
HYBRID_S = 300
H_TOL = dict(atol=2e-4, rtol=1e-4)
ROW_TOL = dict(atol=1e-5, rtol=0)


def _hybrid_case(seed=0):
    """(config, cpu params, keys, values (L, n_kv, S, d) numpy, units, served): random, from a seed."""
    from nerf_attention_tpu_torch.models import llama

    config = llama.LlamaConfig(**HYBRID_LLAMA)
    n_l, n_kv, d = config.num_hidden_layers, config.num_key_value_heads, config.head_dim
    rng = np.random.default_rng(seed)
    keys, values = (rng.standard_normal((n_l, n_kv, HYBRID_S, d)).astype(np.float32) for _ in range(2))
    gen = torch.Generator().manual_seed(seed)
    nets = [init_siren(CONFIGS_BY_NAME["small"], d, generator=gen, n=n_l * n_kv) for _ in "kv"]
    stats = [rng.standard_normal((n_l * n_kv, 1, d)).astype(np.float32) * 0.1 if i % 2 == 0
             else rng.uniform(0.5, 1.5, (n_l * n_kv, 1, d)).astype(np.float32) for i in range(4)]
    served = np.array([[True, False], [False, False], [True, True]])
    return config, llama.init_random_llama(config, seed=seed, device="cpu"), keys, values, (*nets, *stats), served


def _to(params, device):
    return {"embed": params["embed"].to(device), "layers": [{k: v.to(device) for k, v in lp.items()}
                                                            for lp in params["layers"]]}


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["fp32", "int4_g128"])
def test_hybrid_step_and_rollout_on_the_gpu(cuda_device, scheme):
    from nerf_attention_tpu_torch.models import llama_hybrid
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    config, params, keys, values, units, served = _hybrid_case()
    uns = [[torch.from_numpy(c[l][~served[l]]) for l in range(len(served))] for c in (keys, values)]
    got, want = {}, {}
    for device, out in ((cuda_device, got), (torch.device("cpu"), want)):
        p = _to(params, device)
        ck, cv = ([c.to(device) for c in half] for half in uns)
        step, out["info"] = llama_hybrid.make_hybrid_decode_step(config, p, served, *units, 30.0, scheme=scheme,
                                                                 device=device)
        before = sq.launches["siren_attention_decode_quant"]
        out["h"] = step(5, ck, cv).cpu()
        out["launches"] = sq.launches["siren_attention_decode_quant"] - before
        out["twice"] = torch.equal(step(5, ck, cv).cpu(), out["h"])
        rollout, _ = llama_hybrid.make_hybrid_rollout(config, p, served, *units, 30.0, seq_len=HYBRID_S,
                                                      rollout_tokens=3, scheme=scheme, device=device)
        hs, (tail_k, _) = rollout([3, 9, 27], ck, cv)
        out["hs"], out["tail_k"] = hs.cpu(), [t.cpu() for t in tail_k]
    assert got["launches"] == 2 and want["launches"] == 0  # one 2F a layer that serves heads, none on the CPU
    packed = tuple(sq.pack_resident_params(nets, scheme, device=cuda_device) for nets in units[:2])
    assert sq.resident_records(packed, torch.device("cuda"))[:2] == sq.resident_records(packed, packed[0][0][0].device)[:2]
    assert got["twice"] and got["info"] == want["info"]
    torch.testing.assert_close(got["h"], want["h"], **H_TOL)
    torch.testing.assert_close(got["hs"], want["hs"], **H_TOL)
    for g, w in zip(got["tail_k"], want["tail_k"]):
        torch.testing.assert_close(g, w, **ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantcache_step_on_the_gpu(cuda_device, scheme):
    from nerf_attention_tpu_torch.models import llama_hybrid
    from nerf_attention_tpu_torch.ops import kv_quant_cuda as kq

    config, params, keys, values, _, _ = _hybrid_case(seed=1)
    packed = {d: llama_hybrid.pack_llama_kv_cache(keys, values, scheme, tile=128, device=d)
              for d in (cuda_device, torch.device("cpu"))}
    gpu_params = _to(params, cuda_device)
    for position in (HYBRID_S, 1, 0):
        before = kq.launches["kv_cache_attention_quant"]
        h, (k_new, v_new) = llama_hybrid.llama_decode_step_quantcache(config, gpu_params, 7, position,
                                                                      *packed[cuda_device])
        assert kq.launches["kv_cache_attention_quant"] == before + config.num_hidden_layers
        want_h, (want_k, want_v) = llama_hybrid.llama_decode_step_quantcache(config, params, 7, position,
                                                                             *packed[torch.device("cpu")])
        assert torch.isfinite(h).all()
        torch.testing.assert_close(h.cpu(), want_h, **H_TOL)
        torch.testing.assert_close(k_new.cpu(), want_k, **ROW_TOL)
        torch.testing.assert_close(v_new.cpu(), want_v, **ROW_TOL)


# Kernel 2B/2C's bf16 mode: 4 bf16 ulps of the largest |output| (tests/test_torch_siren_decode_bf16.py).
BF16_ULPS = 4


@pytest.mark.cuda
@pytest.mark.parametrize("config_name, n, seq_len, sin_impl, fm, total_len", [
    ("medium", 1, 2048, "exact", None, None), ("medium", 40, 2048, "fast", None, None),
    ("medium", 40, 300, "exact", 64.0, None), ("medium", 512, 2048, "exact", None, None),
    ("tiny", 8, 777, "fast", None, None), ("large", 8, 2048, "exact", None, None),
    ("tiny", 512, 2048, "fast", None, None), ("small", 40, 2048, "exact", None, None),
    ("small", 1, 777, "fast", 64.0, None), ("deep", 40, 2048, "fast", None, None),
    ("deep", 512, 2048, "exact", None, None), ("hifreq", 40, 777, "exact", None, None),
    ("lofreq", 1, 2048, "fast", None, None), ("medium", 1, 32768, "exact", None, None),
    ("medium", 4, 32768, "fast", 64.0, 40000), ("medium", 40, 2304, "exact", None, 4096),
], ids=["2B", "N40-fast", "N40-fm", "N512", "tiny-ragged", "large", "tiny-N512", "small-N40", "small-2B-fm",
        "deep-N40-fast", "deep-N512", "hifreq-ragged", "lofreq-2B", "2B-S32768", "S32768-fm-total_len",
        "N40-total_len"])
def test_decode_bf16_kernel_matches_plain(cuda_device, config_name, n, seq_len, sin_impl, fm, total_len):
    """Within BF16_ULPS of the plain version, bit for bit the same on a second run, through the kernel the width
    rule gives (csrc/siren_decode_bf16.cu for nets up to 256 wide, the layer stack for `large`)."""
    config = CONFIGS_BY_NAME[config_name]
    stack = _stack(config_name, n, cuda_device, seed=n)
    kw = dict(sin_impl=sin_impl, fm_mult=fm, compute_dtype=torch.bfloat16)
    batch_kw = dict(kw, total_len=total_len)
    run = (lambda: siren_cuda.siren_decode(stack, config.omega_0, seq_len, **kw)[None]) if n == 1 else (
        lambda: siren_cuda.siren_decode_batch(stack, config.omega_0, seq_len, **batch_kw))
    route = siren_cuda.bf16_route(config.hidden_features, D)
    assert route == ("stack" if config_name == "large" else "wgmma")
    before = dict(siren_cuda.wgmma_launches)
    got = run()
    want = siren_cuda.siren_decode_plain(stack, config.omega_0, seq_len, **batch_kw)
    torch.cuda.synchronize()
    wrapper = "siren_decode" if n == 1 else "siren_decode_batch"
    assert siren_cuda.wgmma_launches[wrapper] == before[wrapper] + (route == "wgmma")
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == (n, seq_len, D)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_ULPS * 2.0**-8 * want.float().abs().max().item(), err
    assert torch.equal(got, run())


@pytest.mark.cuda
def test_decode_bf16_kernel_wide_tile(cuda_device):
    config = SIRENConfig(2048, 1, 30.0, "wide")
    params = init_siren(config, D, generator=torch.Generator().manual_seed(3), n=8)
    cpu = SirenStack.from_params(params)
    stack = SirenStack(cpu.flat.to(cuda_device), cpu.dims)
    assert siren_cuda.bf16_route(2048, D) == "stack"
    before = dict(siren_cuda.wgmma_launches)
    got = siren_cuda.siren_decode_batch(stack, 30.0, 300, compute_dtype=torch.bfloat16)
    want = siren_cuda.siren_decode_plain(stack, 30.0, 300, compute_dtype=torch.bfloat16)
    assert siren_cuda.wgmma_launches == before  # the layer stack's wide tile
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_ULPS * 2.0**-8 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, layers, d_out, n, seq_len, sin_impl, route", [
    (96, 2, 20, 40, 777, "exact", "wgmma"), (100, 1, 4, 1, 300, "fast", "wgmma"),
    (192, 2, 252, 8, 2048, "exact", "wgmma"), (96, 2, 18, 8, 300, "exact", "stack"), (72, 1, 3, 8, 300, "fast", "stack"),
], ids=["padded-D20", "hidden100-D4-2B", "D252", "D18-stack", "D3-stack"])
def test_decode_bf16_kernel_odd_widths(cuda_device, hidden, layers, d_out, n, seq_len, sin_impl, route):
    """Hidden widths that are not a multiple of 64 (zero rows and columns past them in every piece) and output widths
    that are not a multiple of 64: within BF16_ULPS of the plain version, bit for bit on a second run, through the
    kernel the width rule gives (the layer stack for widths that are not multiples of 4)."""
    gen = torch.Generator().manual_seed(hidden)
    params = init_siren(SIRENConfig(hidden, layers, 30.0, "odd"), d_out, generator=gen, n=n)
    cpu = SirenStack.from_params(params)
    stack = SirenStack(cpu.flat.to(cuda_device), cpu.dims)
    assert siren_cuda.bf16_route(hidden, d_out) == route
    kw = dict(sin_impl=sin_impl, compute_dtype=torch.bfloat16)
    run = (lambda: siren_cuda.siren_decode(stack, 30.0, seq_len, **kw)[None]) if n == 1 else (
        lambda: siren_cuda.siren_decode_batch(stack, 30.0, seq_len, **kw))
    wrapper = "siren_decode" if n == 1 else "siren_decode_batch"
    before = dict(siren_cuda.wgmma_launches)
    got = run()
    torch.cuda.synchronize()
    assert siren_cuda.wgmma_launches[wrapper] == before[wrapper] + (route == "wgmma")
    want = siren_cuda.siren_decode_plain(stack, 30.0, seq_len, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (n, seq_len, d_out)
    _bf16_close(got, want)
    assert torch.equal(got, run())


def _bf16_close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_ULPS * 2.0**-8 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("seq_len, t, sin_impl, fm, causal", [
    (2048, 1, "fast", None, False), (300, 16, "exact", None, True), (2048, 16, "fast", 64.0, True),
    (32768, 1, "fast", None, True),
], ids=["S2048", "T16_exact_ragged", "T16_fm", "S32768"])
def test_attention_bf16_kernels_match_plain(cuda_device, seq_len, t, sin_impl, fm, causal):
    """2D and 2F in bf16 against their plain versions, and unlike their fp32 modes; 2F on packed weights
    equals 2F on the host-dequantized weights shipped dense (scheme fp32), bit for bit."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    k_stack, v_stack, *rest = _attention_args(4, t, cuda_device, seed=seq_len + t)
    kw = dict(sin_impl=sin_impl, fm_mult=fm, causal=causal, compute_dtype=torch.bfloat16)
    before = (sa.bf16_launches["siren_attention_decode_fused"], sq.bf16_launches["siren_attention_decode_quant"])
    got = sa.siren_attention_decode_fused(k_stack, v_stack, *rest, 30.0, seq_len, **kw)
    _bf16_close(got, sa.siren_attention_decode_plain(k_stack, v_stack, *rest, 30.0, seq_len, **kw))
    assert got.dtype == torch.float32
    assert torch.equal(got, sa.siren_attention_decode_fused(k_stack, v_stack, *rest, 30.0, seq_len, **kw))
    fp32 = {**kw, "compute_dtype": torch.float32}
    assert not torch.equal(got, sa.siren_attention_decode_fused(k_stack, v_stack, *rest, 30.0, seq_len, **fp32))
    packed = tuple(sq.pack_resident_params(s.params(), "int4_g128") for s in (k_stack, v_stack))
    o, m, l = sq.siren_attention_decode_quant(None, None, *rest, "int4_g128", 30.0, seq_len, packed=packed,
                                              return_stats=True, **kw)
    want_o, want_m, want_l = sq.siren_attention_decode_quant_plain(packed, *rest, 30.0, seq_len, return_stats=True,
                                                                   **kw)
    torch.cuda.synchronize()
    _bf16_close(o, want_o)
    torch.testing.assert_close(m + torch.log(l), want_m + torch.log(want_l), atol=LOGZ_ATOL, rtol=0)
    dense = tuple(sq.pack_resident_params(sq.unpack_resident_params(*p), "fp32") for p in packed)
    assert torch.equal(o, sq.siren_attention_decode_quant(None, None, *rest, "fp32", 30.0, seq_len, packed=dense,
                                                          return_stats=True, **kw)[0])
    assert not torch.equal(o, sq.siren_attention_decode_quant(None, None, *rest, "int4_g128", 30.0, seq_len,
                                                              packed=packed, **fp32))
    assert (sa.bf16_launches["siren_attention_decode_fused"], sq.bf16_launches["siren_attention_decode_quant"]) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("config_name, scheme, n, seq_len, sin_impl", [
    ("small", "int4_g128", 128, 512, "fast"), ("medium", "int8_g32", 40, 2048, "exact"),
    ("tiny", "int6_g64", 8, 777, "fast"), ("large", "int4_g32_l0fp32", 4, 300, "exact"),
], ids=["small-int4", "medium-int8", "tiny-int6-ragged", "large-l0fp32"])
def test_decode_quant_bf16_kernel_matches_plain(cuda_device, config_name, scheme, n, seq_len, sin_impl):
    """2E in bf16 against its plain version, unlike its fp32 mode, and bit for bit against itself over
    the host-dequantized weights shipped dense."""
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    stack = _stack(config_name, n, cuda_device, seed=n)
    packed = sq.pack_resident_params(stack.params(), scheme)
    kw = dict(sin_impl=sin_impl, compute_dtype=torch.bfloat16)
    got = sq.siren_decode_batch_quant(None, scheme, 30.0, seq_len, packed=packed, **kw)
    want = sq.siren_decode_batch_quant_plain(packed, 30.0, seq_len, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == (n, seq_len, D)
    _bf16_close(got, want)
    dense = sq.pack_resident_params(sq.unpack_resident_params(*packed), "fp32")
    assert torch.equal(got, sq.siren_decode_batch_quant(None, "fp32", 30.0, seq_len, packed=dense, **kw))
    fp32 = sq.siren_decode_batch_quant(None, scheme, 30.0, seq_len, packed=packed, sin_impl=sin_impl)
    assert not torch.equal(got, fp32.to(torch.bfloat16))  # the bf16 mode rounds the activations


@pytest.mark.cuda
def test_stats_on_the_card_match_the_cpu(cuda_device):
    from nerf_attention_tpu_torch.ops import stats

    signals = torch.randn(128, 2048, generator=torch.Generator().manual_seed(4))
    signals[0] = 3.0
    for fn in (lambda s: stats.batched_autocorrelation(s, 50), stats.batched_spectral_energy):
        torch.testing.assert_close(fn(signals.to(cuda_device)).cpu(), fn(signals), atol=1e-5, rtol=0)
    mats = torch.randn(8, 2048, D, generator=torch.Generator().manual_seed(5))
    for got, want in zip(stats.effective_ranks(mats.to(cuda_device)), stats.effective_ranks(mats)):
        assert got["full_rank"] == want["full_rank"]
        assert abs(got["effective_rank_99"] - want["effective_rank_99"]) <= 1  # a count at the 0.99 cut
        assert abs(got["top_sv_fraction"] - want["top_sv_fraction"]) <= 1e-5


@pytest.mark.cuda
def test_svd_on_the_card_matches_the_cpu(cuda_device):
    from nerf_attention_tpu_torch.ops import svd

    # Distinct singular values (10 down to 1e-3), so each truncation is one projection.
    gen = torch.Generator().manual_seed(6)
    u, _ = torch.linalg.qr(torch.randn(2048, D, generator=gen))
    v, _ = torch.linalg.qr(torch.randn(D, D, generator=gen))
    m = (u * torch.logspace(1, -3, D)) @ v.T
    for rank in (3, 15, 30):
        torch.testing.assert_close(svd.truncated_reconstruct(m.to(cuda_device), rank).cpu(),
                                   svd.truncated_reconstruct(m, rank), atol=1e-4, rtol=0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    _, s, _ = svd.randomized_svd(m.to(cuda_device), 15, generator=gen)
    torch.testing.assert_close(s.cpu(), torch.linalg.svdvals(m)[:15], rtol=1e-2, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_attention_metrics_on_the_card_match_the_cpu(cuda_device, seed):
    """experiments/attention_error.py's metrics on the card against the CPU, at the study's S and a few heads:
    fp32 sums in another order (tests/test_torch_attention_error.py's 1e-5)."""
    from nerf_attention_tpu_torch.experiments import attention_error as ae
    from nerf_attention_tpu_torch.utils.device import pin_fp32_matmul

    pin_fp32_matmul()
    gen = torch.Generator().manual_seed(seed)
    k, v = torch.randn(2, 2, 2048, D, generator=gen)
    k_hat, v_hat = k + 0.05 * torch.randn(k.shape, generator=gen), v + 0.05 * torch.randn(v.shape, generator=gen)
    q_matched = k[:, -64:] + 0.25 * torch.randn(2, 64, D, generator=gen)
    q_diffuse = torch.randn(2, 64, D, generator=gen)
    allowed = torch.from_numpy(ae.causal_allowed(2048, 64))
    inputs = (k, v, k_hat, v_hat, q_matched, q_diffuse, allowed)
    gains = (1.0, 8.0, 64.0)
    got = ae._host_tree(ae._layer_metrics(*(x.to(cuda_device) for x in inputs), gains))
    want = ae._host_tree(ae._layer_metrics(*inputs, gains))
    for regime, block in want.items():
        np.testing.assert_allclose(got[regime]["exact_entropy_nats"], block["exact_entropy_nats"], atol=1e-5)
        for name in ae.VARIANTS:
            for metric in ae.METRICS:
                np.testing.assert_allclose(got[regime][name][metric], block[name][metric], atol=1e-5,
                                           err_msg=f"{regime} {name} {metric}")


@pytest.mark.cuda
def test_head_policy_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The tiny head-policy study (tests/test_head_policy.py's geometry) on the card against the CPU, from the same
    initial params: entropies to 1e-5, the fit-derived numbers to 1e-4 (chip_smoke.py phase 19's limits)."""
    from nerf_attention_tpu_torch.experiments.head_policy import run_head_policy_experiment

    kw = dict(seq_len=48, n_queries=4, epochs=10, config_name="tiny", num_layers=2, num_heads=4, num_kv_heads=2,
              head_dim=16, hidden_size=64, intermediate_size=128, schemes=("fp16",), budget_points=2, n_random=1,
              seed=0, verbose=False)
    got = run_head_policy_experiment(tmp_path / "card", device=cuda_device, **kw)
    want = run_head_policy_experiment(tmp_path / "cpu", device="cpu", **kw)
    for g, w in zip(got["units"], want["units"]):
        assert abs(g["entropy_nats"] - w["entropy_nats"]) <= 1e-5
        for key in ("key_fit_cosine", "value_fit_cosine", "solo_output_cosine", "solo_cost"):
            assert abs(g[key] - w[key]) <= 1e-4, key
    for scheme, w in want["payloads"].items():
        for name, curve in w["policies"].items():
            np.testing.assert_allclose(got["payloads"][scheme]["policies"][name]["output_cosine"],
                                       curve["output_cosine"], atol=1e-4)


# Kernels 2E's and 2F's bf16 modes on Hopper (csrc/siren_decode_act16.cu, csrc/siren_attention_wgmma.cu): three
# bf16 pieces a weight on wgmma, held to the plain versions at BF16_ULPS, and bit for bit to themselves over the
# host-dequantized weights shipped dense and on a second run.
@pytest.mark.cuda
@pytest.mark.parametrize("config_name, scheme, n, seq_len, sin_impl, fm", [
    ("small", "int4_g128", 128, 512, "fast", None), ("medium", "int8_g32", 40, 2048, "exact", None),
    ("tiny", "int6_g64", 8, 777, "fast", None), ("deep", "int8_g32_l0fp32", 4, 1000, "exact", None),
    ("medium", "fp32", 3, 300, "exact", 64.0), ("medium", "int4_g32", 1, 32768, "fast", None),
], ids=["plan-shape", "medium-int8", "tiny-int6-ragged", "deep-l0fp32", "dense-fm", "S32768"])
def test_act16_decode_kernel_matches_plain(cuda_device, config_name, scheme, n, seq_len, sin_impl, fm):
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    config = CONFIGS_BY_NAME[config_name]
    packed = sq.pack_resident_params(_stack(config_name, n, cuda_device, seed=n + seq_len).params(), scheme)
    kw = dict(sin_impl=sin_impl, fm_mult=fm, compute_dtype=torch.bfloat16)
    assert siren_cuda.bf16_route(config.hidden_features, D) == "wgmma"
    before = dict(sq.wgmma_launches)
    got = sq.siren_decode_batch_quant(None, scheme, config.omega_0, seq_len, packed=packed, **kw)
    torch.cuda.synchronize()
    assert sq.wgmma_launches["siren_decode_batch_quant"] == before["siren_decode_batch_quant"] + 1
    want = sq.siren_decode_batch_quant_plain(packed, config.omega_0, seq_len, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (n, seq_len, D)
    _bf16_close(got, want)
    dense = sq.pack_resident_params(sq.unpack_resident_params(*packed), "fp32")
    assert torch.equal(got, sq.siren_decode_batch_quant(None, "fp32", config.omega_0, seq_len, packed=dense, **kw))
    assert torch.equal(got, sq.siren_decode_batch_quant(None, scheme, config.omega_0, seq_len, packed=packed, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, layers, d_out, route", [
    (96, 2, 20, "wgmma"), (100, 1, 4, "wgmma"), (96, 2, 18, "stack"), (72, 1, 3, "stack"), (512, 2, 128, "stack"),
], ids=["padded-D20", "hidden100-D4", "D18-stack", "D3-stack", "large-stack"])
def test_act16_decode_kernel_widths_by_rule(cuda_device, hidden, layers, d_out, route):
    """Nets the width rule sends elsewhere keep the layer stack's kAct16 instance (no wgmma launch counted); both
    routes hold to the plain version and to themselves over the dense dequantized weights."""
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    gen = torch.Generator().manual_seed(hidden)
    params = init_siren(SIRENConfig(hidden, layers, 30.0, "odd"), d_out, generator=gen, n=6)
    packed = sq.pack_resident_params([(w.to(cuda_device), b.to(cuda_device)) for w, b in params], "int4_g128")
    assert siren_cuda.bf16_route(hidden, d_out) == route
    kw = dict(sin_impl="fast", compute_dtype=torch.bfloat16)
    before = dict(sq.wgmma_launches)
    got = sq.siren_decode_batch_quant(None, "int4_g128", 30.0, 300, packed=packed, **kw)
    torch.cuda.synchronize()
    assert sq.wgmma_launches["siren_decode_batch_quant"] == before["siren_decode_batch_quant"] + (route == "wgmma")
    _bf16_close(got, sq.siren_decode_batch_quant_plain(packed, 30.0, 300, **kw))
    dense = sq.pack_resident_params(sq.unpack_resident_params(*packed), "fp32")
    assert torch.equal(got, sq.siren_decode_batch_quant(None, "fp32", 30.0, 300, packed=dense, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n, t, seq_len, causal, scheme, sin_impl, fm", [
    (8, 1, 2048, False, "int4_g128", "fast", None), (8, 16, 300, True, "int8_g32", "fast", None),
    (4, 16, 2048, True, "int4_g128", "fast", 64.0), (4, 1, 32768, True, "int4_g128", "fast", None),
    (2, 4, 200, True, "int6_g64", "exact", None), (3, 3, 129, False, "fp32", "fast", None),
    (2, 1, 1, True, "int4_g128", "fast", None),
], ids=["ladder", "T16-ragged-causal", "T16-fm", "S32768-causal", "exact-int6", "dense-ragged", "S1"])
def test_act16_attention_kernel_matches_plain(cuda_device, n, t, seq_len, causal, scheme, sin_impl, fm):
    """2F in bf16 on csrc/siren_attention_wgmma.cu: the output within BF16_ULPS of the plain version, (m, l) to its
    log-partition, bit for bit to itself over the dense dequantized weights and on a second run."""
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    k_stack, v_stack, *rest = _attention_args(n, t, cuda_device, seed=seq_len + t)
    packed = tuple(sq.pack_resident_params(s.params(), scheme) for s in (k_stack, v_stack))
    kw = dict(sin_impl=sin_impl, fm_mult=fm, causal=causal, compute_dtype=torch.bfloat16)
    assert sq.attention_route(CONFIGS_BY_NAME["medium"].hidden_features, D, t) == "wgmma"
    before = dict(sq.wgmma_launches)
    o, m, l = sq.siren_attention_decode_quant(None, None, *rest, scheme, 30.0, seq_len, packed=packed,
                                              return_stats=True, **kw)
    torch.cuda.synchronize()
    assert sq.wgmma_launches["siren_attention_decode_quant"] == before["siren_attention_decode_quant"] + 1
    want_o, want_m, want_l = sq.siren_attention_decode_quant_plain(packed, *rest, 30.0, seq_len, return_stats=True,
                                                                   **kw)
    _bf16_close(o, want_o)
    torch.testing.assert_close(m + torch.log(l), want_m + torch.log(want_l), atol=LOGZ_ATOL, rtol=0)
    dense = tuple(sq.pack_resident_params(sq.unpack_resident_params(*p), "fp32") for p in packed)
    twin = sq.siren_attention_decode_quant(None, None, *rest, "fp32", 30.0, seq_len, packed=dense, return_stats=True,
                                           **kw)
    assert all(torch.equal(a, b) for a, b in zip((o, m, l), twin))
    assert torch.equal(o, sq.siren_attention_decode_quant(None, None, *rest, scheme, 30.0, seq_len, packed=packed,
                                                          **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, d, t, route", [
    (256, 128, 17, "stack"), (512, 128, 1, "stack"), (96, 20, 4, "wgmma"), (96, 18, 2, "stack"), (64, 256, 1, "stack"),
], ids=["T17-stack", "large-stack", "hidden96-D20", "D18-stack", "D256-stack"])
def test_act16_attention_kernel_route_by_rule(cuda_device, hidden, d, t, route):
    """Calls attention_route sends elsewhere keep the layer stack's kAct16 instance (no wgmma launch counted);
    both routes hold to the plain version."""
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
    from nerf_attention_tpu_torch.tools.measure_attention_decode import attention_inputs

    k, v, stats, q = attention_inputs(SIRENConfig(hidden, 2, 30.0, "odd"), 2, t, d, torch.Generator().manual_seed(t),
                                      cuda_device)
    packed = tuple(sq.pack_resident_params(s.params(), "int8_g32") for s in (k, v))
    assert sq.attention_route(hidden, d, t) == route
    kw = dict(sin_impl="fast", causal=True, compute_dtype=torch.bfloat16)
    before = dict(sq.wgmma_launches)
    got = sq.siren_attention_decode_quant(None, None, *stats, q, "int8_g32", 30.0, 300, packed=packed, **kw)
    torch.cuda.synchronize()
    assert sq.wgmma_launches["siren_attention_decode_quant"] == before["siren_attention_decode_quant"] + (
        route == "wgmma")
    _bf16_close(got, sq.siren_attention_decode_quant_plain(packed, *stats, q, 30.0, 300, **kw))


def act16_pieces(weights, hidden: int, splits: int = 3) -> np.ndarray:
    """The pieces buffer of one net as csrc/siren_wgmma.cuh's split pass writes it, as uint16 bf16 bits, from the
    fp32 weights of layers 1..L-1 ((rows, cols) each, on the CPU). For each layer, 64-column chunk c, split (w3, w2,
    w1: w1 = bf16(w), w2 = bf16(w - w1), w3 = bf16(w - w1 - w2); with ``splits`` 1, w1 alone: 2D's rounded weights)
    and 64-row k atom: a 64 x 64 region, zero past the layer's rows and columns, element (row, col) at row * 64 + 8
    ((col / 8) ^ (row % 8)) + col % 8."""
    ka_n = -(-hidden // 64)
    row, col = np.arange(64)[:, None], np.arange(64)[None, :]
    dest = (row * 64 + ((col // 8) ^ (row % 8)) * 8 + col % 8).ravel()
    out = []
    for w in weights:
        w = w.float()
        rows, cols = w.shape
        padded = torch.zeros(ka_n * 64, -(-cols // 64) * 64)
        padded[:rows, :cols] = w
        w1 = padded.to(torch.bfloat16)
        r1 = padded - w1.float()
        w2 = r1.to(torch.bfloat16)
        pieces = [(r1 - w2.float()).to(torch.bfloat16), w2, w1][3 - splits:]
        for c in range(padded.shape[1] // 64):
            for piece in pieces:
                for ka in range(ka_n):
                    bits = piece[ka * 64:(ka + 1) * 64, c * 64:(c + 1) * 64].contiguous().view(torch.int16)
                    stage = np.empty(64 * 64, np.uint16)
                    stage[dest] = bits.numpy().astype(np.uint16).ravel()
                    out.append(stage)
    return np.concatenate(out)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, config_name, scheme", [
    ("2E", "small", "int4_g128"), ("2E", "medium", "fp32"), ("2E", "tiny", "int6_g64"),
    ("2E", "deep", "int8_g32_l0fp32"), ("2F", "medium", "int4_g128"), ("2F", "small", "fp32"),
    ("2F", "medium", "int6_g64"),
], ids=["2E-small-int4", "2E-medium-dense", "2E-tiny-int6", "2E-deep-int8", "2F-medium-int4", "2F-small-dense",
        "2F-medium-int6"])
def test_act16_split_pass_writes_every_piece_bit_for_bit(cuda_device, monkeypatch, kernel, config_name, scheme):
    """The pieces a launch's split pass leaves in device memory equal ``act16_pieces`` of the host-dequantized
    weights, every bit of every piece of every net (2F: the key nets, then the value nets): so the kernels keep w1,
    w2 and w3, all 24 bits of w, which a check of the outputs at BF16_ULPS could not tell from two pieces."""
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq
    from nerf_attention_tpu_torch.tools.measure_attention_decode import attention_inputs

    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa

    config = CONFIGS_BY_NAME[config_name]
    buffers = []
    module = sq if kernel == "2E" else sa  # each launcher's pieces area
    make = module._pieces
    monkeypatch.setattr(module, "_pieces", lambda *a: buffers.append(make(*a)) or buffers[-1])
    kw = dict(sin_impl="fast", compute_dtype=torch.bfloat16)
    if kernel == "2E":
        stacks = [_stack(config_name, 5, cuda_device, seed=7)]
        packed = [sq.pack_resident_params(stacks[0].params(), scheme)]
        sq.siren_decode_batch_quant(None, scheme, config.omega_0, 300, packed=packed[0], **kw)
    else:
        k, v, stats, q = attention_inputs(config, 3, 2, D, torch.Generator().manual_seed(7), cuda_device)
        packed = [sq.pack_resident_params(s.params(), scheme) for s in (k, v)]
        sq.siren_attention_decode_quant(None, None, *stats, q, scheme, config.omega_0, 300, packed=tuple(packed),
                                        causal=True, **kw)
    torch.cuda.synchronize()
    assert len(buffers) == 1
    got = buffers[0].cpu().numpy().view(np.uint16)
    want = []
    for params in (sq.unpack_resident_params(*p) for p in packed):
        want += [act16_pieces([w[n].cpu() for w, _ in params[1:]], config.hidden_features)
                 for n in range(params[0][0].shape[0])]
    want = np.concatenate(want)
    assert got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).sum())} of {got.size} bf16 values differ"


# Kernel 2D's bf16 mode on Hopper (csrc/siren_attention_wgmma.cu with one rounded bf16 piece a weight, one wgmma
# chain a product), within attention_route; the layer stack's kBF16 instance past it.
def _rounded_case(hidden, layers, d, n, t, device, seed):
    from nerf_attention_tpu_torch.tools.measure_attention_decode import attention_inputs

    k, v, stats, q = attention_inputs(SIRENConfig(hidden, layers, 30.0, "case"), n, t, d,
                                      torch.Generator().manual_seed(seed), device)
    return k, v, *stats, q


WGMMA_2D_CASES = [  # (n, t, seq_len, causal, hidden, hidden layers, d, sin_impl, fm)
    (8, 1, 2048, False, 256, 2, 128, "fast", None), (4, 4, 300, True, 256, 2, 128, "exact", None),
    (4, 16, 2048, True, 256, 2, 128, "fast", 64.0), (2, 16, 129, False, 96, 2, 64, "exact", None),
    (3, 4, 500, True, 64, 1, 64, "fast", 64.0), (2, 1, 32768, True, 256, 2, 128, "fast", None),
    (2, 1, 1, True, 256, 2, 128, "fast", None), (2, 4, 700, False, 64, 3, 128, "exact", 64.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n, t, seq_len, causal, hidden, layers, d, sin_impl, fm", WGMMA_2D_CASES,
                         ids=["ladder", "T4-exact-ragged", "T16-fm", "hidden96-D64-exact", "hidden64-D64-fm",
                              "S32768", "S1", "hidden64-deep-fm-exact"])
def test_attention_bf16_wgmma_kernel_matches_plain(cuda_device, n, t, seq_len, causal, hidden, layers, d, sin_impl,
                                                   fm):
    """2D in bf16 on csrc/siren_attention_wgmma.cu: one launch counted in ``wgmma_launches``, the output within
    BF16_ULPS of the plain version, unlike the fp32 mode's, and bit for bit equal on a second run."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa

    args = _rounded_case(hidden, layers, d, n, t, cuda_device, seed=seq_len + t + hidden)
    kw = dict(sin_impl=sin_impl, fm_mult=fm, causal=causal, compute_dtype=torch.bfloat16)
    assert sa.attention_route(hidden, d, t) == "wgmma"
    before = sa.wgmma_launches["siren_attention_decode_fused"]
    got = sa.siren_attention_decode_fused(*args, 30.0, seq_len, **kw)
    torch.cuda.synchronize()
    assert sa.wgmma_launches["siren_attention_decode_fused"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, t, d)
    _bf16_close(got, sa.siren_attention_decode_plain(*args, 30.0, seq_len, **kw))
    assert torch.equal(got, sa.siren_attention_decode_fused(*args, 30.0, seq_len, **kw))
    fp32 = {**kw, "compute_dtype": torch.float32}
    assert not torch.equal(got, sa.siren_attention_decode_fused(*args, 30.0, seq_len, **fp32))


# The kernel's bias tables and layer 0 row hold bf16-rounded values, which no output check at BF16_ULPS tells from
# fp32 ones: the plain version with either table left fp32 sits at least TABLE_GAIN times farther (relative RMS)
# from the bf16 plain version than the kernel does, on each net's side (``table_gaps``).
TABLE_GAIN = 10.0


def unrounded_table_plain(k, v, k_mean, k_std, v_mean, v_std, q, omega, seq_len, table: str, **kw):
    """2D's bf16 plain version with one of the kernel's tables left fp32: ``table`` "bias" (every layer's bias) or
    "layer0" (layer 0's weight row); the hidden and final weights and the activations still rounded."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa

    def params(stack):
        return [(w if i == 0 and table == "layer0" else w.to(torch.bfloat16).float(),
                 b if table == "bias" else b.to(torch.bfloat16).float()) for i, (w, b) in enumerate(stack.params())]

    return sa.siren_attention_decode_plain(params(k), params(v), k_mean, k_std, v_mean, v_std, q, omega, seq_len,
                                           round_weights=False, **kw)


def _rel_rms(got, want) -> float:
    want = want.float()
    return ((got.float() - want).square().mean().sqrt() / want.square().mean().sqrt()).item()


def table_gaps(got_m, got_zero, k, v, k_mean, k_std, v_mean, v_std, q, omega, seq_len, **kw) -> dict[str, float]:
    """For each table the kernel rounds ("bias", "layer0"): how many times farther from 2D's bf16 plain version
    (relative RMS) the plain version with that table left fp32 sits than the kernel does, the lesser of the two
    nets' sides. The key net's side is the softmax max m (``got_m``, the kernel's at q), which p's rounding does
    not reach; the value net's is the output at q = 0 (``got_zero``), where every score is 0 and p = 1 exactly."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa

    stats, zero = (k_mean, k_std, v_mean, v_std), torch.zeros_like(q)
    want_m = sa.siren_attention_decode_plain(k, v, *stats, q, omega, seq_len, return_stats=True, **kw)[1]
    want_zero = sa.siren_attention_decode_plain(k, v, *stats, zero, omega, seq_len, **kw)
    near = (_rel_rms(got_m, want_m), _rel_rms(got_zero, want_zero))
    gaps = {}
    for table in ("bias", "layer0"):
        far = (_rel_rms(unrounded_table_plain(k, v, *stats, q, omega, seq_len, table, return_stats=True, **kw)[1],
                        want_m),
               _rel_rms(unrounded_table_plain(k, v, *stats, zero, omega, seq_len, table, **kw), want_zero))
        gaps[table] = min(f / n if n > 0 else math.inf for f, n in zip(far, near))
    return gaps


@pytest.mark.cuda
@pytest.mark.parametrize("n, t, seq_len, causal, hidden, layers, d, sin_impl, fm",
                         [WGMMA_2D_CASES[i] for i in (0, 2, 3, 7)],
                         ids=["ladder", "T16-fm", "hidden96-D64-exact", "hidden64-deep-fm-exact"])
def test_attention_bf16_wgmma_tables_are_rounded(cuda_device, n, t, seq_len, causal, hidden, layers, d, sin_impl,
                                                 fm):
    """2D in bf16 on csrc/siren_attention_wgmma.cu rounds its bias tables and layer 0 row to bf16: the plain
    version with the biases or layer 0's row left fp32 sits at least TABLE_GAIN times farther from the bf16 plain
    version than the kernel does, on the key net's side (the softmax max m, from the kernel's launch with its stats)
    and on the value net's (the output at q = 0)."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops._launch import stack_records

    k, v, *stats, q = _rounded_case(hidden, layers, d, n, t, cuda_device, seed=seq_len + t + hidden)
    kw = dict(sin_impl=sin_impl, fm_mult=fm, causal=causal)
    _, got_m, _ = sa.wgmma_attention_launch(stack_records(k), stack_records(v), len(k.dims), hidden, *stats, q, 30.0,
                                            seq_len, return_stats=True, round_weights=True, **kw)
    got_zero = sa.siren_attention_decode_fused(k, v, *stats, torch.zeros_like(q), 30.0, seq_len,
                                               compute_dtype=torch.bfloat16, **kw)
    gaps = table_gaps(got_m, got_zero, k, v, *stats, q, 30.0, seq_len, compute_dtype=torch.bfloat16, **kw)
    assert min(gaps.values()) >= TABLE_GAIN, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, d, t, route", [
    (256, 256, 1, "stack"), (256, 128, 17, "stack"), (512, 128, 1, "stack"), (96, 18, 2, "stack"),
    (96, 20, 4, "wgmma"),
], ids=["D256-stack", "T17-stack", "large-stack", "D18-stack", "hidden96-D20"])
def test_attention_bf16_route_by_rule(cuda_device, hidden, d, t, route):
    """Calls attention_route sends elsewhere (D > 128, T > 16, wide or unaligned nets) keep the layer stack's kBF16
    instance, no wgmma launch counted; both routes hold to the plain version."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa

    args = _rounded_case(hidden, 2, d, 2, t, cuda_device, seed=t + d)
    assert sa.attention_route(hidden, d, t) == route
    kw = dict(sin_impl="fast", causal=True, compute_dtype=torch.bfloat16)
    before = (sa.launches["siren_attention_decode_fused"], sa.wgmma_launches["siren_attention_decode_fused"])
    got = sa.siren_attention_decode_fused(*args, 30.0, 300, **kw)
    torch.cuda.synchronize()
    assert (sa.launches["siren_attention_decode_fused"], sa.wgmma_launches["siren_attention_decode_fused"]) == (
        before[0] + 1, before[1] + (route == "wgmma"))
    _bf16_close(got, sa.siren_attention_decode_plain(*args, 30.0, 300, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("config_name", ["medium", "small", "tiny", "deep"])
def test_attention_bf16_split_pass_writes_every_rounded_piece_bit_for_bit(cuda_device, monkeypatch, config_name):
    """The pieces 2D's bf16 launch leaves in device memory equal ``act16_pieces`` with one split: bf16(w) of every
    weight of every key net, then every value net, in wgmma's B layout and the consumers' order, every bit."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.tools.measure_attention_decode import attention_inputs

    config = CONFIGS_BY_NAME[config_name]
    buffers = []
    make = sa._pieces
    monkeypatch.setattr(sa, "_pieces", lambda *a: buffers.append(make(*a)) or buffers[-1])
    k, v, stats, q = attention_inputs(config, 3, 2, D, torch.Generator().manual_seed(9), cuda_device)
    sa.siren_attention_decode_fused(k, v, *stats, q, config.omega_0, 300, sin_impl="fast", causal=True,
                                    compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert len(buffers) == 1
    got = buffers[0].cpu().numpy().view(np.uint16)
    want = np.concatenate([act16_pieces([w[n].cpu() for w, _ in s.params()[1:]], config.hidden_features, splits=1)
                           for s in (k, v) for n in range(3)])
    assert got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).sum())} of {got.size} bf16 values differ"


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["nccl", "gloo"])
def test_mesh_shards_go_through_the_kernels(cuda_device, world):
    """dryrun_multichip's sections on the card: one NCCL rank a card, and two Gloo ranks sharing cuda:0 (NCCL
    refuses two ranks on one card). Every rank's shards launch 2A, 2C, 2D, 2E and 2F, and each sharded path (the
    tensor-parallel Llama's prefill, step and rollout among them) equals its unsharded run on the rank's card
    within the dry run's limits (a rank past one raises)."""
    import torch_mesh_ranks
    from nerf_attention_tpu_torch.parallel.mesh import run_on_mesh

    n, device = (torch.cuda.device_count(), "cuda") if world == "nccl" else (2, "cuda:0")
    ranks = run_on_mesh(torch_mesh_ranks.card_dryrun, world_size=n, device=device)
    assert len(ranks) == n
    for gaps, launched in ranks:
        assert all(launched[k] > 0 for k in ("2A", "2C", "2D", "2E", "2F")), launched
        assert set(gaps) == {"sweep cosine_mean", "2C", "2D", "2E", "2F (o, m, l)", "tp prefill", "tp decode step",
                             "tp rollout", "tp rollout refill", "sp prefill"}, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["nccl", "gloo"])
def test_mesh_resident_shards_on_the_card(cuda_device, world):
    """Each rank's nets put on its card once (shard_stack, shard_packed) decode through kernels 2C and 2E bit for
    bit as the global operands on the card do; global operands left on the host are refused on a card mesh."""
    import torch_mesh_ranks
    from nerf_attention_tpu_torch.parallel.mesh import run_on_mesh

    n, device = (torch.cuda.device_count(), "cuda") if world == "nccl" else (2, "cuda:0")
    ranks = run_on_mesh(torch_mesh_ranks.card_resident, world_size=n, device=device)
    assert len(ranks) == n
    for equal, launched, refusal in ranks:
        assert equal and launched == (2, 2), (equal, launched)
        assert "an operand on cpu was handed to a mesh on cuda" in refusal, refusal
