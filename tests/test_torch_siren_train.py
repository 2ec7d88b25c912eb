"""Training kernel 2A: the port's plain version against the Pallas kernel
(interpret mode); the CUDA kernel's arithmetic (layer-wise, every product in
3xTF32), emulated here on the CPU, against the same; and the row chunking of
the split-S kernels. The CUDA kernel itself is held to the plain version in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_attention_tpu.models.siren import init_siren as jax_init_siren
from nerf_attention_tpu.ops.siren_train_pallas import siren_train_grads as jax_train_grads
from nerf_attention_tpu.types import SIRENConfig as JaxConfig
from nerf_attention_tpu_torch.interop import params_from_jax
from nerf_attention_tpu_torch.models.siren import SirenStack, fm_frequency_multipliers
from nerf_attention_tpu_torch.ops import siren_train_cuda
from nerf_attention_tpu_torch.ops._launch import chunking
from nerf_attention_tpu_torch.ops.fastmath import fast_sincos
from nerf_attention_tpu_torch.parallel.sweep import normalize_targets

torch.set_num_threads(1)

# Tolerances of tests/test_siren_train_pallas.py:57-60, 96-97, 179-182.
EXACT = dict(loss=dict(rtol=1e-5, atol=1e-6), grads=dict(rtol=1e-4, atol=1e-6))
FAST = dict(loss=dict(rtol=1e-3, atol=1e-5), grads=dict(rtol=1e-3, atol=1e-5))
FM = dict(loss=dict(rtol=1e-3, atol=1e-4), grads=dict(rtol=1e-3, atol=1e-4))
N, D = 3, 16
CASES = [  # (hidden, hidden_layers, seq_len, tile, sin_impl, fm_mult, tolerances)
    (64, 1, 128, None, "exact", None, EXACT),
    (32, 2, 128, None, "exact", None, EXACT),
    (32, 2, 128, None, "fast", None, FAST),
    (64, 1, 96, None, "exact", 64.0, FM),
    (32, 1, 100, 32, "exact", None, EXACT),  # ragged: 100 rows in 32-row tiles
]
IDS = ["exact-h64", "exact-deep", "fast", "fm", "ragged"]


def _inputs(hidden, layers, seq_len, seed=0):
    cfg = JaxConfig(hidden, layers, 30.0, "t")
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    params = jax.vmap(lambda k: jax_init_siren(k, cfg, D))(keys)
    params = [(np.asarray(w), np.asarray(b)) for w, b in params]
    targets = np.random.default_rng(seed).standard_normal((N, seq_len, D)).astype(np.float32)
    return params, normalize_targets(torch.from_numpy(targets))[0].numpy()


@pytest.mark.parametrize("hidden, layers, seq_len, tile, sin_impl, fm, tol", CASES, ids=IDS)
def test_plain_matches_pallas(hidden, layers, seq_len, tile, sin_impl, fm, tol):
    params, targets_norm = _inputs(hidden, layers, seq_len)
    want_loss, want_grads = jax_train_grads(
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in params], jnp.asarray(targets_norm),
        omega=30.0, tile=tile, interpret=True, sin_impl=sin_impl, fm_mult=fm,
    )
    loss, grads = siren_train_cuda.siren_train_grads_plain(
        params_from_jax(params), torch.from_numpy(targets_norm), omega=30.0, sin_impl=sin_impl, fm_mult=fm,
    )
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **tol["loss"])
    assert len(grads) == len(params)
    for (gw, gb), (ww, wb) in zip(grads, want_grads):
        assert gw.shape == ww.shape and gb.shape == wb.shape
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), **tol["grads"])
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **tol["grads"])


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to TF32 as the kernel does: nearest, ties away from zero, 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)  # -0x2000 is 0xFFFFE000 as int32


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as csrc/tf32_mma.cuh computes it: a_lo b_hi + a_hi b_lo + a_hi b_hi, fp32 sums."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _kernel_step(params, targets, *, omega, sin_impl, fm_mult):
    """Loss and grads by csrc/siren_train.cu's sequence: layer-wise forward
    keeping h_i and the sine's derivative g_i, then the explicit backward,
    every product through ``_matmul_3xtf32``."""
    params = [(torch.tensor(w), torch.tensor(b)) for w, b in params]
    targets = torch.from_numpy(targets)
    _, seq_len, d_out = targets.shape
    hidden = params[0][0].shape[-1]
    sincos = fast_sincos if sin_impl == "fast" else (lambda z: (torch.sin(z), torch.cos(z)))
    x = (torch.arange(seq_len, dtype=torch.float32) / max(seq_len - 1, 1))[None, :, None]
    scale = omega * (torch.ones(hidden) if fm_mult is None else fm_frequency_multipliers(hidden, fm_mult))
    w0, b0 = params[0]
    h, c = sincos(scale * (x * w0 + b0[:, None, :]))
    hs, gs = [h], [scale * c]
    for w, b in params[1:-1]:
        h, c = sincos(omega * (_matmul_3xtf32(hs[-1], w) + b[:, None, :]))
        hs.append(h)
        gs.append(omega * c)
    wf, bf = params[-1]
    err = _matmul_3xtf32(hs[-1], wf) + bf[:, None, :] - targets
    loss = (err * err).sum(dim=(1, 2)) / (seq_len * d_out)
    da = (2.0 / (seq_len * d_out)) * err
    grads = [None] * len(params)
    for i in range(len(params) - 1, 0, -1):
        grads[i] = (_matmul_3xtf32(hs[i - 1].transpose(1, 2), da), da.sum(dim=1))
        da = _matmul_3xtf32(da, params[i][0].transpose(1, 2)) * gs[i - 1]
    grads[0] = ((x * da).sum(dim=1, keepdim=True), da.sum(dim=1))
    return loss, grads


@pytest.mark.parametrize("hidden, layers, seq_len, tile, sin_impl, fm, tol", CASES, ids=IDS)
def test_kernel_arithmetic_in_3xtf32_matches_pallas(hidden, layers, seq_len, tile, sin_impl, fm, tol):
    params, targets_norm = _inputs(hidden, layers, seq_len, seed=1)
    want_loss, want_grads = jax_train_grads(
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in params], jnp.asarray(targets_norm),
        omega=30.0, tile=tile, interpret=True, sin_impl=sin_impl, fm_mult=fm,
    )
    loss, grads = _kernel_step(params, targets_norm, omega=30.0, sin_impl=sin_impl, fm_mult=fm)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **tol["loss"])
    assert len(grads) == len(params)
    for (gw, gb), (ww, wb) in zip(grads, want_grads):
        assert gw.shape == ww.shape and gb.shape == wb.shape
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), **tol["grads"])
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **tol["grads"])


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -20, -(1.0 + ulp / 2), 3.0 + 0.3 * ulp])
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 3.0])
    assert torch.equal(_tf32(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert torch.all((_tf32(y) - y).abs() <= y.abs() * 2.0 ** -11)


def test_cpu_wrapper_takes_the_plain_version_for_lists_and_stacks():
    params, targets_norm = _inputs(32, 1, 64, seed=2)
    t = torch.from_numpy(targets_norm)
    before = dict(siren_train_cuda.launches)
    loss_l, grads_l = siren_train_cuda.siren_train_grads(params_from_jax(params), t, omega=30.0)
    stack = SirenStack.from_params(params_from_jax(params))
    loss_s, grads_s = siren_train_cuda.siren_train_grads(stack, t, omega=30.0)
    assert isinstance(grads_l, list) and isinstance(grads_s, SirenStack)
    np.testing.assert_array_equal(loss_l.numpy(), loss_s.numpy())
    for (a, b), (c, d) in zip(grads_l, grads_s.params()):
        np.testing.assert_array_equal(a.numpy(), c.numpy())
        np.testing.assert_array_equal(b.numpy(), d.numpy())
    assert siren_train_cuda.launches == before  # no kernel launched on the CPU
    assert not stack.flat.requires_grad


@pytest.mark.parametrize(
    "n, seq_len, slots",
    [(40, 2048, 264), (40, 2048, 132), (40, 2048, 396), (1, 2048, 264), (3, 100, 264), (7, 16, 396)],
)
def test_chunking_covers_every_row_once(n, seq_len, slots):
    chunks, rows = chunking(n, seq_len, 16, slots)
    assert rows % 16 == 0
    assert (chunks - 1) * rows < seq_len <= chunks * rows  # no empty chunk, no row left out


def test_chunking_fills_whole_waves():
    # 40 fits of 128 row tiles on 264 slots: 13 chunks give 520 blocks, two
    # nearly full waves of 10 tiles, where 7 chunks (280 blocks) would leave
    # the second wave of 19 tiles almost empty.
    assert chunking(40, 2048, 16, 264) == (13, 160)
