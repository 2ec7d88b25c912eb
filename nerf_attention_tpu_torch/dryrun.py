"""The multi-device dry run: the port's counterpart of ``__graft_entry__.py:dryrun_multichip``.

``dryrun_multichip(n)`` starts a fit mesh of n ranks (``parallel/mesh.py``)
and, on every rank, holds each sharded path of the port to its unsharded
run on the same inputs, as the JAX dry run does on its CPU mesh
(``__graft_entry__.py:45-250``, ``:340-346``):

* the sweep: 2n tiny fits, unsharded and sharded over the mesh
  (``fit_batch(mesh=)``), CosSim within 1e-4 and the losses within
  rtol 1e-3 / atol 1e-5;
* kernels 2C, 2D, 2E (int4_g32) and 2F (int8_g32, with its (m, l)) sharded
  over the nets or heads against the unsharded wrappers, within the atol
  the kernels are held to against their plain versions (2e-5 for the
  decodes, 5e-5 for attention): on a card the launch plans split a problem
  by its net count, so a shard's sums may run in another order (on the CPU
  they are equal bit for bit);
* the tensor-parallel Llama of ``:253-335`` (hidden 8n, intermediate 16n,
  n query and n KV heads of width 8, 2 layers; ``shard_llama_params``): the
  prefill of 16 tokens, the decode step at position 12 over the rank's
  heads of the prefix and a 4-token rollout from the rank's shard of the
  buffers, against the unsharded calls within 1e-4, the rollout's filled
  rows against the prefill's;
* the sequence-parallel prefill of a tiny random Llama against the
  single-device prefill, within 1e-4.

By default the ranks are NCCL processes, one a card, where every shard goes
through the kernels; without a card that raises. ``device="cpu"`` starts
Gloo ranks on the CPU, where the wrappers take their plain versions. The
pipeline- and expert-parallel sections of the JAX dry run (``:351-467``)
and its MLA section wait for the next slices of the multi-device port
(``ROADMAP.md`` queue 1, item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_attention_tpu_torch.models import llama
from nerf_attention_tpu_torch.ops.siren_attention_cuda import (
    siren_attention_decode_fused,
    siren_attention_decode_sharded,
)
from nerf_attention_tpu_torch.ops.siren_cuda import siren_decode_batch, siren_decode_batch_sharded
from nerf_attention_tpu_torch.ops.siren_quant_cuda import (
    siren_attention_decode_quant,
    siren_attention_decode_quant_sharded,
    siren_decode_batch_quant,
    siren_decode_batch_quant_sharded,
)
from nerf_attention_tpu_torch.parallel.mesh import mesh_device, run_on_mesh
from nerf_attention_tpu_torch.parallel.sweep import fit_batch
from nerf_attention_tpu_torch.types import SIRENConfig

CONFIG = SIRENConfig(32, 1, 30.0, "dryrun")
EPOCHS, SEQ_LEN, D = 30, 64, 8
DECODE_ATOL, ATTENTION_ATOL = 2e-5, 5e-5
LLAMA = llama.LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, head_dim=8)


def _gap(got, want) -> float:
    return float((torch.as_tensor(got).float().cpu() - torch.as_tensor(want).float().cpu()).abs().max())


def _check(what: str, gap: float, limit: float, gaps: dict) -> None:
    gaps[what] = gap
    if not gap <= limit:
        raise AssertionError(f"{what}: sharded against unsharded differ by {gap:.3e} (limit {limit:.0e})")


def _tp_section(mesh, dev, gaps: dict) -> None:
    """``__graft_entry__.py:253-335`` on this rank: the TP prefill, step and rollout against the unsharded ones."""
    n = mesh.size()
    config = llama.LlamaConfig(vocab_size=64, hidden_size=8 * n, intermediate_size=16 * n, num_hidden_layers=2,
                               num_attention_heads=n, num_key_value_heads=n, head_dim=8)
    params = llama.init_random_llama(config, seed=0, device=dev)
    sharded = llama.shard_llama_params(params, mesh, config=config)
    ids, prefix = np.arange(16), 12  # the rollout takes the last 4 tokens
    k_ref, v_ref = llama.llama_prefill_kv(config, params, ids)
    _check("tp prefill", max(_gap(a, b) for a, b in zip(llama.llama_prefill_kv(config, sharded, ids),
                                                        (k_ref, v_ref))), 1e-4, gaps)
    ck, cv = k_ref[:, :, :prefix], v_ref[:, :, :prefix]
    h, (k_new, _), _ = llama.llama_decode_step(config, params, int(ids[prefix]), prefix, ck, cv)
    h_tp, (k_new_tp, _), _ = llama.llama_decode_step(config, sharded, int(ids[prefix]), prefix, ck, cv)
    _check("tp decode step", max(_gap(h_tp, h), _gap(k_new_tp, k_new)), 1e-4, gaps)
    kept = (torch.arange(len(ids), device=dev) < prefix)[None, None, :, None]
    buffers = [torch.where(kept, x, 0.0) for x in (k_ref, v_ref)]
    hs, (k_fill, _), _, _ = llama.llama_decode_rollout(config, params, ids[prefix:], prefix,
                                                       *[x.clone() for x in buffers])
    shards = [llama.shard_kv_heads(x, sharded["tp"]) for x in buffers]
    hs_tp, (k_fill_tp, _), _, _ = llama.llama_decode_rollout(config, sharded, ids[prefix:], prefix, *shards)
    _check("tp rollout", _gap(hs_tp, hs), 1e-4, gaps)
    _check("tp rollout refill", max(_gap(k_fill, k_ref), _gap(k_fill_tp, k_ref)), 1e-4, gaps)


def dryrun_rank(mesh) -> dict[str, float]:
    """One rank's dry run; returns each section's largest gap from its unsharded run (raises past a limit)."""
    n, dev = mesh.size(), mesh_device(mesh)
    gaps: dict[str, float] = {}
    n_fits = 2 * n
    t = np.linspace(0, 1, SEQ_LEN, dtype=np.float32)[:, None]
    targets = np.stack([np.sin(2 * np.pi * (i + 1) * t) * np.ones((1, D), np.float32) for i in range(n_fits)])
    local = fit_batch(targets, CONFIG, epochs=EPOCHS, seed=0, device=dev)
    sharded = fit_batch(targets, CONFIG, epochs=EPOCHS, seed=0, mesh=mesh)
    _check("sweep cosine_mean", _gap(sharded.cosine_mean, local.cosine_mean), 1e-4, gaps)
    np.testing.assert_allclose(sharded.losses, local.losses, rtol=1e-3, atol=1e-5)

    params = [(torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)) for w, b in sharded.params]
    omega = CONFIG.omega_0
    dec = siren_decode_batch(params, omega, SEQ_LEN)
    _check("2C", _gap(siren_decode_batch_sharded(params, omega, SEQ_LEN, mesh), dec), DECODE_ATOL, gaps)

    half = n_fits // 2  # == n: one head a rank
    kp, vp = [(w[:half], b[:half]) for w, b in params], [(w[half:], b[half:]) for w, b in params]
    stats = [torch.from_numpy(x).to(dev) for x in (sharded.target_mean[:half], sharded.target_std[:half],
                                                   sharded.target_mean[half:], sharded.target_std[half:])]
    q = dec[:half, -1:, :].contiguous()
    _check("2D", _gap(siren_attention_decode_sharded(kp, vp, *stats, q, omega, SEQ_LEN, mesh),
                      siren_attention_decode_fused(kp, vp, *stats, q, omega, SEQ_LEN)), ATTENTION_ATOL, gaps)
    _check("2E", _gap(siren_decode_batch_quant_sharded(params, "int4_g32", omega, SEQ_LEN, mesh),
                      siren_decode_batch_quant(params, "int4_g32", omega, SEQ_LEN)), DECODE_ATOL, gaps)
    kw = dict(causal=False, return_stats=True)
    got = siren_attention_decode_quant_sharded(kp, vp, *stats, q, "int8_g32", omega, SEQ_LEN, mesh, **kw)
    want = siren_attention_decode_quant(kp, vp, *stats, q, "int8_g32", omega, SEQ_LEN, **kw)
    _check("2F (o, m, l)", max(_gap(a, b) for a, b in zip(got, want)), ATTENTION_ATOL, gaps)

    _tp_section(mesh, dev, gaps)

    lparams = llama.init_random_llama(LLAMA, seed=0, device=dev)
    ids = np.arange(2 * n) % LLAMA.vocab_size
    ref = llama.llama_prefill_kv(LLAMA, lparams, ids)
    sp = llama.llama_prefill_kv_sp(LLAMA, lparams, ids, mesh)
    _check("sp prefill", max(_gap(a, b) for a, b in zip(sp, ref)), 1e-4, gaps)
    return gaps


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict[str, float]:
    """The dry run on ``n_devices`` ranks: one NCCL rank a card (``"cuda"``, raising without a card), Gloo ranks
    sharing one card (``"cuda:0"``), or Gloo on the CPU (``device="cpu"``). Returns rank 0's gaps; raises if any
    rank fails."""
    return run_on_mesh(dryrun_rank, world_size=n_devices, device=device)

