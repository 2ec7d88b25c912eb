"""Rank programs of the multi-device CPU tests (tests/test_torch_mesh.py, tests/test_torch_llama_sp.py,
tests/test_torch_llama_tp.py).

``parallel.mesh.run_on_mesh`` runs each on every rank of a Gloo fit mesh,
in spawned processes that import this module (so it imports no JAX). Each
takes numpy inputs made by the test, computes every case once, and returns
numpy outputs from rank 0, with what every rank recorded of itself gathered
by ``all_gather_object``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from nerf_attention_tpu_torch.models import llama
from nerf_attention_tpu_torch.ops import siren_attention_cuda, siren_cuda, siren_quant_cuda
from nerf_attention_tpu_torch.parallel.mesh import LocalShard, fit_mesh
from nerf_attention_tpu_torch.parallel.sweep import fit_batch
from nerf_attention_tpu_torch.types import SIRENConfig


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else x


def _torch(params):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in params]


def _every_rank(value):
    """``value`` of every rank, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


@contextlib.contextmanager
def _recording(module, name: str, measure, record: list):
    """``module.name`` replaced, inside the block, by a wrapper that appends ``measure(args, kwargs)`` to
    ``record`` before each call (what the sharded wrappers hand the unsharded one on this rank)."""
    inner = getattr(module, name)

    def wrapper(*args, **kwargs):
        record.append(measure(args, kwargs))
        return inner(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, inner)


def _stack_bytes(stack) -> int:
    return int(stack.flat.numel() * stack.flat.element_size())


def _refusal(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as err:
        return f"{type(err).__name__}: {err}"
    return "not refused"


def sweep_and_kernels(mesh, sweeps: list, kernels: dict) -> dict:
    """Every case of tests/test_torch_mesh.py on this rank's mesh.

    ``sweeps``: (name, targets, initial params, (hidden, hidden layers,
    omega), epochs, seed) each; ``kernels``: the inputs of 2C, 2D, 2E and 2F.
    Returns each case's sharded output (and, for the sweep, the unsharded
    run from the same start), the same from each rank's resident shards, the
    ragged refusals and those of operands off the mesh's device, and each
    rank's bytes of nets / payload handed to the unsharded wrappers and
    held in its resident shards.
    """
    out: dict = {"world": mesh.size()}
    named = fit_mesh(list(range(mesh.size())))  # the ranks given, as JAX's fit_mesh(devices) takes devices
    out["named mesh"] = (named.size(), named.mesh_dim_names, named.get_local_rank() == mesh.get_local_rank())
    for name, targets, init, (hidden, layers, omega), epochs, seed in sweeps:
        config = SIRENConfig(hidden, layers, omega, name)
        kw = dict(epochs=epochs, seed=seed, init_params=lambda *_: init, device="cpu")
        local = fit_batch(targets, config, **kw)
        kw.pop("device")
        sharded = fit_batch(targets, config, mesh=mesh, **kw)
        out[f"sweep {name}"] = {which: dict(losses=r.losses, cosine_mean=r.cosine_mean, final_mse=r.final_mse,
                                            params=r.params, num_fits=r.num_fits)
                                for which, r in (("sharded", sharded), ("local", local))}

    k = kernels
    omega, s = k["omega"], k["seq_len"]
    held: dict[str, list] = {"2C": [], "2D": [], "2E": [], "2F": []}
    with _recording(siren_cuda, "siren_decode_batch", lambda a, kw: _stack_bytes(a[0]), held["2C"]), \
            _recording(siren_attention_cuda, "siren_attention_decode_fused",
                       lambda a, kw: _stack_bytes(a[0]) + _stack_bytes(a[1]), held["2D"]), \
            _recording(siren_quant_cuda, "siren_decode_batch_quant",
                       lambda a, kw: siren_quant_cuda.resident_param_bytes(kw["packed"][0]), held["2E"]), \
            _recording(siren_quant_cuda, "siren_attention_decode_quant",
                       lambda a, kw: sum(siren_quant_cuda.resident_param_bytes(p[0]) for p in kw["packed"]),
                       held["2F"]):
        decode = _torch(k["decode"])
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            out[f"2C {tag}"] = _np(siren_cuda.siren_decode_batch_sharded(decode, omega, s, mesh,
                                                                         compute_dtype=dtype))
            kp, vp, *stats = k["attention"]
            out[f"2D {tag}"] = _np(siren_attention_cuda.siren_attention_decode_sharded(
                _torch(kp), _torch(vp), *map(torch.from_numpy, stats), omega, s, mesh, causal=k["causal"],
                compute_dtype=dtype))
            out[f"2E {tag}"] = _np(siren_quant_cuda.siren_decode_batch_quant_sharded(
                decode, k["scheme"], omega, s, mesh, compute_dtype=dtype))
            kp, vp, *stats = k["quant_attention"]
            out[f"2F {tag}"] = [_np(x) for x in siren_quant_cuda.siren_attention_decode_quant_sharded(
                _torch(kp), _torch(vp), *map(torch.from_numpy, stats), k["quant_scheme"], omega, s, mesh,
                causal=False, return_stats=True, compute_dtype=dtype)]
        kp, vp, *stats = k["quant_attention"]
        packed = tuple(siren_quant_cuda.pack_resident_params(_torch(p), k["quant_scheme"]) for p in (kp, vp))
        out["2F packed"] = _np(siren_quant_cuda.siren_attention_decode_quant_sharded(
            None, None, *map(torch.from_numpy, stats), k["quant_scheme"], omega, s, mesh, causal=False,
            packed=packed))
    out["held"] = _every_rank({name: list(v) for name, v in held.items()})

    # Each rank's nets put on its device once (shard_stack / shard_packed), then the calls take them as they are.
    (kp, vp, *stats), (qkp, qvp, *qstats) = k["attention"], k["quant_attention"]
    stacks = [siren_cuda.shard_stack(p, mesh) for p in (decode, _torch(kp), _torch(vp))]
    payloads = [siren_quant_cuda.shard_packed(decode, k["scheme"], mesh),
                *(siren_quant_cuda.shard_packed(_torch(p), k["quant_scheme"], mesh) for p in (qkp, qvp))]
    out["resident"] = {
        "2C": _np(siren_cuda.siren_decode_batch_sharded(stacks[0], omega, s, mesh)),
        "2D": _np(siren_attention_cuda.siren_attention_decode_sharded(
            stacks[1], stacks[2], *map(torch.from_numpy, stats), omega, s, mesh, causal=k["causal"])),
        "2E": _np(siren_quant_cuda.siren_decode_batch_quant_sharded(None, k["scheme"], omega, s, mesh,
                                                                    packed=payloads[0])),
        "2F": [_np(x) for x in siren_quant_cuda.siren_attention_decode_quant_sharded(
            None, None, *map(torch.from_numpy, qstats), k["quant_scheme"], omega, s, mesh, causal=False,
            packed=tuple(payloads[1:]), return_stats=True)],
    }
    payload_bytes = lambda shard: siren_quant_cuda.resident_param_bytes(shard.value[0])
    out["resident bytes"] = _every_rank({
        "2C": _stack_bytes(stacks[0].value), "2D": _stack_bytes(stacks[1].value) + _stack_bytes(stacks[2].value),
        "2E": payload_bytes(payloads[0]), "2F": payload_bytes(payloads[1]) + payload_bytes(payloads[2])})

    rank, world = mesh.get_local_rank(), mesh.size()
    on_meta = [(w.to("meta"), b.to("meta")) for w, b in decode]
    config = SIRENConfig(16, 1, 30.0, "refused")
    targets = torch.from_numpy(sweeps[0][1])
    out["off the mesh"] = {
        "2C operands on another device": _refusal(lambda: siren_cuda.siren_decode_batch_sharded(
            on_meta, omega, s, mesh)),
        "2E operands on another device": _refusal(lambda: siren_quant_cuda.siren_decode_batch_quant_sharded(
            on_meta, k["scheme"], omega, s, mesh)),
        "sweep targets on another device": _refusal(lambda: fit_batch(targets.to("meta"), config, epochs=1,
                                                                      mesh=mesh)),
        "sweep on another device": _refusal(lambda: fit_batch(targets, config, epochs=1, device="cuda", mesh=mesh)),
        "2C another rank's shard": _refusal(lambda: siren_cuda.siren_decode_batch_sharded(
            LocalShard(stacks[0].value, (rank + 1) % world, world), omega, s, mesh)),
        "2E another rank's shard": _refusal(lambda: siren_quant_cuda.siren_decode_batch_quant_sharded(
            None, k["scheme"], omega, s, mesh, packed=LocalShard(payloads[0].value, (rank + 1) % world, world))),
        "2D another batch's shard": _refusal(lambda: siren_attention_cuda.siren_attention_decode_sharded(
            siren_cuda.shard_stack([(w[:world], b[:world]) for w, b in _torch(kp)], mesh), stacks[2],
            *map(torch.from_numpy, stats), omega, s, mesh)),
    }

    ragged = k["ragged"]
    kp, vp, *stats = k["attention"]
    cut = lambda p: [(w[:ragged], b[:ragged]) for w, b in _torch(p)]
    cut_stats = [torch.from_numpy(x[:ragged]) for x in stats]
    out["refusals"] = {
        "2C": _refusal(lambda: siren_cuda.siren_decode_batch_sharded(cut(k["decode"]), omega, s, mesh)),
        "2D": _refusal(lambda: siren_attention_cuda.siren_attention_decode_sharded(
            cut(kp), cut(vp), *cut_stats, omega, s, mesh)),
        "2E": _refusal(lambda: siren_quant_cuda.siren_decode_batch_quant_sharded(
            cut(k["decode"]), k["scheme"], omega, s, mesh)),
        "2F": _refusal(lambda: siren_quant_cuda.siren_attention_decode_quant_sharded(
            cut(kp), cut(vp), *cut_stats, k["quant_scheme"], omega, s, mesh)),
    }
    return out


def fail_on_rank(mesh, rank: int) -> None:
    """Raise on one rank while the others wait in a collective for it."""
    if mesh.get_local_rank() == rank:
        raise RuntimeError(f"planted failure on rank {rank}")
    dist.barrier()


def sp_prefills(mesh, cases: list, padded: tuple, ragged: tuple) -> dict:
    """tests/test_torch_llama_sp.py's cases on this rank's mesh.

    ``cases``: (name, LlamaConfig fields, params, ids) each: the SP prefill,
    the single-device one, and per rank the rows of every layer's input it
    computed; ``padded``: (fields, params, ids, output_dir) for
    ``prefill_and_save_kv(seq_mesh=)``; ``ragged``: (fields, params, ids),
    whose length the mesh does not divide.
    """
    out: dict = {}
    for name, fields, params, ids in cases:
        config = llama.LlamaConfig(**fields)
        rows: list[int] = []
        with _recording(llama, "_layer_forward", lambda a, kw: int(a[1].shape[0]), rows):
            sp = llama.llama_prefill_kv_sp(config, params, ids, mesh)
        single = llama.llama_prefill_kv(config, params, ids)
        out[name] = dict(sp=[_np(x) for x in sp], single=[_np(x) for x in single], rows=_every_rank(rows))
    fields, params, ids, output_dir = padded
    out["padded"] = llama.prefill_and_save_kv(llama.LlamaConfig(**fields), params, ids, output_dir, "toy",
                                              seq_mesh=mesh).to_dict()
    fields, params, ids = ragged
    out["ragged"] = _refusal(lambda: llama.llama_prefill_kv_sp(llama.LlamaConfig(**fields), params, ids, mesh))
    return out


def _same_on_every_rank(x: torch.Tensor, mesh) -> bool:
    """Whether every rank holds ``x`` bit for bit as rank 0 does."""
    from nerf_attention_tpu_torch.parallel.mesh import gather_rows

    parts = gather_rows(x.reshape(1, -1), mesh)
    return all(torch.equal(parts[0], part) for part in parts)


@contextlib.contextmanager
def _checked_reduces(mesh, record: list):
    """Inside the block, every ``all_reduce_sum`` of the TP forward appends whether its sum came out the same bits on
    every rank."""
    inner = llama.all_reduce_sum

    def checked(x, m):
        out = inner(x, m)
        record.append(_same_on_every_rank(out, mesh))
        return out

    llama.all_reduce_sum = checked
    try:
        yield
    finally:
        llama.all_reduce_sum = inner


def _tp_case(mesh, config, params, ids, position, keys, values) -> dict:
    """One configuration under TP: the prefill, the decode step at ``position`` over the global prefix cache
    ``keys`` / ``values`` [:position] (with both captures), and the rollout of ids[position:] from the rank's
    ``shard_kv_heads`` of the buffers (rows past ``position`` zeroed)."""
    sharded = llama.shard_llama_params(params, mesh, config=config)
    keys, values = torch.from_numpy(keys), torch.from_numpy(values)
    reduces: list[bool] = []
    with _checked_reduces(mesh, reduces):
        prefill = llama.llama_prefill_kv(config, sharded, ids)
        h, (k_new, v_new), ent, ffn_x, sink = llama.llama_decode_step(
            config, sharded, int(ids[position]), position, keys[:, :, :position], values[:, :, :position],
            capture_ffn_input=True, capture_sink_mass=True)
        kept = (torch.arange(keys.shape[2]) < position)[None, None, :, None]
        buffers = [llama.shard_kv_heads(torch.where(kept, x, 0.0), sharded["tp"]) for x in (keys, values)]
        hs, filled, (rk, rv), rent = llama.llama_decode_rollout(config, sharded, ids[position:], position, *buffers)
    return dict(prefill=[_np(x) for x in prefill], step=[_np(x) for x in (h, k_new, v_new, ent, ffn_x, sink)],
                rollout=[_np(x) for x in (hs, *filled, rk, rv, rent)], reduces=len(reduces),
                same_bits=all(reduces) and _same_on_every_rank(h, mesh) and _same_on_every_rank(hs, mesh))


def tp_forwards(mesh, cases: list, batched: tuple, extraction: tuple) -> dict:
    """tests/test_torch_llama_tp.py's cases on this rank's mesh.

    ``cases``: (name, LlamaConfig, params, ids, position, prefill keys,
    values) each (``_tp_case``); ``batched``: (config, params, tokens,
    positions, keys, values) for a decode step over a batch of caches,
    sharded and unsharded; ``extraction``: (config, params, ids, output_dir)
    for ``prefill_and_save_kv`` under TP, with each rank's layer writes.
    Returns rank 0's outputs, every rank's layout and leaf shapes, the
    refusals, and whether every sum came out the same bits on every rank.
    """
    from nerf_attention_tpu_torch.io import kvstore
    from nerf_attention_tpu_torch.parallel.mesh import LocalShard

    rank, world = mesh.get_local_rank(), mesh.size()
    out: dict = {name: _tp_case(mesh, config, params, ids, position, keys, values)
                 for name, config, params, ids, position, keys, values in cases}
    out["same bits"] = _every_rank({name: out[name].pop("same_bits") for name, *_ in cases})

    config, params, tokens, positions, keys, values = batched
    sharded = llama.shard_llama_params(params, mesh, config=config)
    keys, values = torch.from_numpy(keys), torch.from_numpy(values)
    tokens, positions = torch.from_numpy(tokens), torch.from_numpy(positions)
    kw = dict(capture_ffn_input=True, capture_sink_mass=True)
    step = llama.llama_decode_step(config, sharded, tokens, positions, keys, values, **kw)
    shards = [llama.shard_kv_heads(x, sharded["tp"]) for x in (keys, values)]
    from_shards = llama.llama_decode_step(config, sharded, tokens, positions, *shards, **kw)
    whole = llama.llama_decode_step(config, params, tokens, positions, keys, values, **kw)
    flat = lambda r: [r[0], *r[1], *r[2:]]
    out["batched"] = dict(tp=[_np(x) for x in flat(step)], unsharded=[_np(x) for x in flat(whole)],
                          shards_equal=all(torch.equal(a, b) for a, b in zip(flat(step), flat(from_shards))))
    # The rollout into global buffers on every rank: each rank writes its heads in place, the gathered rows land
    # in the caller's buffers, and they equal the rollout from the rank's shards bit for bit.
    buffers = [x[0].clone() for x in (keys, values)]
    ids = np.asarray([int(t) for t in tokens])
    start = int(positions.min())
    hs, filled, _, _ = llama.llama_decode_rollout(config, sharded, ids, start, *buffers)
    shard_run = llama.llama_decode_rollout(config, sharded, ids, start,
                                           *[llama.shard_kv_heads(x[0], sharded["tp"]) for x in (keys, values)])
    out["global buffers"] = dict(in_place=all(f is b for f, b in zip(filled, buffers)),
                                 equal=torch.equal(hs, shard_run[0])
                                 and all(torch.equal(a, b) for a, b in zip(filled, shard_run[1])))
    # A batched rollout (the three caches, two tokens each) with forced rows (the contamination-control arm),
    # sharded and unsharded.
    steps = 2
    batch_ids = np.stack([np.arange(steps) + first for first in (3, 7, 9)])
    forced = [torch.randn(3, steps, *x.shape[1:3], 1, x.shape[-1], generator=torch.Generator().manual_seed(i))
              for i, x in enumerate((keys, values))]
    runs = {}
    for name, p in (("tp", sharded), ("unsharded", params)):
        hs, (fk, fv), (rk, rv), ent = llama.llama_decode_rollout(config, p, batch_ids, start, keys.clone(),
                                                                 values.clone(), *forced)
        runs[name] = [_np(x) for x in (hs, fk, fv, rk, rv, ent)]
    out["batched rollout"] = dict(runs, forced=[_np(x) for x in forced], start=start)

    layout = sharded["tp"]
    out["layouts"] = _every_rank(dict(q_heads=layout.q_heads, kv_heads=layout.kv_heads,
                                      kv_replicas=layout.kv_replicas,
                                      shapes={k: tuple(v.shape) for k, v in sharded["layers"][0].items()}))

    (dense_config, dense), (moe_config, moe) = (next((c, p) for _, c, p, *_ in cases if bool(c.num_local_experts) == e)
                                                for e in (False, True))
    other = LocalShard(shards[0].value, (rank + 1) % world, world)
    elsewhere = dict(sharded, tp=dataclasses.replace(layout, rank=(rank + 1) % world))
    five_heads = dataclasses.replace(config, num_attention_heads=5, num_key_value_heads=1)
    twelve_heads = dataclasses.replace(config, num_attention_heads=12, num_key_value_heads=3)
    out["refusals"] = {
        "expert_axis on a MoE": _refusal(lambda: llama.shard_llama_params(moe, mesh, expert_axis="ep",
                                                                          config=moe_config)),
        "expert_axis on a dense model": _refusal(lambda: llama.shard_llama_params(dense, mesh, expert_axis="ep",
                                                                                  config=dense_config)),
        "5 query heads": _refusal(lambda: llama.shard_llama_params(params, mesh, config=five_heads)),
        "3 KV heads": _refusal(lambda: llama.shard_llama_params(params, mesh, config=twelve_heads)),
        "another rank's weights": _refusal(lambda: llama.llama_prefill_kv(config, elsewhere, ids)),
        "another rank's cache": _refusal(lambda: llama.llama_decode_step(config, sharded, int(ids[0]), 1, other,
                                                                         shards[1])),
        "SP on TP weights": _refusal(lambda: llama.llama_prefill_kv_sp(config, sharded, np.arange(world), mesh)),
    }

    config, params, ids, output_dir = extraction
    writes: list[int] = []
    with _recording(kvstore, "save_layer", lambda a, kw: int(a[1]), writes):
        out["extraction"] = llama.prefill_and_save_kv(config, llama.shard_llama_params(params, mesh, config=config),
                                                      ids, output_dir, "toy").to_dict()
    out["writes"] = _every_rank(writes)
    return out


def layer_profile(mesh, kv_dir, output_dir, epochs: int) -> list:
    """``experiments.scaling.run_full_layer_profile(mesh=)`` on this rank (tests/test_torch_mesh.py)."""
    from nerf_attention_tpu_torch.experiments import scaling

    return scaling.run_full_layer_profile(kv_dir, output_dir, epochs=epochs, verbose=False, mesh=mesh)


def card_dryrun(mesh) -> list:
    """``dryrun.dryrun_rank`` on a card, with the kernel launches this rank made in it; every rank's (gaps,
    launches), in rank order."""
    from nerf_attention_tpu_torch.dryrun import dryrun_rank
    from nerf_attention_tpu_torch.ops import siren_train_cuda

    counters = {"2A": (siren_train_cuda.launches, "siren_train_grads"),
                "2C": (siren_cuda.launches, "siren_decode_batch"),
                "2D": (siren_attention_cuda.launches, "siren_attention_decode_fused"),
                "2E": (siren_quant_cuda.launches, "siren_decode_batch_quant"),
                "2F": (siren_quant_cuda.launches, "siren_attention_decode_quant")}
    before = {k: c[key] for k, (c, key) in counters.items()}
    gaps = dryrun_rank(mesh)
    return _every_rank((gaps, {k: c[key] - before[k] for k, (c, key) in counters.items()}))


def card_resident(mesh) -> list:
    """On a card mesh: 2C and 2E from each rank's resident shard (put on its card once from the host) against
    the same calls from global operands on the card, bit for bit, with the launches this rank made; and the
    refusal of global operands left on the host. Every rank's (equal, launches, refusal), in rank order."""
    from nerf_attention_tpu_torch.models.siren import init_siren
    from nerf_attention_tpu_torch.parallel.mesh import mesh_device

    dev = mesh_device(mesh)
    host = init_siren(SIRENConfig(64, 2, 30.0, "resident"), 16, generator=torch.Generator().manual_seed(5),
                      n=4 * mesh.size())
    on_card = [(w.to(dev), b.to(dev)) for w, b in host]
    before = (siren_cuda.launches["siren_decode_batch"], siren_quant_cuda.launches["siren_decode_batch_quant"])
    decode = siren_cuda.siren_decode_batch_sharded(siren_cuda.shard_stack(host, mesh), 30.0, 256, mesh)
    quant = siren_quant_cuda.siren_decode_batch_quant_sharded(
        None, "int4_g32", 30.0, 256, mesh, packed=siren_quant_cuda.shard_packed(host, "int4_g32", mesh))
    equal = (torch.equal(decode, siren_cuda.siren_decode_batch_sharded(on_card, 30.0, 256, mesh))
             and torch.equal(quant, siren_quant_cuda.siren_decode_batch_quant_sharded(on_card, "int4_g32", 30.0,
                                                                                      256, mesh)))
    launched = (siren_cuda.launches["siren_decode_batch"] - before[0],
                siren_quant_cuda.launches["siren_decode_batch_quant"] - before[1])
    refusal = _refusal(lambda: siren_cuda.siren_decode_batch_sharded(host, 30.0, 256, mesh))
    return _every_rank((equal, launched, refusal))
