"""The fit mesh (``parallel/mesh.py``) and the sharded paths over it, on Gloo worlds of 2 and 4 CPU ranks.

One world a size computes every case once (``tests/torch_mesh_ranks.py``,
spawned ranks that import no JAX), from inputs made here with numpy; the
JAX side runs in this process on the conftest's 8-device CPU mesh, its
Pallas kernels in interpret mode.

Tolerances. Sharded against the port's unsharded run: equal bit for bit,
since each rank runs the same plain arithmetic on its rows (a fit, a net or
a head never reads another's). Against JAX's sharded functions: the sweep at
the quality ``tests/test_sharding.py`` holds its fused kernel to (CosSim
atol 2e-3, losses rtol 1e-3 / atol 1e-5; the two packages sum in other
orders over 50 steps), 2C and 2E at ``tests/test_siren_pallas.py``'s
atol 2e-5 / rtol 1e-5, 2D and 2F at ``tests/test_siren_attention_pallas.py``'s
atol 5e-5 / rtol 1e-4, 2F's (m, l) as m + log l within 1e-4
(``tests/test_torch_siren_quant.py``).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nerf_attention_tpu.ops.siren_attention_pallas import siren_attention_decode_sharded as jax_attention_sharded
from nerf_attention_tpu.ops.siren_pallas import siren_decode_batch_sharded as jax_decode_sharded
from nerf_attention_tpu.ops.siren_quant_pallas import (
    siren_attention_decode_quant_sharded as jax_quant_attention_sharded,
    siren_decode_batch_quant_sharded as jax_quant_decode_sharded,
)
from nerf_attention_tpu.parallel.mesh import fit_mesh as jax_fit_mesh
from nerf_attention_tpu.parallel.sweep import fit_batch as jax_fit_batch
from nerf_attention_tpu.types import SIRENConfig as JaxConfig
from nerf_attention_tpu_torch import fit, quickstart, study, synthetic
from nerf_attention_tpu_torch.io import checkpoint
from nerf_attention_tpu_torch.ops import siren_attention_cuda, siren_cuda, siren_quant_cuda
from nerf_attention_tpu_torch.parallel import mesh as port_mesh
from test_torch_fit import jax_initial_params
from test_torch_siren_attention import attention_inputs, siren_heads, to_jax
import torch_mesh_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
TINY = (16, 1, 30.0)  # tests/test_sharding.py's net
EPOCHS, SEED = 50, 0
SWEEP_TOL = dict(cosine=2e-3, losses=dict(rtol=1e-3, atol=1e-5))
DECODE_TOL = dict(atol=2e-5, rtol=1e-5)
ATTENTION_TOL = dict(atol=5e-5, rtol=1e-4)
N_NETS, SEQ_LEN, T, OMEGA = 8, 128, 2, 30.0
SCHEME, QUANT_SCHEME = "int4_g32", "int8_g32"


def _targets(n, seq_len=64, d_head=4):
    t = np.linspace(0, 1, seq_len)[:, None]
    return np.stack([np.sin(2 * np.pi * (i + 1) * t) * np.ones((1, d_head)) for i in range(n)]).astype(np.float32)


# 5 fits pad to 6 and to 8; 1 fit pads to 2, and to 4 on four ranks: a pad that exceeds the batch.
SWEEPS = {"uneven": 5, "one": 1}
KERNELS = dict(
    omega=OMEGA, seq_len=SEQ_LEN, causal=True, scheme=SCHEME, quant_scheme=QUANT_SCHEME, ragged=6,
    decode=siren_heads(N_NETS, 32, 1, seed=3, d=8),
    attention=attention_inputs(N_NETS, T, hidden=32, hidden_layers=1, seed=5, d=8),
    quant_attention=attention_inputs(N_NETS, T, hidden=64, hidden_layers=1, seed=7, d=32),
)


def _sweep_inputs():
    config = JaxConfig(*TINY, "t")
    return [(name, _targets(n), jax_initial_params(config, n, 4, SEED), TINY, EPOCHS, SEED)
            for name, n in SWEEPS.items()]


@pytest.fixture(scope="module")
def worlds():
    """Each world size's results: every case computed once on a Gloo world of that many CPU ranks."""
    inputs = _sweep_inputs()
    return {world: port_mesh.run_on_mesh(torch_mesh_ranks.sweep_and_kernels, inputs, KERNELS, world_size=world,
                                         device="cpu")
            for world in WORLDS}


def _jax_mesh(world: int) -> Mesh:
    return jax_fit_mesh(jax.devices()[:world])


# ---- the mesh ----

@pytest.mark.parametrize("n, k, want", [(40, 8, 40), (12, 8, 16), (1, 8, 8), (5, 2, 6), (1, 4, 4), (0, 4, 0)])
def test_pad_to_multiple(n, k, want):
    """As the JAX package's, including a pad that exceeds the batch (1 -> 8, 1 -> 4)."""
    assert port_mesh.pad_to_multiple(n, k) == want


@pytest.mark.parametrize("world", WORLDS)
def test_each_world_is_a_named_1d_mesh(worlds, world):
    """fit_mesh() over the group, and fit_mesh(ranks) over the ranks given: one axis named "fit"."""
    assert worlds[world]["world"] == world
    assert worlds[world]["named mesh"] == (world, ("fit",), True)


def test_a_failing_rank_fails_the_run():
    """A rank that raises ends the whole run with an error at once, though the others wait in a barrier."""
    import time

    start = time.perf_counter()
    with pytest.raises(RuntimeError, match="exited with"):
        port_mesh.run_on_mesh(torch_mesh_ranks.fail_on_rank, 1, world_size=2, device="cpu")
    assert time.perf_counter() - start < 120


# (operand's device, mesh's device, from_host, refused): a card's operand never runs on a CPU mesh, nor is host
# data copied to a card mesh at each call; host data goes on a mesh's device once, where a caller says so.
PLACEMENTS = [("cpu", "cpu", False, False), ("meta", "cpu", False, True), ("meta", "cpu", True, True),
              ("cpu", "cuda", False, True), ("numpy", "cuda", False, True), ("cpu", "cuda", True, False),
              ("numpy", "cuda", True, False), ("meta", "cuda", True, True)]


@pytest.mark.parametrize("operand, kind, from_host, refused", PLACEMENTS)
def test_operands_stay_on_the_mesh_kind_of_device(operand, kind, from_host, refused):
    """check_on_mesh's rule, on stand-in meshes of either kind (this machine has no card)."""
    from types import SimpleNamespace

    x = np.zeros((2, 3), np.float32) if operand == "numpy" else torch.zeros(2, 3, device=operand)
    mesh = SimpleNamespace(device_type=kind)
    if refused:
        with pytest.raises(ValueError, match=f"handed to a mesh on {kind}"):
            port_mesh.check_on_mesh(x, mesh, from_host=from_host)
    else:
        port_mesh.check_on_mesh(x, mesh, from_host=from_host)


@pytest.mark.parametrize("asked, refused", [(None, False), ("cpu", False), ("cuda", True), ("cuda:0", True)])
def test_an_explicit_device_must_be_the_mesh(asked, refused):
    """mesh_device(mesh, device): a device the caller names is the rank's, or refused (a CPU mesh here)."""
    from types import SimpleNamespace

    mesh = SimpleNamespace(device_type="cpu")
    if refused:
        with pytest.raises(ValueError, match="this rank of the mesh computes on cpu"):
            port_mesh.mesh_device(mesh, asked)
    else:
        assert port_mesh.mesh_device(mesh, asked) == torch.device("cpu")


def test_mesh_without_a_card_needs_the_cpu(monkeypatch, tmp_path):
    """--mesh asks for the cards unless --device cpu; no card is an error, and on the CPU the rank count is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["--kv_dir", str(tmp_path / "kv"), "--output_dir", str(tmp_path / "fits"), "--mesh"]
    with pytest.raises(RuntimeError, match="cuda"):
        fit.main(base)
    with pytest.raises(ValueError, match="rank count"):
        fit.main([*base, "--device", "cpu"])
    assert not (tmp_path / "fits").exists()


# ---- the sweep ----

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", SWEEPS)
def test_sharded_sweep_equals_unsharded(worlds, world, case):
    """Same start, same per-fit arithmetic: every fit's losses, metrics and params bit for bit, pads dropped."""
    got = worlds[world][f"sweep {case}"]
    sharded, local = got["sharded"], got["local"]
    assert sharded["num_fits"] == SWEEPS[case] and sharded["losses"].shape == (SWEEPS[case], EPOCHS)
    for key in ("losses", "cosine_mean", "final_mse"):
        np.testing.assert_array_equal(sharded[key], local[key])
    for (w, b), (w0, b0) in zip(sharded["params"], local["params"]):
        assert w.shape[0] == SWEEPS[case]
        np.testing.assert_array_equal(w, w0)
        np.testing.assert_array_equal(b, b0)


@functools.cache
def _jax_sweep(case: str):
    """JAX's fit_batch(mesh=, impl="pallas") on 4 of the CPU devices (a fit's numbers do not depend on the mesh
    size; 1 fit pads to 4 there, past the batch), from the initial params the port's sweeps start from."""
    return jax_fit_batch(_targets(SWEEPS[case]), JaxConfig(*TINY, "t"), epochs=EPOCHS, seed=SEED,
                         mesh=_jax_mesh(max(WORLDS)), impl="pallas")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", SWEEPS)
def test_sharded_sweep_matches_jax_fused_kernel(worlds, world, case):
    """Each world's sharded sweep against JAX's sharded fused-kernel sweep."""
    want = _jax_sweep(case)
    got = worlds[world][f"sweep {case}"]["sharded"]
    np.testing.assert_allclose(got["cosine_mean"], want.cosine_mean, atol=SWEEP_TOL["cosine"])
    np.testing.assert_allclose(got["losses"], want.losses, **SWEEP_TOL["losses"])


# ---- kernels 2C-2F ----

def _torch_nets(params):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in params]


def _unsharded(kernel: str, dtype):
    """The port's unsharded wrapper (its plain version here) on the whole batch."""
    k = KERNELS
    if kernel == "2C":
        return siren_cuda.siren_decode_batch(_torch_nets(k["decode"]), OMEGA, SEQ_LEN, compute_dtype=dtype)
    if kernel == "2D":
        kp, vp, *rest = k["attention"]
        return siren_attention_cuda.siren_attention_decode_fused(
            _torch_nets(kp), _torch_nets(vp), *map(torch.from_numpy, rest), OMEGA, SEQ_LEN, causal=k["causal"],
            compute_dtype=dtype)
    if kernel == "2E":
        return siren_quant_cuda.siren_decode_batch_quant(_torch_nets(k["decode"]), SCHEME, OMEGA, SEQ_LEN,
                                                         compute_dtype=dtype)
    kp, vp, *rest = k["quant_attention"]
    return siren_quant_cuda.siren_attention_decode_quant(
        _torch_nets(kp), _torch_nets(vp), *map(torch.from_numpy, rest), QUANT_SCHEME, OMEGA, SEQ_LEN,
        causal=False, return_stats=True, compute_dtype=dtype)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kernel", ["2C", "2D", "2E", "2F"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_sharded_kernel_equals_unsharded(worlds, world, kernel, dtype):
    got = worlds[world][f"{kernel} {str(dtype).split('.')[-1]}"]
    want = _unsharded(kernel, dtype)
    for g, w in zip(got if kernel == "2F" else [got], want if kernel == "2F" else [want]):
        np.testing.assert_array_equal(g, w.float().numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_2f_from_a_global_payload(worlds, world):
    """``packed=``: a whole batch's payload, each rank taking its rows of every operand."""
    np.testing.assert_array_equal(worlds[world]["2F packed"], _unsharded("2F", torch.float32)[0].numpy())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kernel", ["2C", "2D", "2E", "2F"])
def test_sharded_kernel_matches_jax(worlds, world, kernel):
    """JAX's *_sharded(..., interpret=True) over as many CPU devices, fp32."""
    mesh, k = _jax_mesh(world), KERNELS
    got = worlds[world][f"{kernel} float32"]
    if kernel == "2C":
        want = jax_decode_sharded([tuple(map(jnp.asarray, p)) for p in k["decode"]], OMEGA, SEQ_LEN, mesh,
                                  interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), **DECODE_TOL)
    elif kernel == "2E":
        want = jax_quant_decode_sharded([tuple(map(jnp.asarray, p)) for p in k["decode"]], SCHEME, OMEGA, SEQ_LEN,
                                        mesh, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), **DECODE_TOL)
    elif kernel == "2D":
        want = jax_attention_sharded(*to_jax(k["attention"]), OMEGA, SEQ_LEN, mesh, interpret=True,
                                     causal=k["causal"])
        np.testing.assert_allclose(got, np.asarray(want), **ATTENTION_TOL)
    else:
        o, m, l = jax_quant_attention_sharded(*to_jax(k["quant_attention"]), QUANT_SCHEME, OMEGA, SEQ_LEN, mesh,
                                              interpret=True, causal=False, return_stats=True)
        np.testing.assert_allclose(got[0], np.asarray(o), **ATTENTION_TOL)
        np.testing.assert_allclose(got[1] + np.log(got[2]), np.asarray(m) + np.log(np.asarray(l)), atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kernel", ["2C", "2D", "2E", "2F"])
def test_ragged_counts_are_refused(worlds, world, kernel):
    """6 nets or heads over 4 ranks, as JAX refuses; 6 over 2 divides."""
    message = worlds[world]["refusals"][kernel]
    if world == 4:
        assert "not divisible by mesh size 4" in message, message
    else:
        assert message == "not refused"


def _whole_batch_bytes(kernel: str) -> int:
    k = KERNELS
    if kernel == "2C":
        return sum(w.nbytes + b.nbytes for w, b in k["decode"])
    if kernel == "2D":
        return sum(w.nbytes + b.nbytes for p in k["attention"][:2] for w, b in p)
    if kernel == "2E":
        return siren_quant_cuda.resident_param_bytes(siren_quant_cuda.pack_resident_params(
            _torch_nets(k["decode"]), SCHEME)[0])
    return sum(siren_quant_cuda.resident_param_bytes(siren_quant_cuda.pack_resident_params(
        _torch_nets(p), QUANT_SCHEME)[0]) for p in k["quant_attention"][:2])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kernel", ["2C", "2D", "2E", "2F"])
def test_each_rank_holds_only_its_shard(worlds, world, kernel):
    """Every call a rank makes to the unsharded wrapper hands it 1/world of the nets' bytes (2C, 2D) or of the
    packed payload's (2E, 2F: the rank packs its own nets)."""
    share = _whole_batch_bytes(kernel) // world
    for rank, held in enumerate(worlds[world]["held"]):
        assert held[kernel] and all(b == share for b in held[kernel]), (rank, held[kernel], share)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kernel", ["2C", "2D", "2E", "2F"])
def test_resident_shards_equal_the_global_path(worlds, world, kernel):
    """Each rank's nets put on its device once (shard_stack, shard_packed) give the global operands' outputs bit
    for bit, fp32, and hold 1/world of the nets' or payload's bytes."""
    got, want = worlds[world]["resident"][kernel], worlds[world][f"{kernel} float32"]
    for g, w in zip(got if kernel == "2F" else [got], want if kernel == "2F" else [want]):
        np.testing.assert_array_equal(g, w)
    share = _whole_batch_bytes(kernel) // world
    assert [r[kernel] for r in worlds[world]["resident bytes"]] == [share] * world


OFF_THE_MESH = {
    "2C operands on another device": "an operand on meta was handed to a mesh on cpu",
    "2E operands on another device": "an operand on meta was handed to a mesh on cpu",
    "sweep targets on another device": "an operand on meta was handed to a mesh on cpu",
    "sweep on another device": "device cuda was asked for, but this rank of the mesh computes on cpu",
    "2C another rank's shard": "a shard of rank",
    "2E another rank's shard": "a shard of rank",
    "2D another batch's shard": "1 key and",
}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", OFF_THE_MESH)
def test_operands_off_the_mesh_are_refused(worlds, world, case):
    """Operands on another kind of device than the mesh's (meta stands for a card on this CPU mesh), an explicit
    device that is not the mesh's, and a resident shard of another rank or batch raise; nothing is copied across."""
    assert OFF_THE_MESH[case] in worlds[world]["off the mesh"][case]


# ---- the CLIs ----

def _records(path):
    """fit_results.json without the wall-clock field."""
    return [{k: v for k, v in r.items() if k != "train_time_seconds"} for r in json.loads(path.read_text())]


@pytest.fixture(scope="module")
def kv_dir(tmp_path_factory):
    kv = tmp_path_factory.mktemp("mesh_kv") / "kv"
    synthetic.generate_synthetic_kv(seq_len=64, num_layers=4, num_kv_heads=2, head_dim=8, output_dir=kv,
                                    verbose=False)
    return kv


def test_fit_mesh_writes_the_single_device_results(tmp_path, kv_dir):
    """fit --mesh on 2 Gloo ranks: one fit_results.json, equal to the single-device run's; the same medium
    checkpoints; a stamp that names the mesh."""
    argv = ["--device", "cpu", "--kv_dir", str(kv_dir), "--epochs", "5", "--quick", "--torch_checkpoints"]
    fit.main([*argv, "--output_dir", str(tmp_path / "single")])
    fit.main([*argv, "--output_dir", str(tmp_path / "mesh"), "--mesh", "--mesh_ranks", "2"])
    assert _records(tmp_path / "mesh" / "fit_results.json") == _records(tmp_path / "single" / "fit_results.json")
    files = sorted(p.name for p in (tmp_path / "mesh").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "single").iterdir())
    for name in files:
        if name.endswith(".npz"):
            a, b = (checkpoint.load_siren_checkpoint(tmp_path / d / name) for d in ("mesh", "single"))
            for (w, bias), (w0, bias0) in zip(a["params"], b["params"]):
                np.testing.assert_array_equal(w, w0)
                np.testing.assert_array_equal(bias, bias0)
    stamp = json.loads((tmp_path / "mesh" / "sweep_meta.json").read_text())
    assert stamp["mesh"] == {"ranks": 2, "backend": "gloo"}
    assert "mesh" not in json.loads((tmp_path / "single" / "sweep_meta.json").read_text())


def test_study_and_quickstart_mesh_write_the_single_device_sweep(tmp_path, monkeypatch):
    """study --mesh (extract and fit stages) and quickstart --mesh write the sweep their single-device runs do."""
    argv = ["--device", "cpu", "--seq_len", "64", "--synth_layers", "2", "--epochs", "3", "--skip", "evaluate",
            "experiments"]
    study.main([*argv, "--root", str(tmp_path / "single")])
    study.main([*argv, "--root", str(tmp_path / "mesh"), "--mesh", "--mesh_ranks", "2"])
    assert _records(tmp_path / "mesh" / "fits" / "fit_results.json") == _records(
        tmp_path / "single" / "fits" / "fit_results.json")
    for run in ("single", "mesh"):
        (tmp_path / f"qs_{run}").mkdir()
        monkeypatch.chdir(tmp_path / f"qs_{run}")
        quickstart.main(["--device", "cpu", "--epochs", "3", "--seq_len", "64",
                         *(["--mesh", "--mesh_ranks", "2"] if run == "mesh" else [])])
    fits = "results/fits_quick/fit_results.json"
    assert _records(tmp_path / "qs_mesh" / fits) == _records(tmp_path / "qs_single" / fits)


def test_full_layer_profile_mesh_writes_the_single_device_records(tmp_path, kv_dir):
    """run_full_layer_profile(mesh=) on 2 Gloo ranks (JAX's :464, :518): the 8 fits (head 0's keys and values of
    4 layers) sharded over the ranks return and write, once, the single-device run's records."""
    from nerf_attention_tpu_torch.experiments import scaling

    single = scaling.run_full_layer_profile(kv_dir, tmp_path / "single", epochs=5, verbose=False, device="cpu")
    sharded = port_mesh.run_on_mesh(torch_mesh_ranks.layer_profile, kv_dir, tmp_path / "mesh", 5, world_size=2,
                                    device="cpu")
    assert len(single) == 8 and sharded == single
    assert (json.loads((tmp_path / "mesh" / "full_layer_profile.json").read_text())
            == json.loads((tmp_path / "single" / "full_layer_profile.json").read_text()))
