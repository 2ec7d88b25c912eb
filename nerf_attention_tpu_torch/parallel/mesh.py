"""The fit mesh: one process a device on a ``torch.distributed`` process group, SPMD.

The port of ``nerf_attention_tpu/parallel/mesh.py``. JAX runs one program
over every chip from a single controller; here every rank is its own
process, calls each sharded function with the same global inputs, computes
only its own rows on its own device, and all-gathers the global result
(``gather_rows``), which every rank returns. That is what JAX's sharded
functions return as global arrays. The tensor-parallel Llama
(``models/llama.shard_llama_params``) also sums its ranks' partial outputs
(``all_reduce_sum``), the collectives GSPMD inserts in JAX.

The mesh is a 1-D ``DeviceMesh`` named ``"fit"`` over the default process
group: NCCL on cards (rank r on ``cuda:r``), Gloo on the CPU. A Gloo group
can also hold ranks that share one card (NCCL refuses two ranks on one
device); its collectives are staged through host memory, decided by the
group's backend before any collective runs. ``run_on_mesh`` starts the
ranks for a CLI run without ``torchrun``, or runs in place under it.
``shard_map_compat`` is JAX's and has no counterpart.

Operands lie on the mesh's kind of device: a rank never moves one from a
card to a CPU mesh (where the plain version would run in place of the
kernel) nor, at every call, from the host to its card. Weights that serve
many calls go to the card once, as the rank's ``LocalShard``
(``siren_cuda.shard_stack``, ``siren_quant_cuda.shard_packed``), which the
sharded functions take in place of the global operand.
"""

from __future__ import annotations

import collections
import datetime
import multiprocessing
import multiprocessing.connection
import os
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist

FIT_AXIS = "fit"
# How long a rank waits in a collective for the others before the group raises (a rank that died leaves the others
# waiting there): rank 0 writes a sweep's files while the others wait at a barrier.
DEFAULT_TIMEOUT_S = 1800
# torchrun's environment: a process it started joins the group it describes instead of starting ranks.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# This process's calls of each collective (gather_rows, all_reduce_sum), world of one included.
collectives: collections.Counter = collections.Counter()


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n (fit batches pad up to the mesh)."""
    return ((n + k - 1) // k) * k


def fit_mesh(devices: list[int] | None = None, axis_name: str = FIT_AXIS, device_type: str | None = None):
    """A 1-D ``DeviceMesh`` over the default process group's ranks (or the ranks ``devices``) for the fit axis.

    Every rank of the group calls it. ``device_type`` defaults to ``"cuda"``
    on an NCCL group and ``"cpu"`` on a Gloo one; a Gloo group whose ranks
    share a card passes ``"cuda"``.
    """
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("fit_mesh needs an initialized process group: start the ranks with run_on_mesh or torchrun")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if devices is None:
        return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))
    return DeviceMesh(device_type, torch.tensor(list(devices)), mesh_dim_names=(axis_name,))


def mesh_device(mesh, device=None) -> torch.device:
    """The device this rank computes on: the CPU, or the card ``run_on_mesh`` (or torchrun) made current.
    ``device``, a caller's explicit device, must be that one (its index, if it names one): else this raises."""
    own = torch.device("cpu") if mesh.device_type == "cpu" else torch.device("cuda", torch.cuda.current_device())
    if device is not None:
        asked = torch.device(device)
        if asked.type != own.type or asked.index not in (None, own.index):
            raise ValueError(f"device {asked} was asked for, but this rank of the mesh computes on {own}")
    return own


def local_rows(n: int, mesh) -> slice:
    """The rows of an N-row batch this rank owns (N divisible by the mesh size): JAX's ``shard_batch``."""
    check_divisible(n, mesh, "row count")
    per = n // mesh.size()
    return slice(mesh.get_local_rank() * per, (mesh.get_local_rank() + 1) * per)


def check_on_mesh(x, mesh, *, from_host: bool = False) -> None:
    """Refuse an operand (a tensor or array) on another kind of device than the mesh's; ``from_host`` also
    takes one on the host, for a caller that places its rows on the rank's device once."""
    kind = x.device.type if isinstance(x, torch.Tensor) else "cpu"
    if kind != mesh.device_type and not (from_host and kind == "cpu"):
        raise ValueError(f"an operand on {kind} was handed to a mesh on {mesh.device_type}: put the global "
                         f"operands on {mesh.device_type}"
                         + (", or this rank's weights there once as its LocalShard" if kind == "cpu" else ""))


def local_shard(x, mesh, *, from_host: bool = False) -> torch.Tensor:
    """This rank's rows of ``x`` (a global tensor or array on the mesh's kind of device, or with ``from_host`` on
    the host; its leading axis divisible by the mesh), alone on the rank's device."""
    check_on_mesh(x, mesh, from_host=from_host)
    x = torch.as_tensor(x)
    return x[local_rows(x.shape[0], mesh)].to(mesh_device(mesh)).contiguous()


@dataclass(frozen=True)
class LocalShard:
    """One rank's rows of a batch of weights, already on the rank's device: the sharded functions take it in
    place of the global operand and copy nothing of it."""

    value: object
    rank: int
    world: int

    @classmethod
    def of(cls, value, mesh) -> "LocalShard":
        return cls(value, mesh.get_local_rank(), mesh.size())

    def on(self, mesh):
        """The shard's value, if it was made for this rank of this mesh (else this raises)."""
        if (self.rank, self.world) != (mesh.get_local_rank(), mesh.size()):
            raise ValueError(f"a shard of rank {self.rank} of {self.world} was handed to rank "
                             f"{mesh.get_local_rank()} of {mesh.size()}")
        return self.value


def check_divisible(n: int, mesh, what: str) -> None:
    """JAX's refusal of a ragged shard: ``n`` (``what``, e.g. "network count") must divide evenly over the mesh."""
    world = mesh.size()
    if n % world:
        raise ValueError(f"{what} {n} not divisible by mesh size {world}")


def _host_parts(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    """Every rank's ``x`` on the host, in rank order, gathered by a Gloo group as bytes (Gloo has no bf16 gather,
    and ranks that share a card must not hand Gloo a CUDA tensor)."""
    flat = x.contiguous().cpu().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(mesh.size())]
    dist.all_gather(parts, flat, group=mesh.get_group())
    return [p.view(x.dtype).reshape(x.shape) for p in parts]


def gather_rows(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along ``dim`` in rank order, on every rank.

    NCCL gathers on the card (``all_gather_into_tensor``); a Gloo group
    gathers the shards' bytes in host memory and copies the result back to
    ``x``'s device, whatever its dtype.
    """
    collectives["gather_rows"] += 1
    world = mesh.size()
    group = mesh.get_group()
    x = x.contiguous()
    if dist.get_backend(group) == "gloo":
        return torch.cat(_host_parts(x, mesh), dim=dim).to(x.device)
    out = torch.empty(world * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    if dim == 0:  # rank order is row order: no copy
        return out.view(world * x.shape[0], *x.shape[1:])
    return torch.cat(out.view(world, *x.shape).unbind(0), dim=dim)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the ranks of every rank's ``x`` (the same shape and dtype on each), in ``x``'s dtype, the same
    bits on every rank: tensor parallelism's partial sums.

    NCCL reduces on the card (``all_reduce``), where every rank receives the
    bits one reduction made. A Gloo group gathers the partials in host memory
    and adds them there in rank order, each rank the same numbers in the same
    order, then copies the sum back to ``x``'s device.
    """
    collectives["all_reduce_sum"] += 1
    if dist.get_backend(mesh.get_group()) == "gloo":
        parts = _host_parts(x, mesh)
        total = parts[0].clone()
        for part in parts[1:]:
            total += part
        return total.to(x.device)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.get_group())
    return out


def barrier(mesh) -> None:
    """Every rank of the mesh waits for the others (rank 0 writes; the others wait here)."""
    dist.barrier(group=mesh.get_group())


def _setup_rank(device: str, local_rank: int, backend: str, **init) -> None:
    """Join the group as one rank: the card first (NCCL binds a rank to the current device), then the group."""
    if device.startswith("cuda"):
        index = torch.device(device).index
        torch.cuda.set_device(local_rank if index is None else index)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    if backend == "nccl":  # bound to its card now, not guessed from the rank at the first collective
        init["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S), **init)


def _device_type(device: str) -> str:
    return "cpu" if device == "cpu" else "cuda"


def _rank_main(rank: int, world: int, init_method: str, backend: str, device: str, fn, args, kwargs,
               result_path: str) -> None:
    """One spawned rank: join the group, run ``fn(mesh, *args, **kwargs)``, rank 0 saves its result (an exception
    prints its traceback and exits the process with 1)."""
    try:
        _setup_rank(device, rank, backend, init_method=init_method, rank=rank, world_size=world)
        mesh = fit_mesh(device_type=_device_type(device))
        result = fn(mesh, *args, **kwargs)
        if rank == 0:
            torch.save(result, result_path)
        barrier(mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def resolve_world(device: str, world_size: int | None) -> tuple[int, str]:
    """(ranks, backend) of a run on ``device``: one NCCL rank a visible card by default; Gloo on the CPU, where
    the rank count must be given, and for ranks that share one named card (``"cuda:0"``)."""
    if device == "cpu":
        if world_size is None:
            raise ValueError("a mesh on the CPU needs its rank count (world_size / --mesh_ranks)")
        return world_size, "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} was requested for the mesh but torch.cuda.is_available() is False; "
                           "pass device='cpu' (--device cpu) with a rank count to run the mesh on the CPU")
    if torch.device(device).index is not None:
        if world_size is None:
            raise ValueError(f"ranks sharing {device} need their count (world_size / --mesh_ranks)")
        return world_size, "gloo"  # NCCL refuses two ranks on one card
    cards = torch.cuda.device_count()
    world_size = cards if world_size is None else world_size
    if world_size > cards:
        raise ValueError(f"{world_size} NCCL ranks need as many cards; this machine has {cards}")
    return world_size, "nccl"


def run_on_mesh(fn, *args, world_size: int | None = None, device: str = "cuda", **kwargs):
    """``fn(mesh, *args, **kwargs)`` on every rank of a fit mesh; returns rank 0's result (this rank's under
    torchrun).

    ``device``: ``"cuda"`` starts one NCCL rank a visible card (or
    ``world_size`` of them), rank r on ``cuda:r``; ``"cuda:<i>"`` starts
    ``world_size`` Gloo ranks that share card i; ``"cpu"`` ``world_size``
    Gloo ranks on the CPU. The ranks are spawned processes that meet at a
    file-store rendezvous in a new temporary directory; ``fn`` and the
    arguments are pickled to them (``fn`` by import path), and rank 0's
    result comes back through a file. If one rank fails, the others are
    ended and this raises; a rank waiting in a collective for a rank that
    died raises after ``DEFAULT_TIMEOUT_S``. Under torchrun this process is one rank:
    it joins the group torchrun describes (NCCL, rank on ``cuda:LOCAL_RANK``,
    or Gloo for ``device="cpu"``) and runs ``fn`` in place.
    """
    if all(key in os.environ for key in TORCHRUN_ENV):
        if not dist.is_initialized():
            backend = "gloo" if device == "cpu" else "nccl"
            if backend == "nccl" and not torch.cuda.is_available():
                raise RuntimeError("torchrun started this rank for the card, but torch.cuda.is_available() is False")
            _setup_rank(device, int(os.environ["LOCAL_RANK"]), backend, init_method="env://")
        if world_size is not None and world_size != dist.get_world_size():
            raise ValueError(f"{world_size} ranks asked for, torchrun started {dist.get_world_size()}")
        return fn(fit_mesh(device_type=_device_type(device)), *args, **kwargs)

    world, backend = resolve_world(device, world_size)
    ctx = multiprocessing.get_context("spawn")
    tmp = Path(tempfile.mkdtemp(prefix="fit_mesh_"))
    result_path = tmp / "result.pt"
    procs = [ctx.Process(target=_rank_main, name=f"fit-mesh-rank-{rank}",
                         args=(rank, world, f"file://{tmp / 'rendezvous'}", backend, device, fn, args, kwargs,
                               str(result_path)))
             for rank in range(world)]
    try:
        for p in procs:
            p.start()
        pending = list(procs)
        while pending:
            multiprocessing.connection.wait([p.sentinel for p in pending])
            for p in [p for p in pending if not p.is_alive()]:
                p.join()
                pending.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(f"{p.name} of {world} ({backend}, {device}) exited with {p.exitcode}; "
                                       "the other ranks were ended")
        return torch.load(result_path, weights_only=False)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
