"""Attention from SIREN parameters: CUDA kernel 2D (``csrc/siren_attention.cuh``) and its plain twin.

``siren_attention_decode_fused`` computes, per head, the attention outputs
of T queries over an S-token window whose keys and values are the
denormalized outputs of a key net and a value net, as
``nerf_attention_tpu/ops/siren_attention_pallas.py`` does (kernel 2D). A
tensor on the CPU goes to ``siren_attention_decode_plain``, the two-pass
path (decode K-hat and V-hat, then ``attention_outputs``); a CUDA tensor
launches the kernel or raises. The launch helpers here also serve kernel 2F
(``ops/siren_quant_cuda.py``), which runs the same kernel over packed
weights.

``compute_dtype=torch.bfloat16`` is the JAX kernel's bf16 mode
(``siren_attention_pallas.py:_attn_kernel``): both nets' stacks in bf16 as
kernel 2B/2C's (weights, biases and activations rounded, fp32 sums), the
denormalized K and V, q.k and the softmax in fp32, then p and V rounded to
bf16 for p.V with fp32 sums; the output stays fp32. 2F's bf16 mode is the
same with the weights kept fp32 (``round_weights=False``). On the card, calls
that ``attention_route`` gives "wgmma" take the Hopper kernel of both bf16
modes, ``csrc/siren_attention_wgmma.cu`` (``wgmma_attention_launch``), for 2D
with one rounded bf16 piece a weight and one wgmma chain a product, counted in
``wgmma_launches``; other calls keep the layer stack's ``kBF16`` instance
(``siren_attention_bf16.cu``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nerf_attention_tpu_torch.experiments.attention_error import attention_outputs, causal_allowed
from nerf_attention_tpu_torch.models.siren import SirenStack
from nerf_attention_tpu_torch.ops import _build
from nerf_attention_tpu_torch.ops._launch import (
    MAX_LAYERS,
    STACK_TILE_ROWS,
    as_stack,
    chunking,
    multipliers,
    stack_records,
    wave_rows,
)
from nerf_attention_tpu_torch.ops.fastmath import resolve_sin
from nerf_attention_tpu_torch.models.siren import positions
from nerf_attention_tpu_torch.ops.siren_cuda import (
    PREC_ACT16,
    PREC_BF16,
    PREC_F32,
    WGMMA_TILE_ROWS,
    bf16_route,
    precision,
    round_bf16,
    siren_apply_bf16,
    siren_decode_plain,
)

# Launches of the CUDA kernel; plain evaluations are not counted.
launches = {"siren_attention_decode_fused": 0}
# Of those, the launches in the bf16 mode, and of these the ones csrc/siren_attention_wgmma.cu took.
bf16_launches = {"siren_attention_decode_fused": 0}
wgmma_launches = {"siren_attention_decode_fused": 0}

EMPTY_M = -1e30  # m reported for a query row that nothing attends


# The kernel's library for each arithmetic (csrc/siren_attention.cuh built three times, so the builds run in
# parallel): fp32, 2D's bf16 mode, 2F's bf16 mode.
LIBRARIES = {PREC_F32: "siren_attention", PREC_BF16: "siren_attention_bf16", PREC_ACT16: "siren_attention_act16"}


@functools.cache
def _library(prec: int = PREC_F32) -> ctypes.CDLL:
    lib = _build.load_library(LIBRARIES[prec])
    lib.siren_attention_launch.restype = ctypes.c_int
    lib.siren_attention_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 12
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 6
        + [ctypes.c_void_p]
    )
    lib.siren_attention_blocks_per_sm.restype = ctypes.c_int
    lib.siren_attention_blocks_per_sm.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    lib.siren_attention_scratch_floats.restype = ctypes.c_int
    lib.siren_attention_scratch_floats.argtypes = [ctypes.c_int] * 4
    return lib


def _check_queries(seq_len: int, n_queries: int, causal: bool) -> None:
    if causal and n_queries > seq_len:
        raise ValueError(f"{n_queries} causal queries do not fit a window of {seq_len}")


def query_mask(seq_len: int, n_queries: int, causal: bool, device) -> torch.Tensor:
    """(T, S) bool: which window positions each query row attends."""
    _check_queries(seq_len, n_queries, causal)
    if not causal:
        return torch.ones(n_queries, seq_len, dtype=torch.bool, device=device)
    return torch.from_numpy(causal_allowed(seq_len, n_queries)).to(device)


def softmax_stats(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, l) of masked logits (-inf where masked): the max and sum exp(s - m)
    over the last axis. Where nothing attends, m = -1e30 and l = 0."""
    m = logits.amax(dim=-1)
    some = m > float("-inf")
    m = torch.where(some, m, 0.0)
    l = torch.exp(logits - m.unsqueeze(-1)).sum(dim=-1)
    return torch.where(some, m, EMPTY_M), l


def _attention_bf16(k_params, v_params, k_mean, k_std, v_mean, v_std, q, omega, seq_len, sin_impl, fm_mult,
                    allowed, round_weights):
    """The bf16 mode's two passes: K-hat and V-hat from the bf16 stacks (fp32, unrounded),
    fp32 scores and softmax, p.V on bf16-rounded p and V with fp32 sums. Returns (out, masked logits)."""
    stacks = [p.params() if isinstance(p, SirenStack) else p for p in (k_params, v_params)]
    x = positions(seq_len, device=q.device)
    sin = resolve_sin(sin_impl)
    k_hat, v_hat = (siren_apply_bf16(p, omega, fm_mult, x, sin, round_weights) * std + mean
                    for p, mean, std in zip(stacks, (k_mean, v_mean), (k_std, v_std)))
    logits = torch.where(allowed, (q * (1.0 / math.sqrt(q.shape[-1]))) @ k_hat.transpose(-2, -1), float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(m > float("-inf"), m, 0.0))
    return (round_bf16(p) @ round_bf16(v_hat)) / p.sum(dim=-1, keepdim=True), logits


def siren_attention_decode_plain(k_params, v_params, k_mean, k_std, v_mean, v_std, q, omega: float,
                                 seq_len: int, *, sin_impl: str = "fast", fm_mult: float | None = None,
                                 causal: bool = True, return_stats: bool = False, compute_dtype=torch.float32,
                                 round_weights: bool = True):
    """Two-pass attention from parameters: K-hat and V-hat, then ``attention_outputs``.

    ``k_params`` / ``v_params``: ``SirenStack`` or [(W (N, in, out), b (N, out)), ...];
    ``k_mean`` .. ``v_std``: (N, 1, D); ``q``: (N, T, D) queries for the
    window's last T positions. Returns (N, T, D) fp32, and with ``return_stats``
    also the softmax max m and denominator l, each (N, T). ``compute_dtype``
    bf16: the bf16 mode (the module's note), ``round_weights=False`` 2F's.
    """
    if precision(compute_dtype, round_weights) != PREC_F32:
        allowed = query_mask(seq_len, q.shape[1], causal, q.device)
        out, logits = _attention_bf16(k_params, v_params, k_mean, k_std, v_mean, v_std, q, omega, seq_len,
                                      sin_impl, fm_mult, allowed, round_weights)
        return (out, *softmax_stats(logits)) if return_stats else out
    k_hat = siren_decode_plain(k_params, omega, seq_len, sin_impl=sin_impl, fm_mult=fm_mult) * k_std + k_mean
    v_hat = siren_decode_plain(v_params, omega, seq_len, sin_impl=sin_impl, fm_mult=fm_mult) * v_std + v_mean
    allowed = query_mask(seq_len, q.shape[1], causal, q.device)
    out = attention_outputs(q, k_hat, v_hat, allowed)[0]
    if not return_stats:
        return out
    logits = (q @ k_hat.transpose(-2, -1)) / math.sqrt(q.shape[-1])
    return (out, *softmax_stats(torch.where(allowed, logits, float("-inf"))))


@functools.cache
def plan(n: int, seq_len: int, t: int, hidden: int, d: int, fast: bool, device_index: int,
         tiles: tuple[int, ...] = STACK_TILE_ROWS, *, prec: int = PREC_F32):
    """(tile rows, chunks, tiles per chunk, scratch floats a block): for each
    tile of ``tiles`` that fits with the arithmetic ``prec``, the chunk count that fills the card in whole
    waves (``chunking``); then the tile whose blocks cost the fewest rows an
    SM (``wave_rows``). A function of the shapes alone, so 2D and 2F cut a
    problem the same way."""
    lib = _library(prec)
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    best = None
    for rows in tiles:
        per_sm = ctypes.c_int(0)
        _build.check(lib, lib.siren_attention_blocks_per_sm(t, hidden, d, rows, int(fast), prec, per_sm),
                     "siren_attention_blocks_per_sm")
        if per_sm.value > 0:
            chunks, rows_per_chunk = chunking(n, seq_len, rows, per_sm.value * sms)
            cost = wave_rows(n * chunks, per_sm.value * sms, rows_per_chunk // rows, rows)
            if best is None or cost < best[0]:
                best = (cost, rows, chunks, rows_per_chunk // rows,
                        lib.siren_attention_scratch_floats(t, hidden, d, rows))
    if best is None:
        raise ValueError(f"{t} queries with hidden width {hidden} need more shared memory than a block has")
    return best[1:]


def _flat_stat(x: torch.Tensor, n: int, d: int, device) -> torch.Tensor:
    if x.device != device or x.dtype != torch.float32:
        raise ValueError("denormalization stats must be float32 on the queries' device")
    return x.reshape(n, d).contiguous()


def attention_launch(k_records: list[int], v_records: list[int], n_layers: int, hidden: int,
                     k_mean, k_std, v_mean, v_std, q: torch.Tensor, omega: float, seq_len: int, *,
                     sin_impl: str, fm_mult: float | None, causal: bool, return_stats: bool,
                     tiles: tuple[int, ...] = STACK_TILE_ROWS, compute_dtype=torch.float32,
                     round_weights: bool = True):
    """Launch csrc/siren_attention.cuh's kernel over two described net stacks (2D or 2F).

    ``tiles``: the row tiles the launch may pick from (one, to time a tile alone).
    ``compute_dtype`` bf16: 2D's bf16 mode, or 2F's with ``round_weights=False``.
    """
    prec = precision(compute_dtype, round_weights)
    if not 2 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 2 to {MAX_LAYERS} layers, got {n_layers}")
    resolve_sin(sin_impl)  # validates the name
    n, t, d = q.shape
    device = q.device
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError("q must be contiguous float32")
    _check_queries(seq_len, t, causal)
    stats = [_flat_stat(x, n, d, device) for x in (k_mean, k_std, v_mean, v_std)]
    fast = sin_impl == "fast"
    rows, chunks, tiles_per_chunk, scratch_floats = plan(n, seq_len, t, hidden, d, fast, device.index or 0, tiles,
                                                         prec=prec)
    mult = multipliers(hidden, fm_mult, device)
    part_ml = torch.empty(n, chunks, t, 2, dtype=torch.float32, device=device)
    part_acc = torch.empty(n, chunks, t, d, dtype=torch.float32, device=device)
    scratch = torch.empty(n * chunks * scratch_floats, dtype=torch.float32, device=device) if scratch_floats else None
    out = torch.empty(n, t, d, dtype=torch.float32, device=device)
    m = torch.empty(n, t, dtype=torch.float32, device=device) if return_stats else None
    l = torch.empty(n, t, dtype=torch.float32, device=device) if return_stats else None
    k_desc = (ctypes.c_longlong * len(k_records))(*k_records)
    v_desc = (ctypes.c_longlong * len(v_records))(*v_records)
    lib = _library(prec)
    status = lib.siren_attention_launch(
        k_desc, v_desc, n_layers, *(s.data_ptr() for s in stats), q.data_ptr(),
        None if mult is None else mult.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(),
        n, seq_len, t, hidden, d, float(omega), float(1.0 / math.sqrt(d)), int(fast), prec, int(causal),
        rows, chunks, tiles_per_chunk, torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(lib, status, "siren_attention_launch")
    return (out, m, l) if return_stats else out


# csrc/siren_attention_wgmma.cu: kMaxQueries and kMaxHeadDim (its partial scores and V tile).
WGMMA_MAX_QUERIES, WGMMA_MAX_HEAD_DIM = 16, 128


def attention_route(hidden: int, d: int, n_queries: int) -> str:
    """The kernel of 2D's and 2F's bf16 modes for nets of these widths and ``n_queries`` queries: ``"wgmma"``
    (csrc/siren_attention_wgmma.cu) where ``bf16_route`` takes the nets, ``d`` is at most
    ``WGMMA_MAX_HEAD_DIM`` and ``n_queries`` at most ``WGMMA_MAX_QUERIES``, else ``"stack"``
    (the layer stack: siren_attention_bf16.cu, siren_attention_act16.cu)."""
    fits = d <= WGMMA_MAX_HEAD_DIM and n_queries <= WGMMA_MAX_QUERIES
    return "wgmma" if fits and bf16_route(hidden, d) == "wgmma" else "stack"


def bind_wgmma_attention(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of csrc/siren_attention_wgmma.cu, with its entry points' C types set."""
    lib.siren_attention_wgmma_pieces_bytes.restype = ctypes.c_longlong
    lib.siren_attention_wgmma_pieces_bytes.argtypes = [ctypes.c_int] * 5
    lib.siren_attention_wgmma_launch.restype = ctypes.c_int
    lib.siren_attention_wgmma_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.siren_attention_wgmma_smem.restype = ctypes.c_int
    lib.siren_attention_wgmma_smem.argtypes = [ctypes.c_int] * 3
    return lib


@functools.cache
def _wgmma_attention_library() -> ctypes.CDLL:
    return bind_wgmma_attention(_build.load_library("siren_attention_wgmma"))


@functools.cache
def _wgmma_attention_plan(n: int, seq_len: int, device_index: int) -> tuple[int, int]:
    """(chunks, tiles per chunk) of a launch of n heads over seq_len rows: one block an SM (its shared memory), tiles
    of ``WGMMA_TILE_ROWS`` rows, cut as the layer stack's attention launches are (``chunking``)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    chunks, rows_per_chunk = chunking(n, seq_len, WGMMA_TILE_ROWS, sms)
    return chunks, rows_per_chunk // WGMMA_TILE_ROWS


def _pieces(lib: ctypes.CDLL, hidden: int, d: int, n_layers: int, n: int, round_weights: bool,
            device) -> torch.Tensor:
    """The device area the launch's split pass writes the 2n nets' bf16 weight pieces into."""
    return torch.empty(lib.siren_attention_wgmma_pieces_bytes(hidden, d, n_layers, n, int(round_weights)),
                       dtype=torch.uint8, device=device)


def wgmma_attention_launch(k_records: list[int], v_records: list[int], n_layers: int, hidden: int,
                           k_mean, k_std, v_mean, v_std, q: torch.Tensor, omega: float, seq_len: int, *,
                           sin_impl: str, fm_mult: float | None, causal: bool, return_stats: bool,
                           round_weights: bool):
    """Launch csrc/siren_attention_wgmma.cu over two described net stacks: (N, T, D) fp32, with (m, l) when asked.
    ``round_weights``: 2D's bf16 mode (one rounded piece a weight), else 2F's (three exact pieces). The caller counts
    the launch."""
    resolve_sin(sin_impl)  # validates the name
    n, t, d = q.shape
    device = q.device
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError("q must be contiguous float32")
    _check_queries(seq_len, t, causal)
    stats = [_flat_stat(x, n, d, device) for x in (k_mean, k_std, v_mean, v_std)]
    chunks, tiles_per_chunk = _wgmma_attention_plan(n, seq_len, device.index or 0)
    lib = _wgmma_attention_library()
    pieces = _pieces(lib, hidden, d, n_layers, n, round_weights, device)
    mult = multipliers(hidden, fm_mult, device)
    part_ml = torch.empty(n, chunks, t, 2, dtype=torch.float32, device=device)
    part_acc = torch.empty(n, chunks, t, d, dtype=torch.float32, device=device)
    out = torch.empty(n, t, d, dtype=torch.float32, device=device)
    m = torch.empty(n, t, dtype=torch.float32, device=device) if return_stats else None
    l = torch.empty(n, t, dtype=torch.float32, device=device) if return_stats else None
    k_desc = (ctypes.c_longlong * len(k_records))(*k_records)
    v_desc = (ctypes.c_longlong * len(v_records))(*v_records)
    status = lib.siren_attention_wgmma_launch(
        k_desc, v_desc, n_layers, *(s.data_ptr() for s in stats), q.data_ptr(),
        None if mult is None else mult.data_ptr(), pieces.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
        n, seq_len, t, hidden, d, float(omega), float(1.0 / math.sqrt(d)), int(sin_impl == "fast"),
        int(round_weights), int(causal), chunks, tiles_per_chunk, torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(lib, status, "siren_attention_wgmma_launch")
    return (out, m, l) if return_stats else out


def siren_attention_decode_fused(k_params, v_params, k_mean, k_std, v_mean, v_std, q, omega: float,
                                 seq_len: int, *, sin_impl: str = "fast", fm_mult: float | None = None,
                                 causal: bool = True, compute_dtype=torch.float32) -> torch.Tensor:
    """Kernel 2D: (N, T, D) fp32 attention outputs straight from SIREN parameters.

    Arguments as ``siren_attention_decode_plain``. Query row t sits at
    position S - T + t; ``causal`` lets it attend to positions up to its
    own, otherwise every row attends to the whole window. ``compute_dtype``:
    torch.float32 or torch.bfloat16 (the module's note).
    """
    precision(compute_dtype)  # validates the type
    k_stack, v_stack = as_stack(k_params), as_stack(v_params)
    if k_stack.dims != v_stack.dims:
        raise ValueError(f"key and value nets must share their layers: {k_stack.dims} vs {v_stack.dims}")
    if q.device.type == "cpu":
        return siren_attention_decode_plain(k_stack, v_stack, k_mean, k_std, v_mean, v_std, q, omega,
                                            seq_len, sin_impl=sin_impl, fm_mult=fm_mult, causal=causal,
                                            compute_dtype=compute_dtype)
    if k_stack.flat.device != q.device or v_stack.flat.device != q.device:
        raise ValueError("params and queries must be on the same device")
    hidden, d_out, n_layers = k_stack.dims[0][1], k_stack.dims[-1][1], len(k_stack.dims)
    records = (stack_records(k_stack), stack_records(v_stack), n_layers, hidden)
    kw = dict(sin_impl=sin_impl, fm_mult=fm_mult, causal=causal, return_stats=False)
    if compute_dtype == torch.bfloat16 and attention_route(hidden, d_out, q.shape[1]) == "wgmma":
        out = wgmma_attention_launch(*records, k_mean, k_std, v_mean, v_std, q, omega, seq_len, round_weights=True,
                                     **kw)
        wgmma_launches["siren_attention_decode_fused"] += 1
    else:
        out = attention_launch(*records, k_mean, k_std, v_mean, v_std, q, omega, seq_len, compute_dtype=compute_dtype,
                               **kw)
    launches["siren_attention_decode_fused"] += 1
    bf16_launches["siren_attention_decode_fused"] += compute_dtype == torch.bfloat16
    return out


def siren_attention_decode(k_params, v_params, k_mean, k_std, v_mean, v_std, q, omega: float,
                           seq_len: int, sin_impl: str = "fast", fm_mult: float | None = None,
                           causal: bool = True, compute_dtype=torch.float32) -> torch.Tensor:
    """Attention from parameters on the queries' device: the plain version on
    the CPU, kernel 2D on a GPU (the JAX package's interpret fallback has no
    counterpart: a CUDA tensor launches the kernel or raises)."""
    return siren_attention_decode_fused(k_params, v_params, k_mean, k_std, v_mean, v_std, q, omega,
                                        seq_len, sin_impl=sin_impl, fm_mult=fm_mult, causal=causal,
                                        compute_dtype=compute_dtype)
