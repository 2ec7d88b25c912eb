"""SIREN training step: CUDA kernel 2A (``csrc/siren_train.cu``) and its plain twin.

``siren_train_grads`` returns the per-fit MSE loss and every parameter
gradient of N SIRENs, as ``nerf_attention_tpu/ops/siren_train_pallas.py:
siren_train_grads`` does. A tensor on the CPU goes to
``siren_train_grads_plain`` (``torch.autograd`` over the plain forward); a
CUDA tensor launches the kernel or raises. The kernel is a fixed sequence of
tensor-core products (3xTF32, fp32 accumulation) through one workspace that
this wrapper allocates; it takes hidden widths that are multiples of 64 and 3
to 8 layers.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nerf_attention_tpu_torch.models.siren import SirenStack, positions, siren_apply_maybe_fm
from nerf_attention_tpu_torch.ops import _build
from nerf_attention_tpu_torch.ops._launch import as_stack, check_stack, multipliers
from nerf_attention_tpu_torch.ops.fastmath import resolve_sin

# Launches of the CUDA kernel (one per step); plain evaluations are not counted.
launches = {"siren_train_grads": 0}

MAX_LAYERS = 8  # csrc/siren_train.cu: kMaxLayers


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("siren_train")
    lib.siren_train_workspace.restype = ctypes.c_longlong
    lib.siren_train_workspace.argtypes = [ctypes.c_int] * 6
    lib.siren_train_launch.restype = ctypes.c_int
    lib.siren_train_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def check_train_shape(hidden: int, d_out: int, n_layers: int) -> None:
    """Raise on a network the kernel does not take (it never falls back)."""
    if hidden % 64 or d_out % 4 or not 3 <= n_layers <= MAX_LAYERS:
        raise ValueError(
            f"kernel 2A takes hidden widths that are multiples of 64, out widths that are multiples of 4 and "
            f"3-{MAX_LAYERS} layers; got hidden {hidden}, out {d_out}, {n_layers} layers"
        )


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _as_input_kind(params, grads: SirenStack):
    """Gradients in the form the parameters came in: a stack, or [(dW, db), ...]."""
    if isinstance(params, SirenStack):
        return grads
    return [(dw.clone(), db.clone()) for dw, db in grads.params()]


def siren_train_grads_plain(params, targets_norm: torch.Tensor, *, omega: float,
                            sin_impl: str = "exact", fm_mult: float | None = None):
    """Loss (N,) and gradients by autograd over the plain forward.

    ``params``: a ``SirenStack`` or [(W (N, in, out), b (N, out)), ...];
    ``targets_norm``: (N, S, D). The loss is mean((f(x) - t)^2) per fit.
    """
    stack = as_stack(params)
    with torch.enable_grad():
        flat = stack.flat.detach().requires_grad_(True)
        leaf = stack.with_flat(flat)
        x = positions(targets_norm.shape[1], device=flat.device)
        pred = siren_apply_maybe_fm(leaf.params(), omega, fm_mult, x, sin=resolve_sin(sin_impl))
        loss = ((pred - targets_norm) ** 2).mean(dim=(1, 2))
        (grad,) = torch.autograd.grad(loss.sum(), flat)
    return loss.detach(), _as_input_kind(params, stack.with_flat(grad))


def siren_train_grads(params, targets_norm: torch.Tensor, *, omega: float,
                      sin_impl: str = "exact", fm_mult: float | None = None):
    """Kernel 2A: loss (N,) and gradients shaped like ``params``.

    ``params``: a ``SirenStack`` (gradients come back as a stack) or
    [(W (N, in, out), b (N, out)), ...]; ``targets_norm``: (N, S, D)
    z-normalized targets on the same device.
    """
    stack = as_stack(params)
    if stack.flat.device.type == "cpu":
        return siren_train_grads_plain(
            params, targets_norm, omega=omega, sin_impl=sin_impl, fm_mult=fm_mult
        )
    hidden, d_out, n_layers = check_stack(stack)
    resolve_sin(sin_impl)  # validates the name
    n, seq_len = stack.n, targets_norm.shape[1]
    if targets_norm.shape != (n, seq_len, d_out):
        raise ValueError(f"targets {tuple(targets_norm.shape)} do not match {n} nets of width {d_out}")
    if (targets_norm.device != stack.flat.device or targets_norm.dtype != torch.float32
            or not targets_norm.is_contiguous()):
        raise ValueError("targets must be contiguous float32 on the params' device")
    check_train_shape(hidden, d_out, n_layers)
    if stack.flat.data_ptr() % 16:
        raise ValueError("params must start on a 16-byte boundary")
    device = stack.flat.device
    lib = _library()
    sms = _sms(device.index if device.index is not None else torch.cuda.current_device())
    floats = lib.siren_train_workspace(n, seq_len, hidden, d_out, n_layers, sms)
    if floats < 0:
        raise ValueError(f"kernel 2A does not take {n} fits of {seq_len} rows")
    mult = multipliers(hidden, fm_mult, device)
    workspace = torch.empty(floats, dtype=torch.float32, device=device)
    grads = torch.empty_like(stack.flat)
    loss = torch.empty(n, dtype=torch.float32, device=device)
    status = lib.siren_train_launch(
        stack.flat.data_ptr(), targets_norm.data_ptr(), None if mult is None else mult.data_ptr(),
        workspace.data_ptr(), grads.data_ptr(), loss.data_ptr(),
        n, seq_len, hidden, d_out, n_layers, float(omega), int(sin_impl == "fast"), sms,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(lib, status, "siren_train_launch")
    launches["siren_train_grads"] += 1
    return loss, _as_input_kind(params, stack.with_flat(grads))
