"""SIREN kernels over quantized-resident parameters: 2E (decode) and 2F (attention), with their plain twins.

``pack_resident_params`` lays a batched parameter list out as the device
operands of ``nerf_attention_tpu/ops/siren_quant_pallas.py``, byte for byte:
int8 codes, int4 nibble planes (byte r holds row r in its low nibble and
row r + ceil(R/2) in its high one), int6 as a nibble plane plus a quarter
plane of the top two bits, fp32 arrays holding fp16-valued group scales,
and layer 0 and every bias as dequantized fp32. Both kernels dequantize
each weight slab as it is staged, through the loaders of ``csrc/siren_common.cuh``:

* ``siren_decode_batch_quant`` (kernel 2E, ``csrc/siren_decode.cu``, the
  kernel of 2C) evaluates the N packed nets at linspace(0, 1, S), as kernel
  2C does for fp32 nets; on the CPU it goes to
  ``siren_decode_batch_quant_plain``, the host dequant followed by
  ``siren_decode_plain``.
* ``siren_attention_decode_quant`` (kernel 2F, ``csrc/siren_attention.cuh``)
  computes attention from a packed key net and value net; on the CPU it
  goes to ``siren_attention_decode_quant_plain``, the host dequant followed
  by ``siren_attention_decode_plain``.

A CUDA tensor launches the kernel or raises.

``compute_dtype=torch.bfloat16`` is the JAX kernels' bf16 mode over packed
weights: their weight views hand the layer stack fp32 values
(``siren_quant_pallas.py:_QuantWeightView``), so the weights and biases stay
fp32 and only the activations are rounded to bf16 after each sine; 2E
returns bf16, 2F rounds p and V to bf16 for p.V and returns fp32. So 2F in
bf16 on packed weights equals 2F in bf16 on the host-dequantized weights
shipped dense (``scheme="fp32"``) bit for bit, not 2D's bf16 mode, which
rounds the weights too. On the card, nets that ``bf16_route`` gives
"wgmma" (2F: ``siren_attention_cuda.attention_route``) take the Hopper
kernels of this mode, ``csrc/siren_decode_act16.cu`` (2E) and
``csrc/siren_attention_wgmma.cu`` (2F, launched by
``siren_attention_cuda.wgmma_attention_launch``): each weight split into
three exact bf16 pieces (``csrc/siren_wgmma.cuh``), wgmma products, counted
in ``wgmma_launches``; other nets keep the layer stack's ``kAct16`` instance.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nerf_attention_tpu_torch.ops import _build
from nerf_attention_tpu_torch.ops._launch import check_dims, layer_record, multipliers
from nerf_attention_tpu_torch.ops.fastmath import resolve_sin
from nerf_attention_tpu_torch.ops.quantize import parse_scheme, quantize_params, split_scheme
from nerf_attention_tpu_torch.ops.siren_attention_cuda import (
    attention_launch,
    attention_route,
    siren_attention_decode_plain,
    wgmma_attention_launch,
)
from nerf_attention_tpu_torch.ops.siren_cuda import (
    bf16_route,
    decode_launch,
    precision,
    siren_decode_plain,
    wgmma_chunking,
)
from nerf_attention_tpu_torch.utils.device import resolve_device

# Launches of each CUDA kernel; plain evaluations are not counted.
launches = {"siren_decode_batch_quant": 0, "siren_attention_decode_quant": 0}
# Of those, the launches in the bf16 mode, and of these the ones the Hopper kernels of that mode took
# (csrc/siren_decode_act16.cu, csrc/siren_attention_wgmma.cu).
bf16_launches = {"siren_decode_batch_quant": 0, "siren_attention_decode_quant": 0}
wgmma_launches = {"siren_decode_batch_quant": 0, "siren_attention_decode_quant": 0}

_OPS_PER_LAYER = {"dense": 2, "int8": 3, "int4": 3, "int6": 4}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pack_nibble_planes(biased: np.ndarray) -> np.ndarray:
    """(N, R, C) biased codes (0..15) -> (N, ceil(R/2), C) int8: byte r holds
    code r (low nibble) and code r + ceil(R/2) (high nibble)."""
    n, r, c = biased.shape
    rh = _ceil_div(r, 2)
    padded = np.zeros((n, 2 * rh, c), np.uint8)
    padded[:, :r] = biased
    return (padded[:, :rh] | (padded[:, rh:] << 4)).astype(np.int8)


def _pack_quarter_planes(two_bit: np.ndarray) -> np.ndarray:
    """(N, R, C) 2-bit fields -> (N, ceil(R/4), C) int8: byte r holds rows
    r, r + Rq, r + 2 Rq, r + 3 Rq at bit offsets 0, 2, 4, 6."""
    n, r, c = two_bit.shape
    rq = _ceil_div(r, 4)
    padded = np.zeros((n, 4 * rq, c), np.uint8)
    padded[:, :r] = two_bit
    planes = [padded[:, p * rq:(p + 1) * rq] for p in range(4)]
    return (planes[0] | (planes[1] << 2) | (planes[2] << 4) | (planes[3] << 6)).astype(np.int8)


def _numpy(x) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pack_resident_params(params, scheme: str, *, device=None) -> tuple[list[torch.Tensor], tuple]:
    """Quantize batched params [(W (N, R, C), b (N, C)), ...] into resident operands.

    The grid is ``ops/quantize.py:quantize_params`` applied per network.
    Returns ``(ops, layout)``: per layer the packed codes, scales and bias
    (or the fp32 weight and bias), on ``device`` (default: the params'
    device), and the layout tuple of the JAX packer, entry by entry.
    """
    if device is None:
        device = params[0][0].device if isinstance(params[0][0], torch.Tensor) else "cpu"
    kind, bits, group = parse_scheme(scheme)
    _, l0fp32 = split_scheme(scheme)
    arrays = [(_numpy(w), _numpy(b)) for w, b in params]
    n = arrays[0][0].shape[0]
    per_net = [quantize_params([(w[i], b[i]) for w, b in arrays], scheme) for i in range(n)]

    ops: list[np.ndarray | torch.Tensor] = []
    layout: list[tuple] = []
    for li, (w, _) in enumerate(arrays):
        r, c = w.shape[1], w.shape[2]
        dq_w = np.stack([per_net[i][1][li][0] for i in range(n)]).astype(np.float32)
        dq_b = np.stack([per_net[i][1][li][1] for i in range(n)]).astype(np.float32).reshape(n, 1, c)
        if not (kind == "int" and group is not None and not (l0fp32 and li == 0) and r > 1):
            # Float schemes, layer 0 and per-channel int8 ship their dequantized values.
            dense = torch.from_numpy(dq_w).to(torch.bfloat16) if kind == "bf16" else dq_w
            ops += [dense, dq_b]
            layout.append(("dense", r, c))
            continue
        qmax = (1 << (bits - 1)) - 1
        codes = np.stack([per_net[i][0][li][0]["data"].reshape(-1, c)[:r] for i in range(n)]).astype(np.int8)
        scale = np.stack([per_net[i][0][li][0]["scale"] for i in range(n)]).astype(np.float32)
        biased = (codes.astype(np.int16) + qmax).astype(np.uint8)
        if bits == 4:
            ops.append(_pack_nibble_planes(biased))
            layout.append(("int4", r, c, group, qmax))
        elif bits == 6:
            ops += [_pack_nibble_planes(biased & 0xF), _pack_quarter_planes(biased >> 4)]
            layout.append(("int6", r, c, group, qmax))
        else:  # 8 bits, and 2/3/5/7-bit grids as byte-aligned codes
            ops.append(codes)
            layout.append(("int8", r, c, group, qmax))
        ops += [scale, dq_b]
    tensors = [(o if isinstance(o, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(o))).to(device)
               for o in ops]
    return tensors, tuple(layout)


def resident_param_bytes(ops) -> int:
    """Device bytes the packed operands occupy (codes + scales + biases)."""
    return int(sum(o.numel() * o.element_size() for o in ops))


def _layers(ops, layout):
    """(entry, [operands]) per layer."""
    pos = 0
    for entry in layout:
        k = _OPS_PER_LAYER[entry[0]]
        yield entry, list(ops[pos:pos + k])
        pos += k


def _expand_rows(scale: torch.Tensor, group: int, rows: int) -> torch.Tensor:
    """(..., G, C) group scales -> (..., rows, C)."""
    return scale.repeat_interleave(group, dim=-2)[..., :rows, :]


def unpack_resident_params(ops, layout) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The fp32 params the packed operands hold: [(W (N, R, C), b (N, C)), ...].

    code * scale in fp32, so the values equal ``quantize_params``'s dequant
    bit for bit.
    """
    params = []
    for entry, layer_ops in _layers(ops, layout):
        bias = layer_ops[-1]
        n, c = bias.shape[0], bias.shape[-1]
        if entry[0] == "dense":
            params.append((layer_ops[0].to(torch.float32), bias.reshape(n, c)))
            continue
        _, rows, _, group, qmax = entry
        if entry[0] == "int8":
            codes = layer_ops[0].to(torch.int32)
        else:
            u = layer_ops[0].to(torch.int32) & 0xFF
            low = torch.cat([u & 0xF, u >> 4], dim=1)[:, :rows]
            if entry[0] == "int6":
                u2 = layer_ops[1].to(torch.int32) & 0xFF
                low = low | (torch.cat([(u2 >> (2 * p)) & 0x3 for p in range(4)], dim=1)[:, :rows] << 4)
            codes = low - qmax
        w = codes.to(torch.float32) * _expand_rows(layer_ops[-2], group, rows)
        params.append((w, bias.reshape(n, c)))
    return params


def packed_records(ops, layout, device) -> tuple[list[int], list[torch.Tensor]]:
    """LayerDescs of csrc/siren_common.cuh for packed operands on ``device``
    (``resolve_device``'s reading), and the tensors they point into (kept
    alive by the caller through the launch)."""
    device = resolve_device(device)
    records, keep = [], []
    for li, (entry, layer_ops) in enumerate(_layers(ops, layout)):
        layer_ops = [o.to(torch.float32) if o.dtype == torch.bfloat16 else o for o in layer_ops]
        for o in layer_ops:
            if o.device != device or not o.is_contiguous():
                raise ValueError("packed operands must be contiguous on the queries' device")
        keep += layer_ops
        kind, rows, cols = entry[:3]
        if li == 0 and kind != "dense":
            raise ValueError("layer 0 must ship as dense fp32")
        # Per-net strides: a contiguous (N, ...) operand's first stride (no per-call views of net 0).
        bias = layer_ops[-1]
        if kind == "dense":
            w = layer_ops[0]
            records += layer_record(kind, rows, cols, w.data_ptr(), w.stride(0), bias.data_ptr(), bias.stride(0))
            continue
        group, qmax = entry[3:]
        codes, scale = layer_ops[0], layer_ops[-2]
        extra = {}
        if kind == "int6":
            extra = dict(w2=layer_ops[1].data_ptr(), w2_stride=layer_ops[1].stride(0))
        records += layer_record(kind, rows, cols, codes.data_ptr(), codes.stride(0), bias.data_ptr(),
                                 bias.stride(0), group=group, qmax=qmax, scale=scale.data_ptr(),
                                 scale_stride=scale.stride(0), **extra)
    return records, keep


def resident_records(packed, device) -> tuple[list[int], list[int], list[torch.Tensor]]:
    """``(k_records, v_records, keep)`` of a ``(k_packed, v_packed)`` pair: the
    LayerDescs kernel 2F reads, built once for calls that reuse the payload
    (``siren_attention_decode_quant(records=)``), and the tensors they point
    into, which the caller keeps alive as long as the records."""
    (k_ops, k_layout), (v_ops, v_layout) = packed
    if [e[1:3] for e in k_layout] != [e[1:3] for e in v_layout]:
        raise ValueError("key and value nets must share their layers")
    k_records, k_keep = packed_records(k_ops, k_layout, device)
    v_records, v_keep = packed_records(v_ops, v_layout, device)
    return k_records, v_records, k_keep + v_keep


def bind_act16(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of csrc/siren_decode_act16.cu, with its entry points' C types set."""
    lib.siren_act16_pieces_bytes.restype = ctypes.c_longlong
    lib.siren_act16_pieces_bytes.argtypes = [ctypes.c_int] * 4
    lib.siren_decode_act16_launch.restype = ctypes.c_int
    lib.siren_decode_act16_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


@functools.cache
def _act16_library() -> ctypes.CDLL:
    return bind_act16(_build.load_library("siren_decode_act16"))


@functools.cache
def _act16_plan(n: int, seq_len: int, device_index: int) -> tuple[int, int]:
    """(chunks, tiles per chunk) of a launch of n nets over seq_len rows, as 2B/2C's bf16 kernel's
    (``wgmma_chunking``)."""
    return wgmma_chunking(n, seq_len, torch.cuda.get_device_properties(device_index).multi_processor_count)


def _pieces(lib: ctypes.CDLL, hidden: int, d_out: int, n_layers: int, nets: int, device) -> torch.Tensor:
    """The device area the launch's split pass writes every net's bf16 weight pieces into."""
    return torch.empty(lib.siren_act16_pieces_bytes(hidden, d_out, n_layers, nets), dtype=torch.uint8, device=device)


def act16_decode_launch(records: list[int], n_layers: int, n: int, hidden: int, d_out: int, device: torch.device,
                        omega: float, seq_len: int, sin_impl: str, fm_mult: float | None) -> torch.Tensor:
    """Launch csrc/siren_decode_act16.cu (2E's bf16 mode on Hopper) over n described nets: (n, seq_len, d_out)
    bf16. The caller counts the launch."""
    resolve_sin(sin_impl)  # validates the name
    if seq_len < 1:
        raise ValueError(f"seq_len must be positive, got {seq_len}")
    chunks, tiles_per_chunk = _act16_plan(n, seq_len, device.index or 0)
    lib = _act16_library()
    pieces = _pieces(lib, hidden, d_out, n_layers, n, device)
    mult = multipliers(hidden, fm_mult, device)
    out = torch.empty(n, seq_len, d_out, dtype=torch.bfloat16, device=device)
    desc = (ctypes.c_longlong * len(records))(*records)
    status = lib.siren_decode_act16_launch(
        desc, n_layers, None if mult is None else mult.data_ptr(), pieces.data_ptr(), out.data_ptr(), n, seq_len,
        hidden, d_out, float(omega), int(sin_impl == "fast"), chunks, tiles_per_chunk,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(lib, status, "siren_decode_act16_launch")
    return out


def _decode_dims(layout) -> tuple[int, int, int]:
    """(H, D, L) of a packed SIREN stack kernel 2E takes; raises on anything else."""
    return check_dims([tuple(entry[1:3]) for entry in layout])


def siren_decode_batch_quant_plain(packed, omega: float, seq_len: int, *, sin_impl: str = "exact",
                                   fm_mult: float | None = None, compute_dtype=torch.float32) -> torch.Tensor:
    """Host dequant of the packed nets, then ``siren_decode_plain``: (N, seq_len, D) in ``compute_dtype``."""
    return siren_decode_plain(unpack_resident_params(*packed), omega, seq_len, sin_impl=sin_impl, fm_mult=fm_mult,
                              compute_dtype=compute_dtype, round_weights=False)


def siren_decode_batch_quant(params, scheme: str, omega: float, seq_len: int, *, sin_impl: str = "exact",
                             fm_mult: float | None = None, packed=None, compute_dtype=torch.float32) -> torch.Tensor:
    """Kernel 2E: N SIRENs at linspace(0, 1, seq_len) with the packed ``scheme`` payload resident.

    Arguments as the JAX package's ``siren_decode_batch_quant``: ``params``
    [(W (N, in, out), b (N, out)), ...], or None with ``packed``, a prior
    ``pack_resident_params`` result. Returns (N, seq_len, D) in ``compute_dtype``
    (fp32: equal bit for bit to kernel 2C on the host-dequantized weights; bf16:
    the module's note). Layer 0 must ship dense (every packer scheme does).
    """
    precision(compute_dtype)  # validates the type
    if packed is None:
        packed = pack_resident_params(params, scheme)
    ops, layout = packed
    device = ops[0].device
    if device.type == "cpu":
        return siren_decode_batch_quant_plain(packed, omega, seq_len, sin_impl=sin_impl, fm_mult=fm_mult,
                                              compute_dtype=compute_dtype)
    hidden, d_out, n_layers = _decode_dims(layout)
    records, keep = packed_records(ops, layout, device)
    if compute_dtype == torch.bfloat16 and bf16_route(hidden, d_out) == "wgmma":
        out = act16_decode_launch(records, n_layers, ops[0].shape[0], hidden, d_out, device, omega, seq_len,
                                  sin_impl, fm_mult)
        wgmma_launches["siren_decode_batch_quant"] += 1
    else:
        out = decode_launch(records, n_layers, ops[0].shape[0], hidden, d_out, device, omega, seq_len, sin_impl,
                            fm_mult, compute_dtype=compute_dtype, round_weights=False)
    del keep  # the launch is queued on the stream; the caching allocator holds the blocks
    launches["siren_decode_batch_quant"] += 1
    bf16_launches["siren_decode_batch_quant"] += compute_dtype == torch.bfloat16
    return out


def siren_attention_decode_quant_plain(packed, k_mean, k_std, v_mean, v_std, q, omega: float,
                                       seq_len: int, *, sin_impl: str = "fast",
                                       fm_mult: float | None = None, causal: bool = True,
                                       return_stats: bool = False, compute_dtype=torch.float32):
    """Host dequant of both packed nets, then ``siren_attention_decode_plain`` (in bf16 with
    the weights left fp32)."""
    (k_ops, k_layout), (v_ops, v_layout) = packed
    return siren_attention_decode_plain(
        unpack_resident_params(k_ops, k_layout), unpack_resident_params(v_ops, v_layout),
        k_mean, k_std, v_mean, v_std, q, omega, seq_len, sin_impl=sin_impl, fm_mult=fm_mult,
        causal=causal, return_stats=return_stats, compute_dtype=compute_dtype, round_weights=False,
    )


def siren_attention_decode_quant(k_params, v_params, k_mean, k_std, v_mean, v_std, q, scheme: str,
                                 omega: float, seq_len: int, *, sin_impl: str = "fast",
                                 fm_mult: float | None = None, causal: bool = True, packed=None,
                                 return_stats: bool = False, records=None, compute_dtype=torch.float32):
    """Kernel 2F: attention from parameters with the packed ``scheme`` payload resident.

    Arguments as ``siren_attention_decode_fused``; ``packed`` is a prior
    ``(pack_resident_params(k), pack_resident_params(v))`` (then the params
    may be None), ``records`` its prior ``resident_records`` on q's device.
    With ``return_stats`` returns ``(o, m, l)``, m and l (N, T) the softmax
    max and denominator, enough to merge further attention columns exactly.
    ``compute_dtype``: torch.float32 or torch.bfloat16 (the module's note).
    """
    precision(compute_dtype)  # validates the type
    if packed is None:
        packed = (pack_resident_params(k_params, scheme, device=q.device),
                  pack_resident_params(v_params, scheme, device=q.device))
    kw = dict(sin_impl=sin_impl, fm_mult=fm_mult, causal=causal, return_stats=return_stats,
              compute_dtype=compute_dtype)
    if q.device.type == "cpu":
        return siren_attention_decode_quant_plain(packed, k_mean, k_std, v_mean, v_std, q, omega, seq_len,
                                                  **kw)
    k_layout = packed[0][1]
    k_records, v_records, keep = resident_records(packed, q.device) if records is None else records
    hidden, d_out, n_layers = _decode_dims(k_layout)
    if compute_dtype == torch.bfloat16 and attention_route(hidden, d_out, q.shape[1]) == "wgmma":
        del kw["compute_dtype"]
        result = wgmma_attention_launch(k_records, v_records, n_layers, hidden, k_mean, k_std, v_mean, v_std, q,
                                        omega, seq_len, round_weights=False, **kw)
        wgmma_launches["siren_attention_decode_quant"] += 1
    else:
        result = attention_launch(k_records, v_records, n_layers, hidden, k_mean, k_std, v_mean, v_std, q, omega,
                                  seq_len, round_weights=False, **kw)
    del keep  # the launch is queued on the stream; the caching allocator holds the blocks
    launches["siren_attention_decode_quant"] += 1
    bf16_launches["siren_attention_decode_quant"] += compute_dtype == torch.bfloat16
    return result
