"""Kernels 2A, 2B and 2C (with ``--attention`` also 2D, 2E and 2F) at fixed seeded shapes: outputs to hold two
checkouts to each other bit for bit, and 2B/2C's bf16 mode beside fp32.

    PYTHONPATH=<checkout> python nerf_attention_tpu_torch/tools/siren_kernel_outputs.py --out a.pt [--attention]
    python nerf_attention_tpu_torch/tools/siren_kernel_outputs.py --compare a.pt b.pt
    python nerf_attention_tpu_torch/tools/siren_kernel_outputs.py --modes

``--out``: every fp32 output at ``DECODE_CASES`` (2B/2C) and ``TRAIN_CASES``
(2A's loss and gradients), 2B/2C's bf16 mode at ``BF16_CASES`` (each beside
its plain version's output), and with ``--attention`` at ``ATTENTION_CASES``
(2D, 2F with its stats, 2E; fp32, and again in their bf16 modes, each beside
its plain version's output), saved with ``torch.save``. Run as a
file, it uses the kernels of whichever checkout ``PYTHONPATH`` names first, so
a parent commit unpacked by ``git archive`` is run by the same cases.
``--compare``: whether two such files are equal bit for bit, case by case of
the first (exit status 1 if any differs), and for each case saved beside its
plain version's output that either holds (an older checkout saved 2D's bf16
cases alone), each file's kernel output in ulps against that plain output: what
a case that changed on purpose is held to.
``--modes``: 2B/2C's bf16 mode at N 1, 40 and 512 (medium, S=2048), and with
``--attention`` the bf16 modes of 2E, 2F and 2D at ``ACT16_MODES`` (their table
shapes), against their plain versions in bf16 ulps of the largest |output|,
and each mode's time: the median of 3 samples of back-to-back calls between
CUDA events, per call. Inputs are random from fixed seeds; on the CPU the
wrappers run their plain versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren
from nerf_attention_tpu_torch.ops import siren_cuda, siren_train_cuda
from nerf_attention_tpu_torch.parallel.sweep import normalize_targets
from nerf_attention_tpu_torch.types import SIRENConfig
from nerf_attention_tpu_torch.utils.device import pin_fp32_matmul, resolve_device
from nerf_attention_tpu_torch.utils.timing import per_launch_ms

D = 128
# name: (hidden, hidden layers, nets, S, sine, FM multiplier)
DECODE_CASES = {
    "2B medium": (256, 2, 1, 2048, "exact", None),
    "2C medium N=40": (256, 2, 40, 2048, "exact", None),
    "2C medium N=40 fast": (256, 2, 40, 2048, "fast", None),
    "2C medium N=40 FM x64 S=300": (256, 2, 40, 300, "exact", 64.0),
    "2C medium N=512": (256, 2, 512, 2048, "exact", None),
    "2C large N=40": (512, 2, 40, 2048, "exact", None),
    "2C tiny N=40 fast": (64, 1, 40, 2048, "fast", None),
    "2C hidden 2048 N=8 S=300 (wide tile)": (2048, 1, 8, 300, "exact", None),
}
# name: (hidden, hidden layers, nets, S, sine) of 2B/2C's bf16 mode, saved with the plain version's output, so that
# a change of the kernel's sum order shows in ulps against it. Nets up to 256 wide take csrc/siren_decode_bf16.cu,
# `large` the layer stack (csrc/siren_decode.cu).
BF16_CASES = {
    "2B medium bf16": (256, 2, 1, 2048, "exact"),
    "2C medium N=40 bf16 fast": (256, 2, 40, 2048, "fast"),
    "2C tiny N=40 bf16": (64, 1, 40, 2048, "exact"),
    "2C large N=40 bf16 (layer stack)": (512, 2, 40, 2048, "exact"),
}
# name: (hidden, hidden layers, nets, S, sine)
TRAIN_CASES = {
    "2A medium N=40 fast": (256, 2, 40, 2048, "fast"),
    "2A medium N=40 exact": (256, 2, 40, 2048, "exact"),
    "2A large N=8 fast": (512, 2, 8, 2048, "fast"),
    "2A medium N=6 S=8192 fast": (256, 2, 6, 8192, "fast"),
}
# name: (heads, queries, S, causal, scheme or None for 2D[, (hidden, hidden layers)]); medium nets unless given,
# fast sine. 2E: "decode" in the name.
ATTENTION_CASES = {
    "2D N=8 S=2048 T=1": (8, 1, 2048, False, None),
    "2D N=8 S=32768 T=1": (8, 1, 32768, False, None),
    "2D N=8 S=2048 T=16 causal": (8, 16, 2048, True, None),
    "2F int4_g128 N=8 S=2048 T=1": (8, 1, 2048, False, "int4_g128"),
    "2F int8_g32 N=8 S=300 T=16 causal": (8, 16, 300, True, "int8_g32"),
    "2E decode int4_g128 N=40 S=2048": (40, 0, 2048, False, "int4_g128"),
    "2E decode int4_g128 small N=128 S=512": (128, 0, 512, False, "int4_g128", (128, 1)),
}
# The bf16 modes of the Hopper kernels over csrc/siren_wgmma.cuh timed by --modes --attention, at PERF.md's table
# shapes: name: (nets or heads, S, hidden, hidden layers); fast sine, 2E and 2F on int4_g128 weights, 2D on dense
# fp32 ones, 2F and 2D with T=1 over the whole window.
ACT16_MODES = {"2E small N=128 S=512": (128, 512, 128, 1), "2F medium N=8 S=2048 T=1": (8, 2048, 256, 2),
               "2D medium N=8 S=2048 T=1": (8, 2048, 256, 2)}
MODE_NETS = (1, 40, 512)
MODE_SHAPE = (256, 2, 2048)  # medium nets (hidden, hidden layers) at S=2048


def _stack(hidden: int, layers: int, n: int, device, seed: int) -> SirenStack:
    config = SIRENConfig(hidden, layers, 30.0, "case")
    cpu = SirenStack.from_params(init_siren(config, D, generator=torch.Generator().manual_seed(seed), n=n))
    return SirenStack(cpu.flat.to(device), cpu.dims)


def outputs(device) -> dict[str, list[torch.Tensor]]:
    """Every case's outputs (BF16_CASES beside their plain version's), on the host."""
    out = {}
    for i, (name, (hidden, layers, n, seq_len, sin_impl, fm)) in enumerate(DECODE_CASES.items()):
        stack = _stack(hidden, layers, n, device, seed=i)
        out[name] = [siren_cuda.siren_decode_batch(stack, 30.0, seq_len, sin_impl=sin_impl, fm_mult=fm).cpu()]
    for i, (name, (hidden, layers, n, seq_len, sin_impl)) in enumerate(BF16_CASES.items()):
        stack = _stack(hidden, layers, n, device, seed=600 + i)
        kw = dict(sin_impl=sin_impl, compute_dtype=torch.bfloat16)
        got = (siren_cuda.siren_decode(stack, 30.0, seq_len, **kw)[None] if n == 1
               else siren_cuda.siren_decode_batch(stack, 30.0, seq_len, **kw))
        out[name] = [got.cpu(), siren_cuda.siren_decode_plain(stack, 30.0, seq_len, **kw).cpu()]
    for i, (name, (hidden, layers, n, seq_len, sin_impl)) in enumerate(TRAIN_CASES.items()):
        stack = _stack(hidden, layers, n, device, seed=100 + i)
        targets = torch.randn(n, seq_len, D, generator=torch.Generator().manual_seed(200 + i)).to(device)
        loss, grads = siren_train_cuda.siren_train_grads(stack, normalize_targets(targets)[0].contiguous(),
                                                         omega=30.0, sin_impl=sin_impl)
        out[name] = [loss.cpu(), grads.flat.cpu()]
    return out


def attention_outputs(device) -> dict[str, list[torch.Tensor]]:
    """Every ``ATTENTION_CASES`` output in fp32 (2F's with its m and l), and in the bf16 mode (the name + " bf16",
    followed by its plain version's output), on the host."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda, siren_quant_cuda as sq

    out = {}
    for i, (name, (n, t, seq_len, causal, scheme, *widths)) in enumerate(ATTENTION_CASES.items()):
        hidden, layers = widths[0] if widths else (256, 2)
        gen = torch.Generator().manual_seed(400 + i)
        k, v = (_stack(hidden, layers, n, device, seed=500 + 2 * i + j) for j in range(2))
        stats = [(torch.rand(n, 1, D, generator=gen) + 0.5).to(device) for _ in range(4)]
        q = torch.randn(n, t, D, generator=gen).to(device)
        for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, " bf16")):
            bf16 = dtype == torch.bfloat16
            if "decode" in name:
                packed = sq.pack_resident_params(k.params(), scheme)
                kw = dict(sin_impl="fast", compute_dtype=dtype)
                out[name + suffix] = [sq.siren_decode_batch_quant(None, scheme, 30.0, seq_len, packed=packed,
                                                                  **kw).cpu()]
                if bf16:
                    out[name + suffix].append(sq.siren_decode_batch_quant_plain(packed, 30.0, seq_len, **kw).cpu())
                continue
            kw = dict(sin_impl="fast", causal=causal, compute_dtype=dtype)
            if scheme is None:
                out[name + suffix] = [siren_attention_cuda.siren_attention_decode_fused(k, v, *stats, q, 30.0, seq_len,
                                                                                        **kw).cpu()]
                if bf16:
                    out[name + suffix].append(siren_attention_cuda.siren_attention_decode_plain(
                        k, v, *stats, q, 30.0, seq_len, **kw).cpu())
            else:
                packed = tuple(sq.pack_resident_params(x.params(), scheme) for x in (k, v))
                out[name + suffix] = [x.cpu() for x in sq.siren_attention_decode_quant(
                    None, None, *stats, q, scheme, 30.0, seq_len, packed=packed, return_stats=True, **kw)]
                if bf16:
                    out[name + suffix].append(sq.siren_attention_decode_quant_plain(packed, *stats, q, 30.0, seq_len,
                                                                                   **kw).cpu())
    return out


def compare(a: dict, b: dict) -> dict[str, bool]:
    """Per case of ``a``: whether ``b`` holds the same tensors bit for bit."""
    return {name: name in b and all(torch.equal(x, y) for x, y in zip(a[name], b[name])) for name in a}


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in bf16 ulps of the largest |want| (2^-8 of it)."""
    return (got.float() - want.float()).abs().max().item() / (2.0**-8 * want.float().abs().max().item())


def _with_plain() -> list[str]:
    """The cases saved with their plain version's output last: BF16_CASES, and every attention case's bf16 mode."""
    return [*BF16_CASES, *(f"{name} bf16" for name in ATTENTION_CASES)]


def _plain(x: list[torch.Tensor], name: str) -> torch.Tensor | None:
    """A case's plain output, where the file saved it: last, after the kernel's outputs (2F's bf16: o, m, l)."""
    return x[-1] if len(x) > (3 if name.startswith("2F") else 1) else None


def against_plain(a: dict, b: dict) -> dict[str, tuple[float, float]]:
    """Per case with a plain version's output that both files hold, and that either saved beside it: each one's
    kernel output in ulps against that plain output."""
    out = {}
    for name in _with_plain():
        if name in a and name in b:
            plain = _plain(a[name], name) if _plain(a[name], name) is not None else _plain(b[name], name)
            if plain is not None:
                out[name] = (_ulps(a[name][0], plain), _ulps(b[name][0], plain))
    return out


def modes(device) -> list[dict]:
    """The bf16 mode against its plain version and beside fp32, at MODE_SHAPE."""
    hidden, layers, seq_len = MODE_SHAPE
    rows = []
    for n in MODE_NETS:
        stack = _stack(hidden, layers, n, device, seed=300 + n)
        bf16 = dict(compute_dtype=torch.bfloat16)
        got = siren_cuda.siren_decode_batch(stack, 30.0, seq_len, **bf16)
        want = siren_cuda.siren_decode_plain(stack, 30.0, seq_len, **bf16)
        fp32 = siren_cuda.siren_decode_batch(stack, 30.0, seq_len)
        ulp = 2.0**-8 * want.float().abs().max().item()
        row = {"nets": n, "ulps_vs_plain": (got.float() - want.float()).abs().max().item() / ulp,
               "ulps_vs_fp32": (got.float() - fp32).abs().max().item() / ulp}
        reps = (10 if n >= 512 else 50) if device.type == "cuda" else 1
        for sin_impl in ("exact", "fast"):
            for dtype in (torch.float32, torch.bfloat16):
                run = lambda: siren_cuda.siren_decode_batch(stack, 30.0, seq_len, sin_impl=sin_impl,
                                                            compute_dtype=dtype)
                row[f"{str(dtype)[6:]}_{sin_impl}_ms"] = float(np.median(per_launch_ms(run, reps, 3, device)))
        rows.append(row)
    return rows


def act16_modes(device) -> list[dict]:
    """The bf16 modes of 2E, 2F and 2D at ACT16_MODES against their plain versions, and their times beside their
    fp32 modes'."""
    from nerf_attention_tpu_torch.ops import siren_attention_cuda as sa
    from nerf_attention_tpu_torch.ops import siren_quant_cuda as sq

    rows = []
    for i, (name, (n, seq_len, hidden, layers)) in enumerate(ACT16_MODES.items()):
        k, v = (_stack(hidden, layers, n, device, seed=700 + 2 * i + j) for j in range(2))
        if name.startswith("2E"):
            packed = sq.pack_resident_params(k.params(), "int4_g128")
            call = lambda dtype: sq.siren_decode_batch_quant(  # noqa: E731
                None, "int4_g128", 30.0, seq_len, packed=packed, sin_impl="fast", compute_dtype=dtype)
            want = sq.siren_decode_batch_quant_plain(packed, 30.0, seq_len, sin_impl="fast",
                                                     compute_dtype=torch.bfloat16)
        else:
            gen = torch.Generator().manual_seed(800 + i)
            stats = [(torch.rand(n, 1, D, generator=gen) + 0.5).to(device) for _ in range(4)]
            q = torch.randn(n, 1, D, generator=gen).to(device)
            kw = dict(sin_impl="fast", causal=False)
            if name.startswith("2D"):
                call = lambda dtype: sa.siren_attention_decode_fused(  # noqa: E731
                    k, v, *stats, q, 30.0, seq_len, compute_dtype=dtype, **kw)
                want = sa.siren_attention_decode_plain(k, v, *stats, q, 30.0, seq_len, compute_dtype=torch.bfloat16,
                                                       **kw)
            else:
                packed = tuple(sq.pack_resident_params(x.params(), "int4_g128") for x in (k, v))
                call = lambda dtype: sq.siren_attention_decode_quant(  # noqa: E731
                    None, None, *stats, q, "int4_g128", 30.0, seq_len, packed=packed, compute_dtype=dtype, **kw)
                want = sq.siren_attention_decode_quant_plain(packed, *stats, q, 30.0, seq_len,
                                                             compute_dtype=torch.bfloat16, **kw)
        row = {"case": name, "ulps_vs_plain": _ulps(call(torch.bfloat16), want)}
        reps = 50 if device.type == "cuda" else 1
        for dtype in (torch.float32, torch.bfloat16):
            row[f"{str(dtype)[6:]}_ms"] = float(np.median(per_launch_ms(lambda: call(dtype), reps, 3, device)))
        rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=str, default=None, help="save every case's fp32 outputs here")
    parser.add_argument("--compare", type=str, nargs=2, default=None, metavar=("A", "B"))
    parser.add_argument("--modes", action="store_true", help="the bf16 modes against their plain versions and fp32")
    parser.add_argument("--attention", action="store_true",
                        help="--out also holds 2D, 2E and 2F's outputs, fp32 and bf16; --modes also times their "
                             "Hopper kernels' bf16 modes")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.compare:
        a, b = (torch.load(path) for path in args.compare)
        same = compare(a, b)
        for name, equal in same.items():
            print(f"{name}: bit-identical = {equal}")
        for name, (ulps_a, ulps_b) in against_plain(a, b).items():
            print(f"{name}: {ulps_a:.3f} / {ulps_b:.3f} bf16 ulps against the plain version")
        return 0 if all(same.values()) else 1
    device = resolve_device(args.device)
    pin_fp32_matmul()
    if args.out:
        saved = {**outputs(device), **(attention_outputs(device) if args.attention else {})}
        torch.save(saved, args.out)
        print(f"{len(saved)} cases saved to {args.out}")
    if args.modes:
        for row in modes(device) + (act16_modes(device) if args.attention else []):
            print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
