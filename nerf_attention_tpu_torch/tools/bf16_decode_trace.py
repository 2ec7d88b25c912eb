"""Where the bf16 modes' Hopper kernels spend a tile, on the GPU: 2B/2C's (``csrc/siren_decode_bf16.cu``), 2E's
(``csrc/siren_decode_act16.cu``), and 2F's and 2D's (``csrc/siren_attention_wgmma.cu``: three pieces a weight, or
one rounded piece).

Builds a copy of the kernel with clock stamps (``clock64``) added at fixed
points of its source and of the shared ``csrc/siren_wgmma.cuh``
(``HEADER_ANCHORS``, ``KERNELS``' own anchors), runs it once at its table
shape through its wrapper, and reads the stamps of block (0, 0) back. For each
consumer warpgroup (its thread 0), in SM cycles a tile, averaged over the
block's tiles:

  * ``layer0``: layer 0 (SIMT, its sines, into the A fragments), of every net
    a tile runs (2D, 2F: the key net's and the value net's);
  * ``wait``: from a chunk's start to its last ``wgmma`` issued: waiting on
    the ring's ``full`` barriers for the chunk's weight pieces (``full_wait``,
    that part alone), and issuing while the tensor cores run its earlier
    ``wgmma``; ``wait_first_tile`` the same in the block's first tile alone,
    ``wait_later_tiles`` the mean of the others;
  * ``wgmma``: from the commit to the group's completion;
  * ``epilogue``: bias, omega, sine, bf16 and repacking (the last layer: its
    stores, or 2D's and 2F's scores and V rows);
  * ``between``: from a net's last layer to the next net's layer 0: between
    tiles, and in 2D and 2F the attention's own steps (the softmax, p.V, barriers);
  * ``total``: the warpgroup's first stamp to its last.

And for the producer's warp 0 (thread 0 of block (0, 0)), ``copies_back``:
the copies it issued after waiting on a stage's ``empty`` barrier (2B/2C: its
copies back from ``keep``; 2D, 2E, 2F: every copy of a ready piece) and the
cycles it waited on each. The stamps cost a few instructions at each point, so
the traced kernel's ms is printed beside the committed one's.

    python -m nerf_attention_tpu_torch.tools.bf16_decode_trace [--kernel 2C|2D|2E|2F] [--nets N] [--seq_len S]
        [--sine exact|fast]

Defaults: 2C the medium aggregate (512 nets, S=2048, exact sine); 2E 128
`small` nets at S=512, int4_g128, fast sine (the plan path's shape); 2F 8
medium heads at S=2048, T=1, int4_g128, fast sine (the attention ladder's);
2D the same heads over their dense fp32 weights (phase 3's timing shape).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json

import numpy as np
import torch

TRACE_SLOTS = 64
WG_SLOTS = 16  # each consumer warpgroup's counters, WG_SLOTS apart
STAMPED = "if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x == 128 || threadIdx.x == 256))"
WG = "(threadIdx.x == 256 ? 16 : 0)"
PRODUCER = "if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)"
HEADER = "siren_wgmma.cuh"


def _tile_start(first: str) -> str:
    """The stamp at a net's start in a tile: the warpgroup's first stamp, else the time since its last one."""
    return (f"{STAMPED} {{ const long long t = clock64(); if ({first}) g_trace[4 + {WG}] = t; "
            f"else g_trace[6 + {WG}] += t - g_trace[5 + {WG}]; }}\n")


# (text of the source, what it becomes): each text occurs once in its file. Counter i + WG of a consumer
# warpgroup: 0 wait, 1 wgmma, 2 epilogue, 3 layer 0, 4 first stamp, 5 last stamp, 6 between, 8 wait in the first
# tile, 9 the part of wait spent in `full` barrier waits; producer: 40 cycles waited on `empty` before its copies,
# 41 their count.
HEADER_ANCHORS = (
    ("namespace bf16wg {\n", f"namespace bf16wg {{\n__device__ long long g_trace[{TRACE_SLOTS}];\n"),
    ("    int r0 = 0, r1 = 0;\n",
     "    int r0 = 0, r1 = 0;\n    long long ta = 0, tb = 0, tc = 0;\n    bool ft = false;\n"),
    ("                        mbar_wait(full + pc % STAGES, (pc / STAGES) & 1);\n",
     "                        { const long long tw = clock64(); mbar_wait(full + pc % STAGES, (pc / STAGES) & 1);\n"
     f"                          {STAMPED} {{ g_trace[9 + {WG}] += clock64() - tw; }} }}\n"),
    ("            fence_acc(acc);\n#pragma unroll\n            for (int sp",
     f"            {STAMPED} {{ ta = clock64(); if (c > 0) g_trace[2 + {WG}] += ta - tc; }}\n"
     "            fence_acc(acc);\n#pragma unroll\n            for (int sp"),
    ("            wgmma_commit();\n            wgmma_wait<0>();\n",
     f"            {STAMPED} {{ tb = clock64(); g_trace[0 + {WG}] += tb - ta; "
     f"if (ft) g_trace[8 + {WG}] += tb - ta; }}\n"
     "            wgmma_commit();\n            wgmma_wait<0>();\n"
     f"            {STAMPED} {{ tc = clock64(); g_trace[1 + {WG}] += tc - tb; }}\n"),
    ("        p += nch * SPLITS * KA;\n",
     f"        {STAMPED} {{ const long long t = clock64(); g_trace[2 + {WG}] += t - tc; g_trace[5 + {WG}] = t; }}\n"
     "        p += nch * SPLITS * KA;\n"),
    ("        first(a);\n",
     f"        {STAMPED} {{ ta = clock64(); }}\n        first(a);\n"
     f"        {STAMPED} {{ g_trace[3 + {WG}] += clock64() - ta; }}\n"),
    ("            rows(L, a, an, acc, out);\n",
     _tile_start("tile == t_lo") + "            ft = tile == t_lo;\n            rows(L, a, an, acc, out);\n"),
    ("        mbar_wait(empty + s, ((p / STAGES) & 1) ^ 1);\n",
     "        { const long long t0 = clock64(); mbar_wait(empty + s, ((p / STAGES) & 1) ^ 1);\n"
     f"          {PRODUCER} {{ g_trace[40] += clock64() - t0; g_trace[41] += 1; }} }}\n"),
)
# Per kernel: its source and the anchors of that source.
KERNELS = {
    "2C": dict(source="siren_decode_bf16.cu", anchors=(
        ("                mbar_wait(empty + s, ((p / kStages) & 1) ^ 1);\n"
         "                mbar_arrive_expect(full + s, kStageBytes);",
         "                { const long long t0 = clock64(); mbar_wait(empty + s, ((p / kStages) & 1) ^ 1);\n"
         f"                  {PRODUCER} {{ g_trace[40] += clock64() - t0; "
         "g_trace[41] += 1; } }\n                mbar_arrive_expect(full + s, kStageBytes);"),)),
    "2E": dict(source="siren_decode_act16.cu", anchors=()),
    "2F": dict(source="siren_attention_wgmma.cu", anchors=(
        ("            c.rows(L, a, an, acc, out);\n",
         _tile_start("ti == lo && which == 0")
         + "            c.ft = ti == lo;\n            c.rows(L, a, an, acc, out);\n"),)),
}
KERNELS["2D"] = KERNELS["2F"]  # one kernel, one rounded piece a weight
# Each kernel's library: the wrapper module, its cached loader and its binder.
LIBRARIES = {"2C": ("siren_cuda", "_wgmma_library", "bind_wgmma"),
             "2E": ("siren_quant_cuda", "_act16_library", "bind_act16"),
             "2F": ("siren_attention_cuda", "_wgmma_attention_library", "bind_wgmma_attention")}
LIBRARIES["2D"] = LIBRARIES["2F"]
READERS = f"""
extern "C" int read_trace(long long* host) {{
    return (int)cudaMemcpyFromSymbol(host, bf16wg::g_trace, sizeof(long long) * {TRACE_SLOTS});
}}
extern "C" int zero_trace() {{
    long long z[{TRACE_SLOTS}] = {{0}};
    return (int)cudaMemcpyToSymbol(bf16wg::g_trace, z, sizeof(z));
}}
"""


def _instrument(text: str, anchors, name: str) -> str:
    for old, new in anchors:
        if text.count(old) != 1:
            raise ValueError(f"anchor found {text.count(old)} times in {name}: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def instrumented_sources(kernel: str = "2C") -> dict[str, str]:
    """{file name: text} of the kernel's source and the shared header with the clock stamps in; raises if an anchor
    is not found exactly once."""
    from nerf_attention_tpu_torch.ops import _build

    spec = KERNELS[kernel]
    header = _instrument((_build.CSRC_DIR / HEADER).read_text(), HEADER_ANCHORS, HEADER)
    source = _instrument((_build.CSRC_DIR / spec["source"]).read_text(), spec["anchors"], spec["source"])
    return {HEADER: header, spec["source"]: source + READERS}


def build(kernel: str = "2C") -> ctypes.CDLL:
    """The traced kernel, built into the package's build directory (its traced header beside its source, so that
    the source's include finds it first)."""
    from nerf_attention_tpu_torch.ops import _build

    folder = _build.BUILD_DIR / "trace" / kernel
    folder.mkdir(parents=True, exist_ok=True)
    for name, text in instrumented_sources(kernel).items():
        (folder / name).write_text(text)
    source = folder / KERNELS[kernel]["source"]
    target = folder / f"{source.stem}_trace.so"
    partial = target.with_name(f"{target.name}.tmp")
    _build._compile([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(partial),
                     str(source)], partial, target, source)
    module, _, binder = LIBRARIES[kernel]
    lib = getattr(importlib.import_module(f"nerf_attention_tpu_torch.ops.{module}"), binder)(ctypes.CDLL(str(target)))
    lib.read_trace.argtypes = [ctypes.c_void_p]
    return lib


def breakdown(counters: np.ndarray, tiles: int) -> dict:
    """Cycles a tile of each consumer warpgroup, and the producer's waits before its copies."""
    out = {"tiles": tiles}
    for wg in (1, 2):
        t = counters[(wg - 1) * WG_SLOTS:wg * WG_SLOTS]
        later = (t[0] - t[8]) / (tiles - 1) if tiles > 1 else 0.0
        out[f"wg{wg}"] = {"total": (t[5] - t[4]) / tiles, "layer0": t[3] / tiles, "wait": t[0] / tiles,
                          "wait_first_tile": float(t[8]), "wait_later_tiles": later, "full_wait": t[9] / tiles,
                          "wgmma": t[1] / tiles, "epilogue": t[2] / tiles, "between": t[6] / tiles}
    copies = int(counters[41])
    out["producer_warp0"] = {"copies_back": copies, "empty_wait_each": counters[40] / max(copies, 1)}
    return out


DEFAULTS = {"2C": dict(nets=512, seq_len=2048, sine="exact"), "2E": dict(nets=128, seq_len=512, sine="fast"),
            "2F": dict(nets=8, seq_len=2048, sine="fast"), "2D": dict(nets=8, seq_len=2048, sine="fast")}
SCHEME = "int4_g128"  # 2E's and 2F's packed weights


def _runner(kernel: str, nets: int, seq_len: int, sin_impl: str, device: torch.device):
    """(the call, the block's tiles) of the kernel at this shape, through its wrapper."""
    from nerf_attention_tpu_torch.models.siren import SirenStack, init_siren
    from nerf_attention_tpu_torch.ops import siren_attention_cuda, siren_cuda, siren_quant_cuda
    from nerf_attention_tpu_torch.ops._launch import chunking
    from nerf_attention_tpu_torch.tools.measure_attention_decode import attention_inputs
    from nerf_attention_tpu_torch.types import CONFIGS_BY_NAME

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_tiles = -(-seq_len // siren_cuda.WGMMA_TILE_ROWS)
    bf16 = torch.bfloat16
    if kernel in ("2D", "2F"):
        k, v, stats, q = attention_inputs(CONFIGS_BY_NAME["medium"], nets, 1, 128, torch.Generator().manual_seed(44),
                                          device)
        kw = dict(sin_impl=sin_impl, causal=False, compute_dtype=bf16)
        if kernel == "2D":
            run = lambda: siren_attention_cuda.siren_attention_decode_fused(  # noqa: E731
                k, v, *stats, q, 30.0, seq_len, **kw)
        else:
            packed = tuple(siren_quant_cuda.pack_resident_params(s.params(), SCHEME) for s in (k, v))
            run = lambda: siren_quant_cuda.siren_attention_decode_quant(  # noqa: E731
                None, None, *stats, q, SCHEME, 30.0, seq_len, packed=packed, **kw)
        _, rows = chunking(nets, seq_len, siren_cuda.WGMMA_TILE_ROWS, sms)
        return run, min(rows // siren_cuda.WGMMA_TILE_ROWS, n_tiles)
    config = CONFIGS_BY_NAME["medium" if kernel == "2C" else "small"]
    params = init_siren(config, 128, generator=torch.Generator().manual_seed(44), n=nets)
    cpu = SirenStack.from_params(params)
    stack = SirenStack(cpu.flat.to(device), cpu.dims)
    if kernel == "2C":
        run = lambda: siren_cuda.siren_decode_batch(stack, 30.0, seq_len, sin_impl=sin_impl,  # noqa: E731
                                                    compute_dtype=bf16)
    else:
        packed = siren_quant_cuda.pack_resident_params(stack.params(), SCHEME)
        run = lambda: siren_quant_cuda.siren_decode_batch_quant(  # noqa: E731
            None, SCHEME, config.omega_0, seq_len, packed=packed, sin_impl=sin_impl, compute_dtype=bf16)
    _, tiles_per_chunk = siren_cuda.wgmma_chunking(nets, seq_len, sms)
    return run, min(tiles_per_chunk, n_tiles)


def trace(nets: int = 512, seq_len: int = 2048, sin_impl: str = "exact", device: torch.device | None = None,
          kernel: str = "2C") -> dict:
    """One traced run of the kernel at this shape, and the committed and traced kernels' ms."""
    from nerf_attention_tpu_torch.ops import _build, siren_cuda
    from nerf_attention_tpu_torch.utils.timing import per_launch_ms

    device = device or torch.device("cuda")
    run, tiles = _runner(kernel, nets, seq_len, sin_impl, device)
    committed_ms = float(np.median(per_launch_ms(run, 10, 3, device)))
    lib = build(kernel)
    name, attr, _ = LIBRARIES[kernel]
    module = importlib.import_module(f"nerf_attention_tpu_torch.ops.{name}")
    committed = getattr(module, attr)
    setattr(module, attr, lambda *_: lib)
    siren_cuda._wgmma_plan.cache_clear()
    try:
        traced_ms = float(np.median(per_launch_ms(run, 10, 3, device)))
        _build.check(lib, lib.zero_trace(), "zero_trace")
        run()
        torch.cuda.synchronize(device)
        counters = (ctypes.c_longlong * TRACE_SLOTS)()
        _build.check(lib, lib.read_trace(counters), "read_trace")
    finally:
        setattr(module, attr, committed)
        siren_cuda._wgmma_plan.cache_clear()
    return {"kernel": kernel, "nets": nets, "seq_len": seq_len, "sine": sin_impl, "committed_ms": committed_ms,
            "traced_ms": traced_ms, **breakdown(np.array(counters[:], dtype=np.int64), tiles)}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="2C")
    parser.add_argument("--nets", type=int, default=None)
    parser.add_argument("--seq_len", type=int, default=None)
    parser.add_argument("--sine", choices=["exact", "fast"], default=None)
    args = parser.parse_args(argv)
    shape = DEFAULTS[args.kernel]
    print(json.dumps(trace(args.nets or shape["nets"], args.seq_len or shape["seq_len"], args.sine or shape["sine"],
                           kernel=args.kernel)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
