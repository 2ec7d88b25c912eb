"""Build the CUDA kernels in ``csrc/`` with ``nvcc``, and the host code there with ``g++``, at first use.

Each ``csrc/<name>.cu`` becomes ``build/<name>-<hash>.so`` inside the package,
a shared library with a plain C interface loaded with ctypes; each
``csrc/<name>.cpp`` (host code, ``load_host_library``) likewise. The sources
in ``PARTS`` are compiled once per part (``-DSIREN_PART=<i>``, each part
holding some of the kernel instances), all parts at once, and linked into one
library: their kernel instances are the build's longest compiles. The hash
covers the sources, the headers and the flags, so an edited source is rebuilt
and never loaded stale. A library is compiled to a temporary name and renamed
into place; a host library is built under a file lock, so processes that
start together build it once. A failed build raises with the compiler's
output. Nothing is built when a module is imported: the first call builds;
a thread that asks for a library another thread is building waits for it.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills into the build log
)

# Sources built in parts, and how many: two, one a sine (exact, fast), each with half the kernel instances.
PARTS = {"siren_decode": 2, "siren_attention": 2, "siren_attention_bf16": 2, "siren_attention_act16": 2}

_libraries: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and nvcc not on PATH)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


# The flags the JAX package builds nerf_attention_tpu/native/synthkv.cpp with: the same code, the same output.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _digest(source: Path, headers: list[Path], flags) -> str:
    h = hashlib.sha256()
    for path in [source, *headers]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _compile(cmd: list[str], partial: Path, target: Path, source: Path) -> str:
    """Run a compiler writing ``partial``, then rename it to ``target``; returns its output."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}) building {source.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(partial, target)
    return proc.stdout + proc.stderr


def _compile_parts(source: Path, parts: int, partial: Path, target: Path) -> str:
    """Compile ``source`` once per part into objects, all at once, then link them into ``target``; returns the
    compilers' output."""
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objects = [partial.with_name(f"{partial.name}.part{i}.o") for i in range(parts)]
    cmds = [[_nvcc(), *flags, "-c", f"-DSIREN_PART={i}", "-I", str(CSRC_DIR), "-o", str(obj), str(source)]
            for i, obj in enumerate(objects)]
    try:
        with concurrent.futures.ThreadPoolExecutor(parts) as pool:
            logs = list(pool.map(lambda i: _compile(cmds[i], objects[i], objects[i], source), range(parts)))
        link = [_nvcc(), "-shared", "-o", str(partial), *map(str, objects)]
        return "".join(logs) + _compile(link, partial, target, source)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes library built from ``csrc/<name>.cu``, compiling it if needed."""
    if name in _libraries:
        return _libraries[name]
    with _lock(name):
        if name in _libraries:  # built by the thread this one waited for
            return _libraries[name]
        source = CSRC_DIR / f"{name}.cu"
        parts = PARTS.get(name, 1)
        flags = NVCC_FLAGS if parts == 1 else (*NVCC_FLAGS, f"parts={parts}")
        target = BUILD_DIR / f"{name}-{_digest(source, sorted(CSRC_DIR.glob('*.cuh')), flags)}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            if parts > 1:
                build_logs[name] = _compile_parts(source, parts, partial, target)
            else:
                cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(partial), str(source)]
                build_logs[name] = _compile(cmd, partial, target, source)
        lib = ctypes.CDLL(str(target))
        _libraries[name] = lib
        return lib


def load_host_library(name: str) -> ctypes.CDLL:
    """The ctypes library built with ``g++`` from the host source ``csrc/<name>.cpp``, compiling it if needed."""
    if name in _libraries:
        return _libraries[name]
    with _lock(name):
        if name in _libraries:  # built by the thread this one waited for
            return _libraries[name]
        source = CSRC_DIR / f"{name}.cpp"
        target = BUILD_DIR / f"{name}-{_digest(source, [], GXX_FLAGS)}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / f"{name}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
                if not target.exists():  # another process may have built it while this one waited
                    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
                    cmd = ["g++", *GXX_FLAGS, "-o", str(partial), str(source)]
                    build_logs[name] = _compile(cmd, partial, target, source)
        lib = ctypes.CDLL(str(target))
        _libraries[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code (its ``cudaGetLastError()``)."""
    if status != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {status} ({lib.error_string(status).decode()})")
