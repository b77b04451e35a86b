"""Builds the hand-written CUDA kernels in ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so one
``nvcc`` call per source takes seconds. The shared libraries go to ``_build/``
inside the package (listed in ``.gitignore``), named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.

Nothing is compiled at import: the first wrapper that launches a kernel calls
:func:`load`. :func:`build_all` starts one ``nvcc`` per source at once, for
callers that want the whole build up front (``chip_smoke.py``). Both are
``kernels.build`` spans (utils/profiling.py), tagged with the sources and those that
nvcc compiled.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..utils.profiling import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("flash_attention_lane", "flash_attention_lane_bwd", "moe_ffn", "moe_ffn_bwd", "adaln")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with "
                       "the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()
    return src, os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (popen or None if up to date, out, log)."""
    src, out = _target(name)
    if os.path.exists(out):
        return None, out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, tmp


def _finish(name: str, proc, out: str, tmp: str) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Compile every source concurrently (one nvcc each); returns {name: nvcc log}."""
    with _lock, span("kernels.build") as build:
        started = {n: _start(n) for n in SOURCES}
        build.tags = {"sources": list(SOURCES),
                      "compiled": [n for n in SOURCES if started[n][0] is not None]}
        return {n: _finish(n, *started[n]) for n in SOURCES}


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, its argument types set
    (ctypes.c_void_p for every pointer and the stream, c_int, c_float) and an int
    (CUDA error) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            with span("kernels.build") as build:
                proc, out, tmp = _start(name)
                build.tags = {"sources": [name], "compiled": [name] if proc else []}
                _finish(name, proc, out, tmp)
                _libs[name] = ctypes.CDLL(out)
        return _libs[name]
