"""ctypes loader for the native MDS gather (``_native/mds_gather.cpp``): the port's
own copy of micro_diffusion_tpu/datasets/native.py (``available`` :64, ``gather``
:68).

Host C++ with a plain C interface, built with ``g++`` at first use, never at
import. The library goes to the package's ``_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags as ``ops/_build.py`` names the
kernels' libraries, and is written through a temporary file and ``os.replace``,
so that ranks starting together never load a half-written file. A failed build
raises with the compiler's output: there is no silent fallback to Python.
``MDSReader.read_many`` sends every batch of 4 ranges or more here, as the JAX
reader does.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native", "mds_gather.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path(build_dir: str = BUILD_DIR) -> str:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(build_dir, f"mds_gather-{digest.hexdigest()[:16]}.so")


def build(compiler: str = "g++", build_dir: str = BUILD_DIR) -> str:
    """Compile the source unless its library exists; returns the library's path.
    Raises RuntimeError with the compiler's output when the build fails."""
    out = library_path(build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([compiler, *CXX_FLAGS, SRC, "-o", tmp],
                              capture_output=True, text=True)
    except OSError as err:  # no such compiler
        raise RuntimeError(f"building {SRC} with {compiler!r} failed: {err}") from err
    if proc.returncode != 0:
        raise RuntimeError(f"building {SRC} with {compiler!r} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.mds_gather.restype = ctypes.c_long
            lib.mds_gather.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_long,
                ctypes.c_char_p,
                ctypes.c_int,
            ]
            _lib = lib
        return _lib


def available() -> bool:
    """True once the native gather is built and loaded (the first call builds it;
    a failed build raises)."""
    return _load() is not None


def gather(paths: Sequence[str], file_offsets: Sequence[int], lengths: Sequence[int],
           num_threads: int = 8) -> List[memoryview]:
    """The n byte ranges (``paths[i]``, ``file_offsets[i]``, ``lengths[i]``), read by
    ``num_threads`` threads of ``pread`` into one buffer, returned as read-only views
    of it (no second copy; they compare equal to ``bytes``). Raises OSError with the
    first failure's errno (a missing file, a short read)."""
    lib = _load()
    n = len(paths)
    if not n:
        return []
    if not len(file_offsets) == len(lengths) == n:
        raise ValueError(f"gather: {n} paths, {len(file_offsets)} offsets, "
                         f"{len(lengths)} lengths")
    lengths_arr = np.ascontiguousarray(lengths, np.int64)
    offsets_arr = np.ascontiguousarray(file_offsets, np.int64)
    if (lengths_arr < 0).any() or (offsets_arr < 0).any():
        raise ValueError("gather: negative offset or length")
    out_offsets = np.zeros(n, np.int64)
    np.cumsum(lengths_arr[:-1], out=out_offsets[1:])
    out = np.empty(int(lengths_arr.sum()), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    ret = lib.mds_gather(
        c_paths,
        offsets_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        lengths_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        out_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n,
        out.ctypes.data_as(ctypes.c_char_p),
        num_threads,
    )
    if ret < 0:
        raise OSError(-ret, f"mds_gather failed: {os.strerror(-int(ret))}")
    view = memoryview(out).toreadonly()
    return [view[lo:lo + ln] for lo, ln in zip(out_offsets.tolist(), lengths_arr.tolist())]
