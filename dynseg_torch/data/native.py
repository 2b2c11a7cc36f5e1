"""ctypes bindings for the native (C++) data-layer helpers.

The port's own copy of dynseg/data/native.py (dynseg_torch imports nothing
of the JAX package); tests/test_torch_data.py holds it to the original.
The C++ source is the port's copy too, dynseg_torch/native/position_tables.cc:
it builds per-class position tables from production-size label rasters in
one fused pass instead of num_classes numpy full scans.

Loading strategy: at first use, `g++` compiles the source into the
git-ignored dynseg_torch/_build/ under a name keyed by a hash of the source
and flags (as ops/_build.py does for the CUDA kernels), so an edit rebuilds
and an unchanged tree reuses the file; the JAX package's native/build/ is
never touched. Where no compiler or library is available, `available()` is
False and the sampler takes its numpy path, as the original does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "position_tables.cc")
_BUILD_DIR = os.path.join(_PKG, "_build")
# native/Makefile's flags.
_CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
_LD_FLAGS = ("-shared", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _so_path() -> str:
    digest = hashlib.sha256(" ".join(_CXX_FLAGS + _LD_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD_DIR, f"libdynseg_native-{digest.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    """g++ into a temporary name, then an atomic rename: concurrent
    processes never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, *_CXX_FLAGS, _SRC, *_LD_FLAGS, "-o", tmp],
                   capture_output=True, timeout=120, check=True)
    os.replace(tmp, so)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not os.path.exists(so):
            try:
                _build(so)
            except (OSError, subprocess.SubprocessError):
                return None  # no compiler: the sampler's numpy path
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
        lib.count_class_pixels.argtypes = [
            i32p, i64, i64, i64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fill_position_tables.argtypes = [
            i32p, i64, i64, i64, ctypes.c_int32, ctypes.POINTER(i32p),
        ]
        lib.shuffle_table.argtypes = [i32p, i64, ctypes.c_uint64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_position_tables(
    masks: np.ndarray, num_classes: int
) -> Optional[List[np.ndarray]]:
    """Per-class (n_c, 3) int32 (tile,row,col) tables in raster order —
    same contract as the numpy fallback in sampler.py."""
    lib = _load()
    if lib is None:
        return None
    masks = np.ascontiguousarray(masks, dtype=np.int32)
    t, h, w = masks.shape
    counts = np.zeros(num_classes, dtype=np.int64)
    mp = masks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.count_class_pixels(
        mp, t, h, w, num_classes,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    tables = [np.empty((int(n), 3), dtype=np.int32) for n in counts]
    ptrs = (ctypes.POINTER(ctypes.c_int32) * num_classes)(
        *[tb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for tb in tables]
    )
    lib.fill_position_tables(mp, t, h, w, num_classes, ptrs)
    return tables


def shuffle_table(table: np.ndarray, seed: int) -> None:
    """In-place Fisher–Yates shuffle of an (n,3) int32 table."""
    lib = _load()
    # Explicit errors, not assert (stripped under python -O): the C
    # Fisher-Yates swaps raw memory, and a non-contiguous view's base
    # pointer would silently corrupt the parent array.
    if lib is None:
        raise RuntimeError("native library unavailable — gate calls on "
                           "native.available()")
    if not (table.dtype == np.int32 and table.ndim == 2
            and table.shape[1] == 3 and table.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"shuffle_table needs a C-contiguous (n, 3) int32 array, got "
            f"{table.dtype} {table.shape} contiguous="
            f"{table.flags['C_CONTIGUOUS']}")
    lib.shuffle_table(
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        table.shape[0],
        ctypes.c_uint64(seed),
    )
