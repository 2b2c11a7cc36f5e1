"""Build and bind the package's CUDA kernels.

At first use, one `nvcc` per source in dynseg_torch/csrc/, all started
together, compiles the kernels for sm_90a (Hopper); a last `nvcc` links
the objects into one shared library with a plain C interface, and ctypes
loads it. The library lands in dynseg_torch/_build/ (git-ignored) under a
name keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the file. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# What the last build in this process reported: seconds, nvcc's stderr
# (ptxas register and shared-memory use) and the library's path.
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.dynseg_int8_block_conv
    # x, w_packed, a, b, out, B, H, W, Cin, Cout, k, dilation, pad_lo,
    # leaky, requant, inv_scale, variant, stream
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, f, i, p]
    fn.restype = ctypes.c_int
    fn = lib.dynseg_patch_gather
    # images, masks, mean, std, positions, aug, out_img, out_lab, B, T, H,
    # W, C, size, img_u8, mask_u8, stream
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    fn = lib.dynseg_pool_bwd
    # x, y, g, gdc, dx, B, H, W, C, window, stream
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    fn = lib.dynseg_int8_conv3x3
    # x, w_packed, out, B, H, W, C, dilation, scale, stream
    fn.argtypes = [p, p, p, i, i, i, i, i, f, p]
    fn.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first call."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.iterdir()):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libdynseg_kernels-{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for src, obj in zip(sources, objs)]
        outs = [p.communicate() for p in procs]
        for src, p, (_, err) in zip(sources, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on {src.name}:\n{err}")
            log += err
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        for obj in objs:
            obj.unlink()
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    build_info.update(seconds=time.perf_counter() - t0, log=log, path=str(so))
    _lib = lib
    return lib
