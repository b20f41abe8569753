"""Binned-SAH BVH2 over a scene's triangles (counterpart of
`tpu_restir.accel.bvh.build_bvh2`). Its primitive order is the leaf order
of a clustered scene (`scene.scene.build_scene`), so it decides the
triangle ids that every clustered query reports.

The builder is `accel.cpp`, the JAX package's native builder copied
without change, compiled by g++ at first use into `build/tpu_restir_torch/`
with the JAX package's flags (`-O3 -march=native -fopenmp`), and loaded
with ctypes. A failed build raises: there is no numpy fallback, because
the JAX package's float64 numpy builder can split otherwise and so give
another leaf order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from tpu_restir_torch.kernels.build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "accel.cpp"
# the flags of tpu_restir/accel/native/__init__.py, unchanged
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
_LIB = None


@dataclasses.dataclass
class BVH2:
    """Flat binary BVH. Node i: left[i] >= 0 -> internal (left/right are
    node ids); left[i] < 0 -> leaf with prims order[start[i]:start[i] +
    count[i]]."""

    node_min: np.ndarray   # (M, 3)
    node_max: np.ndarray   # (M, 3)
    left: np.ndarray       # (M,) int32
    right: np.ndarray      # (M,) int32
    start: np.ndarray      # (M,) int32
    count: np.ndarray      # (M,) int32
    order: np.ndarray      # (N,) int32 primitive permutation
    max_depth: int


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode())
    out = BUILD_DIR / f"accel-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(["g++", *FLAGS, "-o", tmp, str(_SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed on {_SRC.name} "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.accel_build_bvh2.restype = ctypes.c_int
    lib.accel_build_bvh2.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, i32p, i32p, i32p, i32p,
        ctypes.POINTER(ctypes.c_int)]
    _LIB = lib
    return lib


def build_bvh2(tri_v: np.ndarray, leaf_size: int = 4,
               n_bins: int = 16) -> BVH2:
    """Triangles (N, 3, 3) -> BVH2 (host arrays)."""
    v = np.ascontiguousarray(tri_v, np.float32)
    if v.ndim != 3 or v.shape[1:] != (3, 3) or v.shape[0] < 1:
        raise ValueError(f"build_bvh2: triangles must be (N, 3, 3) with "
                         f"N >= 1; got {v.shape}")
    if leaf_size < 1 or n_bins < 2:
        raise ValueError(f"build_bvh2: leaf_size {leaf_size} must be >= 1 "
                         f"and n_bins {n_bins} >= 2")
    lib = _lib()
    n = v.shape[0]
    cap = max(2 * n, 2)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left, right, start, count = (np.empty(cap, np.int32) for _ in range(4))
    order = np.empty(n, np.int32)
    depth = ctypes.c_int(0)
    m = lib.accel_build_bvh2(v, n, leaf_size, n_bins, node_min, node_max,
                             left, right, start, count, order,
                             ctypes.byref(depth))
    return BVH2(node_min=node_min[:m], node_max=node_max[:m], left=left[:m],
                right=right[:m], start=start[:m], count=count[:m],
                order=order, max_depth=int(depth.value))
