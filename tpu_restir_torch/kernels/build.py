"""Build and load the CUDA kernels of `csrc/` at first CUDA use.

Each `.cu` file has a plain C interface and is compiled by `nvcc` into a
shared library for `sm_90a`, loaded with ctypes (no PyTorch headers, so a
build takes seconds). Libraries go to `build/tpu_restir_torch/` at the
root of the checkout, named by a hash of the source and the flags, so an
edited source rebuilds. A failed build raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_restir_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: dict = {}
# per library: build seconds (0.0 when loaded from an earlier build) and
# the compiler's resource report (-Xptxas -v)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(needs the CUDA toolkit, on PATH or under "
                       "/usr/local/cuda)")


def load(name: str, signatures: dict, extra_flags=()) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process.
    signatures: C function name -> (argtypes, restype), set on load."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    flags = ARCH_FLAGS + BASE_FLAGS + list(extra_flags)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    seconds, report = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
        report = proc.stderr
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _LIBS[name] = lib
    BUILD_INFO[name] = {"seconds": seconds, "ptxas": report, "path": str(out)}
    return lib


def load_all(specs) -> list:
    """Build and load several libraries at once, one nvcc each, all
    started together. specs: (name, signatures, extra_flags) tuples."""
    with concurrent.futures.ThreadPoolExecutor(max(len(specs), 1)) as ex:
        futures = [ex.submit(load, *spec) for spec in specs]
        return [f.result() for f in futures]


def load_kernels() -> list:
    """Build and load the five libraries of `csrc/` at once (K1/K2, K3,
    K4, K5-K9, K10), with the flags and signatures of their modules."""
    from tpu_restir_torch.kernels import (cluster_trace, ibeta, local_gather,
                                          ray_tri)
    return load_all([("ray_tri", ray_tri._SIGNATURES, ray_tri.FLAGS),
                     ("local_gather", local_gather._SIGNATURES, ()),
                     ("local_scatter", local_gather._SCATTER_SIGNATURES, ()),
                     ("cluster_trace", cluster_trace._SIGNATURES,
                      cluster_trace.FLAGS),
                     ("ibeta", ibeta._SIGNATURES, ibeta.FLAGS)])
