"""K10: the incomplete beta B_x(a, b) of the Phong normalization, one
launch a call.

`mathx/special.py` evaluates B_x(a, 1/2) in float64 as a continued
fraction of 64 Lentz steps (`_beta_cf`, `_ibeta_value`). On CUDA tensors
the forward of its `_IBetaX` calls `ibeta` below, which launches the
kernel of `csrc/ibeta.cu`; CPU tensors take `_ibeta_value`, the plain
version, which computes the same arithmetic in the same order (the kernel
builds with --fmad=false, so the two agree bit for bit on the card). Each
launch counts `launch.ibeta` (`tracing.count`). There is no JAX kernel
to mirror: the JAX package takes XLA's `betainc`.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_restir_torch import tracing
from tpu_restir_torch.kernels import build

FLAGS = ("--fmad=false",)
tracing.COUNTS.update({"launch.ibeta": 0})

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ibeta": ([_P, _I, _P, _I, _P, _I, ctypes.c_longlong, _P, _P], _I),
    "ibeta_error_string": ([_I], ctypes.c_char_p),
}


def lane_operand(t):
    """(tensor, step) of one operand broadcast to the lanes: a single
    value broadcast to all of them (every stride 0) is read in place with
    step 0, anything else is made contiguous and read with step 1."""
    if all(s == 0 for s in t.stride()):
        return t, 0
    return t.contiguous(), 1


def ibeta(x, a, b):
    """B_x(a, b) as float64, for float64 CUDA tensors of one broadcast
    shape (`ibeta_nonnorm` broadcasts them), by K10."""
    dev = x.device
    for name, t in (("x", x), ("a", a), ("b", b)):
        if t.device != dev or t.dtype != torch.float64 \
                or t.shape != x.shape:
            raise ValueError(
                f"ibeta: {name} must be a float64 tensor of shape "
                f"{tuple(x.shape)} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    out = torch.empty(x.shape, dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out
    (x, xs), (a, as_), (b, bs) = map(lane_operand, (x, a, b))
    lib = build.load("ibeta", _SIGNATURES, extra_flags=FLAGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ibeta(x.data_ptr(), xs, a.data_ptr(), as_, b.data_ptr(),
                        bs, out.numel(), out.data_ptr(), stream)
    if err:
        raise RuntimeError("ibeta: launch failed: "
                           f"{lib.ibeta_error_string(err).decode()}")
    tracing.count("launch.ibeta", 1)
    return out
