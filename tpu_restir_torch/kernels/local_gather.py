"""Per-pixel tap gather: K3, the counterpart of
`tpu_restir.kernels.local_gather.gather_local`.

ReSTIR's spatial reuse reads, for every pixel, K neighbour rows of the
packed reuse payload, and temporal reuse reads one reprojected row. On
CUDA tensors `gather_local` launches the kernel of `csrc/local_gather.cu`;
on CPU tensors it takes the plain version `gather_local_ref` (advanced
indexing). Forward only: the backward is kernel K4, not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_restir_torch.kernels import build

PAD = 8   # the JAX kernel's window bound on tap offsets

# kernel launches (the plain version does not count)
LAUNCHES = {"gather_local": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    "local_gather": ([_P] * 3 + [ctypes.c_int] * 3
                     + [ctypes.c_longlong, ctypes.c_int, _P, _P],
                     ctypes.c_int),
    "local_gather_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def gather_local_ref(payload, tys, txs):
    """Plain version of K3: payload[tys, txs, :] -> (K, H, W, C)."""
    return payload[tys.long(), txs.long()]


def _gather_cuda(payload, tys, txs):
    eh, w, c = payload.shape
    for name, x, dtype in (("payload", payload, torch.float32),
                           ("tys", tys, torch.int32),
                           ("txs", txs, torch.int32)):
        if x.device != payload.device or x.dtype != dtype \
                or not x.is_contiguous():
            raise ValueError(
                f"gather_local: {name} must be a contiguous {dtype} tensor "
                f"on {payload.device}; got {x.dtype} on {x.device}")
    out = torch.empty(tys.shape + (c,), dtype=torch.float32,
                      device=payload.device)
    if out.numel() == 0:
        return out
    vec4 = c % 4 == 0 and payload.data_ptr() % 16 == 0
    lib = build.load("local_gather", _SIGNATURES)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream(payload.device).cuda_stream
        err = lib.local_gather(payload.data_ptr(), tys.data_ptr(),
                               txs.data_ptr(), eh, w, c, tys.numel(),
                               int(vec4), out.data_ptr(), stream)
    if err:
        raise RuntimeError("gather_local: launch failed: "
                           f"{lib.local_gather_error_string(err).decode()}")
    LAUNCHES["gather_local"] += 1
    return out


class _GatherLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, payload, tys, txs):
        if payload.device.type == "cuda":
            return _gather_cuda(payload, tys, txs)
        if payload.device.type != "cpu":
            raise ValueError(f"gather_local: unsupported device "
                             f"{payload.device}")
        return gather_local_ref(payload, tys, txs)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the backward of gather_local is kernel K4 "
            "(tpu_restir/kernels/local_gather.py _scatter_kernel), not "
            "ported yet (ROADMAP item 6)")


def gather_local(payload, tys, txs, r: int, top: int = 0, disk_r2=None):
    """payload (EH, W, C) float32, tap coords tys/txs (K, H, W) int32 in
    PAYLOAD coordinates -> (K, H, W, C): payload[tys, txs, :].

    The signature is the JAX function's: there the taps satisfy
    |tys - (row + top)| <= r <= PAD, `top` is the payload row of output
    row 0, and `disk_r2` bounds the offsets for the backward. The CUDA
    gather has no window, so these bound nothing here: any in-range
    coordinate is served."""
    if payload.dim() != 3 or tys.dim() != 3 or tys.shape != txs.shape:
        raise ValueError(
            f"gather_local: payload (EH, W, C) and taps (K, H, W) expected; "
            f"got {tuple(payload.shape)}, {tuple(tys.shape)}, "
            f"{tuple(txs.shape)}")
    if r < 0 or top < 0 or top + tys.shape[1] > payload.shape[0] \
            or tys.shape[2] != payload.shape[1]:
        raise ValueError(f"gather_local: r={r}, top={top} do not fit taps "
                         f"{tuple(tys.shape)} into payload "
                         f"{tuple(payload.shape)}")
    return _GatherLocal.apply(payload, tys, txs)
