"""Per-pixel tap gather (K3) and its transpose (K4), the counterparts of
`tpu_restir.kernels.local_gather.gather_local` and its custom VJP.

ReSTIR's spatial reuse reads, for every pixel, K neighbour rows of the
packed reuse payload, and temporal reuse reads one reprojected row. On
CUDA tensors `gather_local` launches the kernel of `csrc/local_gather.cu`;
on CPU tensors it takes the plain version `gather_local_ref` (advanced
indexing). Its backward routes as `_gather_local_bwd` of the JAX package:
a same-shape payload (top == 0) takes `scatter_local`, the windowed
transpose of `csrc/local_scatter.cu` on CUDA tensors and its plain version
`scatter_local_ref` (index_add_) on CPU tensors; a halo-extended payload
(top != 0, the sharded case) takes index_add_ on both, as the JAX package
takes XLA's scatter-add there. Each kernel launch counts
`launch.gather_local` or `launch.scatter_local` (`tracing.count`).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_restir_torch import tracing
from tpu_restir_torch.kernels import build

PAD = 8   # the JAX kernel's window bound on tap offsets
tracing.COUNTS.update(dict.fromkeys(("launch.gather_local",
                                     "launch.scatter_local"), 0))

_P = ctypes.c_void_p
_SIGNATURES = {
    "local_gather": ([_P] * 3 + [ctypes.c_int] * 4
                     + [ctypes.c_longlong, ctypes.c_int, _P, _P],
                     ctypes.c_int),
    "local_gather_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
_SCATTER_SIGNATURES = {
    "local_scatter": ([_P] * 3 + [ctypes.c_int] * 7 + [_P] * 2,
                      ctypes.c_int),
    "local_scatter_error_string": ([ctypes.c_int], ctypes.c_char_p),
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
    vec4 = c % 4 == 0 and payload.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    k = tys.shape[0]
    lib = build.load("local_gather", _SIGNATURES)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream(payload.device).cuda_stream
        err = lib.local_gather(payload.data_ptr(), tys.data_ptr(),
                               txs.data_ptr(), eh, w, c, k,
                               tys.numel() // k, int(vec4), out.data_ptr(),
                               stream)
    if err:
        raise RuntimeError("gather_local: launch failed: "
                           f"{lib.local_gather_error_string(err).decode()}")
    tracing.count("launch.gather_local", 1)
    return out


def _index_add(g, tys, txs, eh, w):
    """g (K, H, W, C) summed into (EH, W, C) rows tys * W + txs."""
    c = g.shape[-1]
    idx = (tys.long() * w + txs.long()).reshape(-1)
    return g.new_zeros((eh * w, c)).index_add_(
        0, idx, g.reshape(-1, c)).reshape(eh, w, c)


def scatter_local_ref(g, tys, txs):
    """Plain version of K4: the transpose of `gather_local_ref` for a
    same-shape payload, g (K, H, W, C) -> (H, W, C) by index_add_ (on
    CUDA, atomics in no fixed order)."""
    return _index_add(g, tys, txs, tys.shape[1], tys.shape[2])


def scatter_local_ordered_ref(g, tys, txs, r: int, disk_r2=None):
    """K4's sum in K4's own order, for tests: g (K, H, W, C), taps
    (K, H, W) of a same-shape gather -> (H, W, C), each destination's
    cotangents added to 0 in the order k, then the offset (sy, sx) of the
    source p - (sy, sx), sy and then sx ascending over the window of r and
    disk_r2 (default 2 r^2). Vectorised over pixels, one offset at a time;
    adding 0 where no tap lands leaves a sum unchanged, so the result is
    the kernel's bit for bit on any cotangent."""
    k, h, w, c = g.shape
    disk_r2 = 2 * r * r if disk_r2 is None else int(disk_r2)
    dy = tys.long() - torch.arange(h, device=g.device)[None, :, None]
    dx = txs.long() - torch.arange(w, device=g.device)[None, None, :]
    dest = (tys.long() * w + txs.long()).reshape(k, -1)
    src = g.reshape(k, -1, c)
    out = g.new_zeros((h * w, c))
    for kk in range(k):
        for sy in range(-r, r + 1):
            for sx in range(-r, r + 1):
                if sy * sy + sx * sx > disk_r2:
                    continue
                m = ((dy[kk] == sy) & (dx[kk] == sx)).reshape(-1)
                add = g.new_zeros((h * w, c))
                add[dest[kk][m]] = src[kk][m]
                out += add
    return out.reshape(h, w, c)


def _scatter_cuda(g, tys, txs, r, disk_r2):
    k, h, w, c = g.shape
    for name, x, dtype in (("g", g, torch.float32),
                           ("tys", tys, torch.int32),
                           ("txs", txs, torch.int32)):
        if x.device != g.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"scatter_local: {name} must be a contiguous {dtype} tensor "
                f"on {g.device}; got {x.dtype} on {x.device}")
    out = torch.empty((h, w, c), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    vec4 = c % 4 == 0 and c <= 32 and g.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    lib = build.load("local_scatter", _SCATTER_SIGNATURES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.local_scatter(g.data_ptr(), tys.data_ptr(), txs.data_ptr(),
                                k, h, w, c, r, disk_r2, int(vec4),
                                out.data_ptr(), stream)
    if err:
        raise RuntimeError("scatter_local: launch failed: "
                           f"{lib.local_scatter_error_string(err).decode()}")
    tracing.count("launch.scatter_local", 1)
    return out


def scatter_local(g, tys, txs, r: int, disk_r2=None):
    """K4: g (K, H, W, C) float32 cotangents of a same-shape gather ->
    payload cotangent (H, W, C), summed per destination pixel over the
    offsets |dy|, |dx| <= r with dy^2 + dx^2 <= disk_r2 (default 2 r^2).
    On CUDA a tap outside that window traps (a device fault)."""
    if g.dim() != 4 or tys.shape != g.shape[:3] or txs.shape != tys.shape:
        raise ValueError(
            f"scatter_local: g (K, H, W, C) and taps (K, H, W) expected; got "
            f"{tuple(g.shape)}, {tuple(tys.shape)}, {tuple(txs.shape)}")
    disk_r2 = 2 * r * r if disk_r2 is None else int(disk_r2)
    if g.device.type == "cuda":
        return _scatter_cuda(g.contiguous(), tys, txs, r, disk_r2)
    if g.device.type != "cpu":
        raise ValueError(f"scatter_local: unsupported device {g.device}")
    return scatter_local_ref(g, tys, txs)


class _GatherLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, payload, tys, txs, r, top, disk_r2):
        ctx.save_for_backward(tys, txs)
        ctx.r, ctx.top, ctx.disk_r2 = r, top, disk_r2
        ctx.payload_shape = tuple(payload.shape)
        if payload.device.type == "cuda":
            return _gather_cuda(payload, tys, txs)
        if payload.device.type != "cpu":
            raise ValueError(f"gather_local: unsupported device "
                             f"{payload.device}")
        return gather_local_ref(payload, tys, txs)

    @staticmethod
    def backward(ctx, g):
        tys, txs = ctx.saved_tensors
        eh, w, _c = ctx.payload_shape
        if ctx.top == 0 and eh == tys.shape[1]:
            gp = scatter_local(g, tys, txs, ctx.r, ctx.disk_r2)
        else:
            gp = _index_add(g, tys, txs, eh, w)
        return gp, None, None, None, None, None


def gather_local(payload, tys, txs, r: int, top: int = 0, disk_r2=None):
    """payload (EH, W, C) float32, tap coords tys/txs (K, H, W) int32 in
    PAYLOAD coordinates -> (K, H, W, C): payload[tys, txs, :].

    The signature is the JAX function's: there the taps satisfy
    |tys - (row + top)| <= r <= PAD, `top` is the payload row of output
    row 0, and `disk_r2` bounds the offsets for the backward. The CUDA
    gather has no window, so the forward serves any in-range coordinate;
    the backward of a same-shape payload (K4) holds the taps to the window
    of r and disk_r2, and traps on CUDA where one lies outside it."""
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
    return _GatherLocal.apply(payload, tys, txs, r, top, disk_r2)
