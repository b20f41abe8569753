"""Ray x triangle queries for small scenes: K1 (closest hit) and K2 (any
hit), the counterparts of `tpu_restir.kernels.ray_tri`.

Every ray is tested against every triangle by the Woop affine test
(`kernels/woop.py`). On CUDA tensors the wrappers launch the kernels of
`csrc/ray_tri.cu`; on CPU tensors they take the plain PyTorch versions
`closest_hit_ref` / `any_hit_ref` below, which compute the same test in
the same operation order. Each launch counts `launch.closest_hit` or
`launch.any_hit` (`tracing.count`); the plain versions count nothing.

`closest_hit` is differentiable in the ray origins and directions by the
analytic derivative of the winning triangle's Woop map
(`tpu_restir.kernels.ray_tri._closest_bwd`, XLA code in the JAX package,
plain PyTorch here); the winner and the geometry are treated as data.
`any_hit` returns a detached bool, as the JAX package's `_any_bwd` gives
zero cotangents.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_restir_torch import tracing
from tpu_restir_torch.kernels import build

_BARY_EPS = 1e-5
_REF_CHUNK = 1 << 14   # rays per (rays, tris) broadcast in the plain versions
_P = ctypes.c_void_p
tracing.COUNTS.update(dict.fromkeys(("launch.closest_hit", "launch.any_hit"),
                                    0))


def woop_rows(scene):
    """(T, 12) float32 Woop rows (u, v, w rows of each 3x4 map)."""
    return scene.woop.reshape(scene.num_tris, 12)


def _woop_tuvok(o, d, tn, tf, w):
    """(t, u, v, ok), each (R, T), for rays (R, ...) against rows (T, 12),
    in the operation order of tpu_restir.kernels.ray_tri._woop_tuvok (also
    the block test of the woop_mxu and cluster backends,
    `kernels/woop.intersect_block`)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]

    def aff(c):
        return ox * w[:, 4 * c] + oy * w[:, 4 * c + 1] \
            + oz * w[:, 4 * c + 2] + w[:, 4 * c + 3]

    def lin(c):
        return dx * w[:, 4 * c] + dy * w[:, 4 * c + 1] + dz * w[:, 4 * c + 2]

    ow, dw = aff(2), lin(2)
    # the division's operand is selected too, so that a graph through it
    # (the woop_mxu and cluster backends) has no 0 * inf = NaN
    ok_dw = torch.abs(dw) > 1e-18
    t = torch.where(ok_dw, -ow / torch.where(ok_dw, dw, 1.0), torch.inf)
    u = aff(0) + t * lin(0)
    v = aff(1) + t * lin(1)
    ok = ((u >= -_BARY_EPS) & (v >= -_BARY_EPS)
          & (u + v <= 1.0 + _BARY_EPS) & torch.isfinite(t)
          & (t >= tn[:, None]) & (t <= tf[:, None]))
    return t, u, v, ok


def closest_hit_ref(w, o, d, tnear, tfar):
    """Plain version of K1 -> (t, u, v, tri int32); t = inf and tri = -1
    on a miss. The winner is the first triangle of least t, as the
    kernel's strictly-closer running minimum."""
    n = o.shape[0]
    t_out = torch.full((n,), torch.inf, dtype=torch.float32, device=o.device)
    u_out = torch.zeros((n,), dtype=torch.float32, device=o.device)
    v_out = torch.zeros_like(u_out)
    tri_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for s in range(0, n, _REF_CHUNK):
        e = min(n, s + _REF_CHUNK)
        t, u, v, ok = _woop_tuvok(o[s:e], d[s:e], tnear[s:e], tfar[s:e], w)
        tt = torch.where(ok, t, torch.inf)
        j = torch.argmin(tt, dim=1, keepdim=True)
        hit = torch.any(ok, dim=1)
        t_out[s:e] = torch.where(hit, tt.gather(1, j)[:, 0], torch.inf)
        u_out[s:e] = torch.where(hit, u.gather(1, j)[:, 0], 0.0)
        v_out[s:e] = torch.where(hit, v.gather(1, j)[:, 0], 0.0)
        tri_out[s:e] = torch.where(hit, j[:, 0].to(torch.int32), -1)
    return t_out, u_out, v_out, tri_out


def any_hit_ref(w, o, d, tnear, tfar):
    """Plain version of K2 -> bool occlusion mask."""
    n = o.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for s in range(0, n, _REF_CHUNK):
        e = min(n, s + _REF_CHUNK)
        ok = _woop_tuvok(o[s:e], d[s:e], tnear[s:e], tfar[s:e], w)[3]
        occ[s:e] = torch.any(ok, dim=1)
    return occ


_SIGNATURES = {
    "ray_tri_closest": ([_P] * 5 + [ctypes.c_longlong, ctypes.c_int]
                        + [_P] * 5, ctypes.c_int),
    "ray_tri_any": ([_P] * 5 + [ctypes.c_longlong, ctypes.c_int] + [_P] * 2,
                    ctypes.c_int),
    "ray_tri_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


# K1/K2 keep the plain version's rounding: no contracted multiply-adds
FLAGS = ("--fmad=false",)


def _lib():
    return build.load("ray_tri", _SIGNATURES, extra_flags=FLAGS)


def _check_args(w, o, d, tnear, tfar):
    """Validate the kernel's inputs: one CUDA device, float32, contiguous,
    rays (N, 3) / (N,), rows (T, 12)."""
    n = o.shape[0]
    want = {"w": (w, (w.shape[0], 12)), "o": (o, (n, 3)), "d": (d, (n, 3)),
            "tnear": (tnear, (n,)), "tfar": (tfar, (n,))}
    for name, (x, shape) in want.items():
        if x.device != o.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"ray_tri: {name} must be a contiguous float32 tensor of "
                f"shape {shape} on {o.device}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")


def _launch(kind, w, o, d, tnear, tfar, outs):
    _check_args(w, o, d, tnear, tfar)
    lib = _lib()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        fn = lib.ray_tri_closest if kind == "closest_hit" else lib.ray_tri_any
        err = fn(o.data_ptr(), d.data_ptr(), tnear.data_ptr(),
                 tfar.data_ptr(), w.data_ptr(), o.shape[0], w.shape[0],
                 *[x.data_ptr() for x in outs], stream)
    if err:
        raise RuntimeError(f"ray_tri {kind}: launch failed: "
                           f"{lib.ray_tri_error_string(err).decode()}")
    tracing.count("launch." + kind, 1)


def _on_cuda(o) -> bool:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ray_tri: unsupported device {o.device}")
    return o.device.type == "cuda"


def _closest_forward(w, o, d, tnear, tfar):
    if not _on_cuda(o):
        return closest_hit_ref(w, o, d, tnear, tfar)
    n = o.shape[0]
    t, u, v = (torch.empty((n,), dtype=torch.float32, device=o.device)
               for _ in range(3))
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n:
        _launch("closest_hit", w, o, d, tnear, tfar, (t, u, v, tri))
    return t, u, v, tri


def closest_hit_bwd(w, d, t, tri, gt, gu, gv):
    """Analytic d(t, u, v)/d(o, d) for the detached winning triangle, as
    `tpu_restir.kernels.ray_tri._closest_bwd`. With W the winner's Woop
    rows (w_u, w_v, w_w | translations):
      t = -(w_w.o + c_w) / (w_w.d),  u = (w_u.o + c_u) + t (w_u.d),
    v likewise with w_v; so with L_x = w_x.d and
    a = (gt + gu L_u + gv L_v) / L_w:
      dL/do = gu w_u + gv w_v - a w_w,   dL/dd = t dL/do.
    Misses (tri < 0 or t = inf) get zero. -> (go, gd), each (N, 3)."""
    from tpu_restir_torch import mathx

    rows = mathx.take_rows(w, torch.clamp(tri, min=0).long())   # (N, 12)
    wu, wv, ww = rows[:, 0:3], rows[:, 4:7], rows[:, 8:11]
    lw = mathx.dot(ww, d)
    lu = mathx.dot(wu, d)
    lv = mathx.dot(wv, d)
    inv_lw = torch.where(torch.abs(lw) > 1e-18, 1.0 / lw, 0.0)
    fin = torch.isfinite(t)
    live = ((tri >= 0) & fin).to(torch.float32)
    tt = torch.where(fin, t, 0.0)
    a = (gu * lu + gv * lv + gt) * inv_lw * live
    go = (gu * live)[:, None] * wu + (gv * live)[:, None] * wv \
        - a[:, None] * ww
    return go, tt[:, None] * go


class ClosestHit(torch.autograd.Function):
    """A closest-hit query, query(o, d, tnear, tfar) -> (t, u, v, tri),
    computed with no graph (a kernel on CUDA, its plain version on the
    CPU); the backward is `closest_hit_bwd` with the scene's Woop rows w.
    Serves K1 here and the clustered traversal K5 (`render.intersect`),
    as the JAX package's `_closest_bwd` and `_pt_closest_core` VJPs share
    `_detached_woop_bwd`."""

    @staticmethod
    def forward(ctx, query, w, o, d, tnear, tfar):
        t, u, v, tri = query(o, d, tnear, tfar)
        ctx.save_for_backward(w, d, t, tri)
        ctx.mark_non_differentiable(tri)
        return t, u, v, tri

    @staticmethod
    def backward(ctx, gt, gu, gv, _gtri):
        w, d, t, tri = ctx.saved_tensors
        go, gd = closest_hit_bwd(w, d, t, tri, gt, gu, gv)
        return None, None, go, gd, None, None


def closest_hit(scene, o, d, tnear, tfar):
    """K1, closest-hit query -> (t, u, v, tri int32) flat tensors (tri = -1,
    t = inf on a miss). o, d (N, 3); tnear, tfar (N,). Differentiable in
    o and d (see `closest_hit_bwd`)."""
    w = woop_rows(scene)
    return ClosestHit.apply(functools.partial(_closest_forward, w), w, o,
                                d, tnear, tfar)


def any_hit(scene, o, d, tnear, tfar):
    """K2, occlusion query: True where any triangle blocks [tnear, tfar].
    Detached: the mask carries no gradient (the JAX package's `_any_bwd`
    returns zero cotangents), and the plain version runs without a graph
    even when the rays require grad."""
    w = woop_rows(scene)
    if not _on_cuda(o):
        with torch.no_grad():
            return any_hit_ref(w, o, d, tnear, tfar)
    occ = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    if o.shape[0]:
        _launch("any_hit", w, o.detach(), d.detach(), tnear.detach(),
                tfar.detach(), (occ,))
    return occ


def supports(scene, max_tris: int = 512) -> bool:
    """Kernel applicability: a small scene."""
    return scene.num_tris <= max_tris
