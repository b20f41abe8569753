"""Ray-scene intersection (counterpart of `tpu_restir.render.intersect`,
cut to its two production backends):

* "fused": scenes of at most `fused_max_tris` triangles go to the
  ray/triangle kernels K1 and K2 (`kernels/ray_tri.py`; intersect.py:697-709,
  :742-750);
* "ptrace": clustered scenes above that go to the packet-shortlist
  traversal K5 and K6 (`kernels/cluster_trace.py`; intersect.py:453-525),
  with rays of a 2-D pixel grid swizzled into 8x32-tile packets and long
  queries cut into chunks of `ptrace_chunk` rays; with `ptrace_mxu` the
  scene's Woop blocks go along, and the traversal takes its Woop variant
  K7/K8 where it applies (scenes built at cluster_size 128, factor 1).

Both closest-hit queries are differentiable in the ray origins and
directions by the detached-winner derivative of `ray_tri.closest_hit_bwd`;
occlusion is a detached bool. The JAX package's other backends are not
ported (ROADMAP item 13).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpu_restir_torch.config import IntersectorConfig
from tpu_restir_torch import mathx
from tpu_restir_torch.kernels import cluster_trace, ray_tri

# Query log: set to a list and every closest/any query appends its ray
# count, the per-frame ray totals behind the traced rays-per-pixel check.
# None = off.
QUERY_LOG = None


def _log_query(kind: str, backend: str, shape) -> None:
    if QUERY_LOG is not None:
        QUERY_LOG.append({"kind": kind, "backend": backend,
                          "rays": int(np.prod(shape, dtype=np.int64))})


@dataclasses.dataclass
class Hit:
    t: torch.Tensor     # (...,) distance along the ray (0 on a miss)
    u: torch.Tensor     # (...,) barycentric (vertex 1 weight)
    v: torch.Tensor     # (...,) barycentric (vertex 2 weight)
    tri: torch.Tensor   # (...,) int32 triangle index (-1 on a miss)
    hit: torch.Tensor   # (...,) bool


@dataclasses.dataclass
class HitInfo:
    """Interpolated hit payload (reference pg/HitInfo.h:4-23)."""

    did_hit: torch.Tensor      # (...,) bool
    point: torch.Tensor        # (..., 3)
    normal: torch.Tensor       # (..., 3) shading normal, toward the viewer
    uv: torch.Tensor           # (..., 2)
    tangent: torch.Tensor      # (..., 3)
    from_inside: torch.Tensor  # (...,) bool
    dst: torch.Tensor          # (...,)
    tri: torch.Tensor          # (...,) int32
    mat_id: torch.Tensor       # (...,) int32


def _backend(scene, cfg: IntersectorConfig) -> str:
    """"auto" takes "fused" up to `fused_max_tris` triangles and "ptrace"
    above (intersect.py:647-689, as off the CPU); "fused" and "ptrace" may
    also be asked for by name."""
    backend = cfg.backend
    if backend == "auto":
        backend = "fused" if ray_tri.supports(scene, cfg.fused_max_tris) \
            else "ptrace"
    elif backend not in ("fused", "ptrace"):
        raise NotImplementedError(
            f"intersection backend {backend!r} is not ported; the port runs "
            "'fused' (K1/K2) and 'ptrace' (K5/K6), or 'auto' (ROADMAP item "
            "13)")
    if backend == "fused" and not ray_tri.supports(scene, cfg.fused_max_tris):
        raise ValueError(
            f"backend 'fused' needs at most fused_max_tris="
            f"{cfg.fused_max_tris} triangles (got {scene.num_tris})")
    if backend == "ptrace":
        if not cluster_trace.supports(scene):
            raise ValueError(
                f"backend 'ptrace' needs a clustered scene (more than "
                f"build_scene's cluster_size triangles; got "
                f"{scene.num_tris} without cluster blocks)")
    return backend


def _flat_rays(o, d, tnear, tfar):
    shape = o.shape[:-1]

    def flat(x):
        return torch.as_tensor(x, dtype=torch.float32, device=o.device) \
            .expand(shape).reshape(-1).contiguous()

    return (shape, o.reshape(-1, 3).contiguous(),
            d.reshape(-1, 3).contiguous(), flat(tnear), flat(tfar))


_TILE_H, _TILE_W = 8, 32   # 8 x 32 pixels == one packet of 256 rays


def _swizzle_applicable(shape) -> bool:
    """2-D pixel grids and batched (Q, ..., H, W) query stacks fold per
    image into 8x32-tile packets (intersect.py:640-644); other shapes run
    unswizzled, which is as exact and only slower."""
    return (len(shape) >= 2 and shape[-2] % _TILE_H == 0
            and shape[-1] % _TILE_W == 0)


def _tile_fold(x, h, w, q):
    """Row-major flat (q*h*w, ...) -> packet-major 8x32-tile order per
    image (intersect.py:159-167)."""
    rest = x.shape[1:]
    xr = x.reshape(q, h // _TILE_H, _TILE_H, w // _TILE_W, _TILE_W, *rest)
    return xr.transpose(2, 3).reshape((q * h * w,) + rest)


def _tile_unfold(x, h, w, q):
    """Inverse of _tile_fold (intersect.py:170-175)."""
    rest = x.shape[1:]
    xr = x.reshape(q, h // _TILE_H, w // _TILE_W, _TILE_H, _TILE_W, *rest)
    return xr.transpose(2, 3).reshape((q * h * w,) + rest)


def _ptrace(fn, scene, cfg: IntersectorConfig, shape, of, df, tn, tf):
    """fn (cluster_trace.trace_closest or trace_any) over flat rays, in
    8x32-tile packet order where the shape allows, in chunks of
    `cfg.ptrace_chunk` rays (intersect.py:178-211), with the scene's Woop
    blocks where `cfg.ptrace_mxu` asks for them (intersect.py:514-525).
    The tail chunk is not padded to the chunk size:
    the trace pads it to a packet multiple with the same dead rays
    (tfar = -1), so every packet holds the rays it holds in the JAX
    package's padded chunk."""
    chunk = cfg.ptrace_chunk
    cwoop = scene.cluster_woop if cfg.ptrace_mxu else None
    swizzle = _swizzle_applicable(shape)
    if swizzle:
        h, w = shape[-2], shape[-1]
        q = int(np.prod(shape[:-2], dtype=np.int64))
        of, df, tn, tf = (_tile_fold(x, h, w, q) for x in (of, df, tn, tf))
    parts = [fn(scene.cluster_tris, scene.cluster_min, scene.cluster_max,
                of[s:s + chunk], df[s:s + chunk], tn[s:s + chunk],
                tf[s:s + chunk], cwoop=cwoop)
             for s in range(0, max(of.shape[0], 1), chunk)]
    single = not isinstance(parts[0], tuple)
    if single:
        parts = [(x,) for x in parts]
    out = [torch.cat(x) for x in zip(*parts)]
    if swizzle:
        out = [_tile_unfold(x, h, w, q) for x in out]
    return out[0] if single else tuple(out)


def intersect_closest(scene, o, d, tnear, tfar,
                      cfg: IntersectorConfig = IntersectorConfig()) -> Hit:
    """Closest-hit query (reference Intersection::getClosestIntersection)."""
    backend = _backend(scene, cfg)
    _log_query("closest", backend, o.shape[:-1])
    shape, of, df, tn, tf = _flat_rays(o, d, tnear, tfar)
    if backend == "fused":
        bt, bu, bv, btri = ray_tri.closest_hit(scene, of, df, tn, tf)
    else:
        bt, bu, bv, btri = ray_tri.ClosestHit.apply(
            functools.partial(_ptrace, cluster_trace.trace_closest, scene,
                              cfg, shape),
            ray_tri.woop_rows(scene), of, df, tn, tf)
    hit = (btri >= 0).reshape(shape)
    return Hit(t=torch.where(hit, bt.reshape(shape), 0.0),
               u=bu.reshape(shape), v=bv.reshape(shape),
               tri=btri.reshape(shape), hit=hit)


def intersect_any(scene, o, d, tnear, tfar,
                  cfg: IntersectorConfig = IntersectorConfig()):
    """Any-hit (shadow) query (reference rtcOccluded1 path) -> bool."""
    backend = _backend(scene, cfg)
    _log_query("any", backend, o.shape[:-1])
    shape, of, df, tn, tf = _flat_rays(o, d, tnear, tfar)
    if backend == "fused":
        return ray_tri.any_hit(scene, of, df, tn, tf).reshape(shape)
    return _ptrace(cluster_trace.trace_any, scene, cfg, shape, of.detach(),
                   df.detach(), tn.detach(), tf.detach()).reshape(shape)


def test_occlusion(scene, from_p, to_p, params,
                   cfg: IntersectorConfig = IntersectorConfig()):
    """Shadow test between two points with the reference's epsilon policy:
    tnear = tnear_offset, tfar = dist - tfar_offset
    (Intersection::testOcclusion, pg/Intersection.h:42-60). True where
    occluded."""
    seg = to_p - from_p
    dist = mathx.length(seg)
    return intersect_any(scene, from_p, mathx.normalize(seg),
                         torch.full_like(dist, params.tnear_offset),
                         dist - params.tfar_offset, cfg)


def hit_attributes(scene, o, d, hit: Hit) -> HitInfo:
    """Interpolate vertex attributes at hits (reference
    Intersection::getGeometryAttributes, pg/Intersection.h:8-113):
    barycentric interpolation, normal normalization, and the backface flip
    with from_inside tagging."""
    tri = torch.clamp(hit.tri, min=0)
    w = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    nt = scene.num_tris
    attr = torch.cat([
        scene.vtx_normal.reshape(nt, 9), scene.vtx_uv.reshape(nt, 6),
        scene.vtx_tangent.reshape(nt, 9),
        scene.tri_mat.to(torch.float32)[:, None]], dim=1)
    rows = mathx.take_rows(attr, tri)
    n = mathx.normalize(mathx.bary_interp(rows[..., 0:9], w))
    from_inside = (mathx.dot(-d, n) <= 0.0) & hit.hit
    n = torch.where(from_inside[..., None], -n, n)
    return HitInfo(
        did_hit=hit.hit, point=o + d * hit.t[..., None], normal=n,
        uv=mathx.bary_interp(rows[..., 9:15], w),
        tangent=mathx.bary_interp(rows[..., 15:24], w),
        from_inside=from_inside, dst=hit.t, tri=hit.tri,
        mat_id=torch.where(hit.hit, rows[..., 24].to(torch.int32), 0))
