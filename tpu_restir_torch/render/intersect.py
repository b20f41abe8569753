"""Ray-scene intersection (counterpart of `tpu_restir.render.intersect`,
cut to the small-scene path): closest-hit and occlusion queries go to the
ray/triangle kernels K1 and K2 (`kernels/ray_tri.py`), which is the JAX
package's "fused" backend (intersect.py:697-709, :742-750). The clustered
traversal for large scenes is not ported yet (ROADMAP item 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_restir_torch.config import IntersectorConfig
from tpu_restir_torch import mathx
from tpu_restir_torch.kernels import ray_tri

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
    if cfg.backend not in ("auto", "fused"):
        raise NotImplementedError(
            f"intersection backend {cfg.backend!r} is not ported; only the "
            "small-scene kernels are ('auto' or 'fused'; ROADMAP item 8)")
    if not ray_tri.supports(scene, cfg.fused_max_tris):
        raise NotImplementedError(
            f"{scene.num_tris} triangles exceed fused_max_tris="
            f"{cfg.fused_max_tris}; large scenes need the clustered "
            "traversal, not ported yet (ROADMAP item 8)")
    return "fused"


def _flat_rays(o, d, tnear, tfar):
    shape = o.shape[:-1]

    def flat(x):
        return torch.as_tensor(x, dtype=torch.float32, device=o.device) \
            .expand(shape).reshape(-1).contiguous()

    return (shape, o.reshape(-1, 3).contiguous(),
            d.reshape(-1, 3).contiguous(), flat(tnear), flat(tfar))


def intersect_closest(scene, o, d, tnear, tfar,
                      cfg: IntersectorConfig = IntersectorConfig()) -> Hit:
    """Closest-hit query (reference Intersection::getClosestIntersection)."""
    backend = _backend(scene, cfg)
    _log_query("closest", backend, o.shape[:-1])
    shape, of, df, tn, tf = _flat_rays(o, d, tnear, tfar)
    bt, bu, bv, btri = ray_tri.closest_hit(scene, of, df, tn, tf)
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
    return ray_tri.any_hit(scene, of, df, tn, tf).reshape(shape)


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
