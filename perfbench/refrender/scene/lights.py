"""Emissive-triangle light sampling: area-weighted CDF (counterpart of
`tpu_restir.scene.lights`; reference pg/TriangleCDF.cpp:8-57). The pdf of
a sampled light point in area measure is 1/total_area."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.refrender import mathx, rng
from perfbench.refrender.render import sampling


@dataclasses.dataclass
class EmissiveCDF:
    tri_idx: torch.Tensor     # (L,) int32 scene triangle indices
    cdf: torch.Tensor         # (L,) float32 normalized cumulative areas
    areas: torch.Tensor       # (L,) float32
    total_area: torch.Tensor  # () float32

    @property
    def count(self) -> int:
        return self.tri_idx.shape[0]

    @property
    def is_valid(self) -> bool:
        """Static validity: gates all light sampling."""
        return self.count > 0


def build_emissive_cdf(tri_areas: np.ndarray, emissive_mask: np.ndarray,
                       device) -> EmissiveCDF:
    idx = np.nonzero(emissive_mask)[0].astype(np.int32)
    areas = tri_areas[idx].astype(np.float32)
    total = float(areas.sum())
    if len(idx) and total > 0:
        cdf = np.cumsum(areas / total).astype(np.float32)
        cdf[-1] = 1.0
    else:
        cdf = np.zeros((len(idx),), np.float32)
    return EmissiveCDF(
        tri_idx=torch.tensor(idx, device=device),
        cdf=torch.tensor(cdf, device=device),
        areas=torch.tensor(areas, device=device),
        total_area=torch.tensor(total, dtype=torch.float32, device=device))


def pick_light_index(u, lights: EmissiveCDF):
    """CDF pick -> index into the light list: std::lower_bound, the first
    cdf entry >= u."""
    k = torch.searchsorted(lights.cdf, u.contiguous(), right=False)
    return torch.clamp(k, 0, lights.count - 1)


def light_point_from_uniforms(u3, scene):
    """An emissive triangle and a uniform point on it from (..., 3)
    uniforms [cdf pick, r1, r2] (areaSampleLight's light side,
    pg/ReSTIRIntegrator.cpp:89-122). Returns a dict with point, normal,
    l_i, pdf_area (= 1/total_area) and the scene triangle index."""
    lights = scene.lights
    k = pick_light_index(u3[..., 0], lights)
    w = sampling.triangle_barycentrics_from_uniforms(u3[..., 1:3])
    li = lights.tri_idx.long()
    nl = li.shape[0]
    packed = torch.cat([
        scene.tri_v[li].reshape(nl, 9),
        scene.vtx_normal[li].reshape(nl, 9),
        mathx.take_rows(scene.materials.emission, scene.tri_mat[li].long()),
        li.to(torch.float32)[:, None]], dim=1)            # (L, 22)
    r = mathx.take_rows(packed, k)
    point = mathx.bary_interp(r[..., 0:9], w)
    normal = mathx.normalize(mathx.bary_interp(r[..., 9:18], w))
    return dict(point=point, normal=normal, l_i=r[..., 18:21],
                pdf_area=pdf_for_any_light_point(scene, w.shape[:-1]),
                tri=r[..., 21].to(torch.int32))


def sample_light_point(key, scene, shape):
    """light_point_from_uniforms of the draws of key at shape + (3,)."""
    return light_point_from_uniforms(
        rng.uniform(key, tuple(shape) + (3,), scene.tri_v.device), scene)


def pdf_for_any_light_point(scene, shape):
    """Area pdf of sampling any point on the emissive set: 1/total_area
    (reference TriangleCDF::getPDFForTriangle)."""
    return (1.0 / scene.lights.total_area).expand(shape)
