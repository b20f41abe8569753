"""Packed reuse payload: every per-pixel field that a neighbour or
reprojection tap reads, concatenated into one channel-packed float32
image, so that one gather (kernel K3) serves all taps. The layouts are
those of `tpu_restir.render.integrators.restir.packed`.

Full layout (32 = 19 + 13):
  G-buffer: pos 0:3, normal 3:6, diffuse 6:9, specular 9:12,
            emission 12:15, shininess 15, depth 16, inv_i_m 17,
            mat_type (int32 bits) 18
  Reservoir: point 19:22, normal 22:25, l_i 25:28, valid 28, w_sum 29,
             w 30, confidence 31
Slim layout (24 = 12 + 12), taken when no material of the scene has a
specular lobe (`reuse_slim`; the Cornell box):
  G-buffer: pos 0:3, normal 3:6, diffuse 6:9, emissive flag 9, depth 10,
            mat_type 11
  Reservoir: point 0:3, normal 3:6, l_i 6:9, valid 9, w 10,
             confidence 11 (w_sum is never read at a tap)
"""

from __future__ import annotations

import torch

from tpu_restir_torch.render.integrators.restir.gbuffer import GBuffer
from tpu_restir_torch.render.integrators.restir.reservoir import (
    LightSample, Reservoir)
from tpu_restir_torch.scene.materials import MatType

GB_CH = 19
GB_CH_SLIM = 12

# Types whose BRDF eval reads specular/shininess/inv_i_m at a surface. The
# set omits NORMAL as the reference's does (a known defect of the
# reference, kept for parity; ROADMAP queue 3).
_SPEC_TYPES = frozenset({MatType.PHONG, MatType.MIRROR, MatType.DIELECTRIC,
                         MatType.TRANSPARENT, MatType.UNSUPPORTED,
                         MatType.TS})


def reuse_slim(materials) -> bool:
    """Static: may the payload drop the specular channel group? True when
    the table's types are known and none is specular-lobed."""
    tp = materials.types_present
    return bool(tp) and not (set(tp) & _SPEC_TYPES)


def gb_ch(slim: bool) -> int:
    return GB_CH_SLIM if slim else GB_CH


def pack_gb(gb: GBuffer, slim: bool = False):
    """(h, w) GBuffer -> (h, w, 19|12) float32 payload."""
    if slim:
        flag = torch.any(gb.emission > 0.0, dim=-1).to(torch.float32)
        return torch.cat([gb.pos, gb.normal, gb.diffuse, flag[..., None],
                          gb.depth[..., None],
                          gb.mat_type.to(torch.float32)[..., None]], dim=-1)
    mt = gb.mat_type.to(torch.int32).view(torch.float32)
    return torch.cat([gb.pos, gb.normal, gb.diffuse, gb.specular,
                      gb.emission, gb.shininess[..., None],
                      gb.depth[..., None], gb.inv_i_m[..., None],
                      mt[..., None]], dim=-1)


def unpack_gb(a, cam_of: GBuffer, slim: bool = False) -> GBuffer:
    """(..., 19|12) payload -> GBuffer view with cam_of's camera snapshot.
    Slim taps rebuild the dropped fields with values that are dead for
    Lambert-only scenes (specular 0, shininess 0, inv_i_m 1) and the
    emissive flag in emission channel 0."""
    cam = dict(cam_pos=cam_of.cam_pos, view_mat=cam_of.view_mat,
               focal=cam_of.focal)
    if slim:
        z3 = torch.zeros(a.shape[:-1] + (3,), dtype=a.dtype, device=a.device)
        z1 = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
        return GBuffer(
            pos=a[..., 0:3], normal=a[..., 3:6], diffuse=a[..., 6:9],
            specular=z3, emission=torch.cat([a[..., 9:10], z3[..., :2]],
                                            dim=-1),
            shininess=z1, depth=a[..., 10], inv_i_m=torch.ones_like(z1),
            mat_type=a[..., 11].to(torch.int32), **cam)
    return GBuffer(
        pos=a[..., 0:3], normal=a[..., 3:6], diffuse=a[..., 6:9],
        specular=a[..., 9:12], emission=a[..., 12:15],
        shininess=a[..., 15], depth=a[..., 16], inv_i_m=a[..., 17],
        mat_type=a[..., 18].view(torch.int32), **cam)


def pack_res(res: Reservoir, slim: bool = False):
    """(h, w) Reservoir -> (h, w, 13|12) float32 payload."""
    s = res.sample
    cols = [s.point, s.normal, s.l_i, s.valid.to(torch.float32)[..., None]]
    if not slim:
        cols.append(res.w_sum[..., None])
    cols += [res.w[..., None], res.confidence[..., None]]
    return torch.cat(cols, dim=-1)


def unpack_res(a, slim: bool = False) -> Reservoir:
    """(..., 13|12) payload -> Reservoir view (slim taps read w_sum as 0)."""
    sample = LightSample(point=a[..., 0:3], normal=a[..., 3:6],
                         l_i=a[..., 6:9], valid=a[..., 9] > 0.5)
    if slim:
        return Reservoir(sample=sample, w_sum=torch.zeros_like(a[..., 10]),
                         w=a[..., 10], confidence=a[..., 11])
    return Reservoir(sample=sample, w_sum=a[..., 10], w=a[..., 11],
                     confidence=a[..., 12])


def pack_reuse(gb: GBuffer, res: Reservoir, slim: bool = False):
    """Combined (h, w, 32|24) payload for spatial-reuse taps."""
    return torch.cat([pack_gb(gb, slim), pack_res(res, slim)], dim=-1)
