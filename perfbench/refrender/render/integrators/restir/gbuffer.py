"""Screen-space G-buffer and its fill pass (counterpart of
`tpu_restir.render.integrators.restir.gbuffer`; reference
GBufferElement, pg/GBufferElement.h:6-140, and gBufferFillPass,
pg/ReSTIRIntegrator.cpp:213-234). The camera snapshot (pos, view matrix,
focal length) rides along for reprojection."""

from __future__ import annotations

import dataclasses

import torch

from perfbench.refrender import mathx
from perfbench.refrender.mathx.special import calc_i_m
from perfbench.refrender.render import camera as cam_mod, intersect
from perfbench.refrender.scene.envmap import sky_radiance
from perfbench.refrender.scene.materials import (MatType, apply_normal_map,
                                              apply_textures,
                                              gather_materials)


@dataclasses.dataclass
class GBuffer:
    pos: torch.Tensor        # (..., 3) world-space position
    normal: torch.Tensor     # (..., 3)
    diffuse: torch.Tensor    # (..., 3)
    specular: torch.Tensor   # (..., 3)
    emission: torch.Tensor   # (..., 3) (sky/bg radiance on a miss)
    shininess: torch.Tensor  # (...,)
    depth: torch.Tensor      # (...,)
    mat_type: torch.Tensor   # (...,) int32
    inv_i_m: torch.Tensor    # (...,) cached 1/I_M for the camera direction
    cam_pos: torch.Tensor    # (3,)
    view_mat: torch.Tensor   # (4, 4)
    focal: torch.Tensor      # ()

    def is_emissive(self):
        """Pixels displayed directly (lights and environment)."""
        return torch.any(self.emission > 0.0, dim=-1)


def empty_gbuffer(h: int, w: int, device) -> GBuffer:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return GBuffer(
        pos=z(h, w, 3), normal=z(h, w, 3), diffuse=z(h, w, 3),
        specular=z(h, w, 3), emission=z(h, w, 3), shininess=z(h, w),
        depth=z(h, w), mat_type=z(h, w, dtype=torch.int32),
        inv_i_m=torch.ones((h, w), device=device), cam_pos=z(3),
        view_mat=torch.eye(4, device=device), focal=z())


def gbuffer_fill(scene, cam, cfg, frame_seed, ys, xs) -> GBuffer:
    """PASS 1: primary visibility -> surface attributes. Misses store the
    sky/bg radiance in the emission channel, so they are displayed
    directly and excluded from resampling."""
    p = cfg.params
    o, d = cam_mod.generate_rays_at(cam, cfg.camera, frame_seed, ys, xs)
    hit = intersect.intersect_closest(scene, o, d, p.tnear_offset, torch.inf,
                                      cfg.intersector)
    hi = intersect.hit_attributes(scene, o, d, hit)
    m = gather_materials(scene.materials, hi.mat_id)
    m = apply_textures(scene, m, hi.uv)
    normal = apply_normal_map(scene, m, hi.normal, hi.tangent, hi.uv)
    sky = sky_radiance(scene, p, d)

    n_dot_v = mathx.dot(mathx.normalize(cam.pos - hi.point), normal)
    inv_i_m = 1.0 / calc_i_m(n_dot_v, m.shininess)

    h3 = hi.did_hit[..., None]
    return GBuffer(
        pos=torch.where(h3, hi.point, 0.0),
        normal=torch.where(h3, normal, 0.0),
        diffuse=torch.where(h3, m.diffuse, 0.0),
        specular=torch.where(h3, m.specular, 0.0),
        emission=torch.where(h3, m.emission, sky),
        shininess=torch.where(hi.did_hit, m.shininess, 0.0),
        depth=torch.where(hi.did_hit, hi.dst, 0.0),
        # TS reports LAMBERT to the screen-space layer (faithful quirk)
        mat_type=torch.where(
            hi.did_hit,
            torch.where(m.mat_type == MatType.TS, MatType.LAMBERT,
                        m.mat_type), 0).to(torch.int32),
        inv_i_m=torch.where(hi.did_hit, inv_i_m, 1.0),
        cam_pos=cam.pos, view_mat=cam.view_mat, focal=cam.focal)
