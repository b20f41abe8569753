"""Pinhole camera: ray generation and reprojection (counterpart of
`tpu_restir.render.camera`; reference pg/camera.cpp:12-84). Z-up look-at
frame, vertical-FOV focal length f_y = h / (2 tan(fov/2))."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_restir_torch.config import CameraConfig
from tpu_restir_torch import mathx, rng
from tpu_restir_torch.render import sampling


@dataclasses.dataclass
class Camera:
    pos: torch.Tensor           # (3,)
    view_at: torch.Tensor       # (3,)
    view_mat: torch.Tensor      # (4, 4) world -> camera (glm::lookAt)
    inv_view_dir: torch.Tensor  # (3, 3) camera -> world rotation
    focal: torch.Tensor         # () f_y in pixels


def look_at(eye, at, up):
    """glm::lookAt (host-side numpy): rows of R are (s, u, -f)."""
    eye = np.asarray(eye, np.float32)
    at = np.asarray(at, np.float32)
    up = np.asarray(up, np.float32)

    def nrm(v):
        return v / max(np.linalg.norm(v), 1e-20)

    f = nrm(at - eye)
    s = nrm(np.cross(f, up))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[0, 3] = s, -np.dot(s, eye)
    m[1, :3], m[1, 3] = u, -np.dot(u, eye)
    m[2, :3], m[2, 3] = -f, np.dot(f, eye)
    return m


def make_camera(cfg: CameraConfig, device, view_from=None,
                view_at=None) -> Camera:
    """The camera on `device`; the orthonormal up is recomputed from the
    world up as Camera::recalculate_m_c_w (pg/camera.cpp:44-58)."""
    eye = np.asarray(view_from if view_from is not None else cfg.view_from,
                     np.float32)
    at = np.asarray(view_at if view_at is not None else cfg.view_at,
                    np.float32)
    up = np.asarray(cfg.up, np.float32)

    def nrm(v):
        return v / max(np.linalg.norm(v), 1e-20)

    z_c = nrm(eye - at)
    x_c = nrm(np.cross(up, z_c))
    y_c = nrm(np.cross(z_c, x_c))
    vm = look_at(eye, at, y_c)
    focal = cfg.height / (2.0 * np.tan(np.radians(cfg.fov_y_deg) / 2.0))

    def dev(a):
        return torch.tensor(np.ascontiguousarray(a, np.float32), device=device)

    return Camera(pos=dev(eye), view_at=dev(at), view_mat=dev(vm),
                  inv_view_dir=dev(vm[:3, :3].T), focal=dev(focal))


def generate_rays_at(cam: Camera, cfg: CameraConfig, frame_seed, ys, xs):
    """Primary rays for the GLOBAL integer pixel grid (ys, xs): origins and
    unit dirs shaped like ys + (3,). Pixel (x, y) + AA offset maps to the
    camera-space direction (x+sx - w/2, h/2 - (y+sy), -f_y)."""
    h, w = cfg.height, cfg.width
    u4 = rng.pixel_uniforms(frame_seed,
                            rng.stream_id(rng.PASS_PIXEL_JITTER), ys, xs, 4)
    jitter = sampling.pixel_offsets_u(u4, cfg.pixel_sampler, cfg.jitter_grid)
    dx = xs.to(torch.float32) + jitter[..., 0] - w / 2.0
    dy = h / 2.0 - (ys.to(torch.float32) + jitter[..., 1])
    dz = -cam.focal.expand(dx.shape)
    m = cam.inv_view_dir
    d_w = torch.stack([dx * m[i, 0] + dy * m[i, 1] + dz * m[i, 2]
                       for i in range(3)], dim=-1)
    d_w = mathx.normalize(d_w)
    return cam.pos.expand(d_w.shape), d_w


def project_to_screen(cam_view_mat, focal, width, height, ws_pos):
    """World position -> integer pixel coords + validity, per the
    reference reprojection (pg/ReSTIRIntegrator.cpp:544-565). Invalid when
    behind the camera or off screen."""
    p = ws_pos
    m = cam_view_mat

    def row(i):
        return p[..., 0] * m[i, 0] + p[..., 1] * m[i, 1] \
            + p[..., 2] * m[i, 2] + m[i, 3]

    vx, vy, vz = row(0), row(1), row(2)
    in_front = vz < 0.0
    vz_safe = torch.where(in_front, vz, -1.0)
    sx = torch.round((-vx / vz_safe) * focal + width / 2.0).to(torch.int32)
    sy = torch.round((vy / vz_safe) * focal + height / 2.0).to(torch.int32)
    on_screen = (sx >= 0) & (sx <= width - 1) & (sy >= 0) & (sy <= height - 1)
    return sx, sy, in_front & on_screen
