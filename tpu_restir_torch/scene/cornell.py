"""The Cornell box (36 triangles), as `tpu_restir.scene.cornell.cornell_box`:
x in [-1,1], y in [-1,1], z in [0,2], light at the ceiling; camera
conventionally at (0, -3.9, 1) looking at (0, 0, 1). Z-up."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from tpu_restir_torch.scene.materials import MaterialSpec, MatType
from tpu_restir_torch.scene.scene import SceneArrays, build_scene


def _quad(p0, p1, p2, p3) -> List[np.ndarray]:
    """Two CCW triangles for the quad p0..p3."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return [np.stack([p0, p1, p2]), np.stack([p0, p2, p3])]


def _box(center, size, rot_z_deg=0.0) -> List[np.ndarray]:
    cx, cy, cz = center
    sx, sy, sz = (s / 2.0 for s in size)
    c, s = np.cos(np.radians(rot_z_deg)), np.sin(np.radians(rot_z_deg))

    def p(dx, dy, dz):
        x, y = dx * sx, dy * sy
        return np.array([cx + c * x - s * y, cy + s * x + c * y, cz + dz * sz],
                        np.float32)

    tris = []
    # +z top, -z bottom, and 4 sides; outward winding
    tris += _quad(p(-1, -1, 1), p(1, -1, 1), p(1, 1, 1), p(-1, 1, 1))
    tris += _quad(p(-1, 1, -1), p(1, 1, -1), p(1, -1, -1), p(-1, -1, -1))
    tris += _quad(p(-1, -1, -1), p(1, -1, -1), p(1, -1, 1), p(-1, -1, 1))
    tris += _quad(p(1, 1, -1), p(-1, 1, -1), p(-1, 1, 1), p(1, 1, 1))
    tris += _quad(p(1, -1, -1), p(1, 1, -1), p(1, 1, 1), p(1, -1, 1))
    tris += _quad(p(-1, 1, -1), p(-1, -1, -1), p(-1, -1, 1), p(-1, 1, 1))
    return tris


def cornell_box(device, light_size: float = 0.5,
                light_emission: Tuple[float, float, float] = (17.0, 12.0, 4.0),
                glossy_box: bool = False,
                mirror_box: bool = False) -> SceneArrays:
    tris: List[np.ndarray] = []
    mats: List[int] = []

    WHITE, RED, GREEN, LIGHT, TALL, SHORT = range(6)
    specs = [
        MaterialSpec("white", MatType.LAMBERT, diffuse=(0.73, 0.73, 0.73)),
        MaterialSpec("red", MatType.LAMBERT, diffuse=(0.65, 0.05, 0.05)),
        MaterialSpec("green", MatType.LAMBERT, diffuse=(0.12, 0.45, 0.15)),
        MaterialSpec("light", MatType.LAMBERT, diffuse=(0.78, 0.78, 0.78),
                     emission=light_emission),
        MaterialSpec("tall_box",
                     MatType.PHONG if glossy_box else
                     (MatType.MIRROR if mirror_box else MatType.LAMBERT),
                     diffuse=(0.35, 0.35, 0.45) if glossy_box else (0.73, 0.73, 0.73),
                     specular=(0.45, 0.45, 0.45) if (glossy_box or mirror_box) else (0.0,) * 3,
                     shininess=120.0),
        MaterialSpec("short_box", MatType.LAMBERT, diffuse=(0.73, 0.73, 0.73)),
    ]

    def add(ts, m):
        tris.extend(ts)
        mats.extend([m] * len(ts))

    # floor z=0 (normal +z), ceiling z=2 (normal -z), back wall y=+1
    add(_quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)), WHITE)
    add(_quad((-1, 1, 2), (1, 1, 2), (1, -1, 2), (-1, -1, 2)), WHITE)
    add(_quad((-1, 1, 0), (1, 1, 0), (1, 1, 2), (-1, 1, 2)), WHITE)   # back
    add(_quad((-1, -1, 0), (-1, 1, 0), (-1, 1, 2), (-1, -1, 2)), RED)  # left
    add(_quad((1, 1, 0), (1, -1, 0), (1, -1, 2), (1, 1, 2)), GREEN)    # right
    # ceiling light (slightly below ceiling, normal -z)
    h = light_size / 2.0
    z_l = 2.0 - 1e-3
    add(_quad((-h, h, z_l), (h, h, z_l), (h, -h, z_l), (-h, -h, z_l)), LIGHT)
    # boxes
    add(_box((-0.35, 0.30, 0.60), (0.6, 0.6, 1.2), rot_z_deg=15.0), TALL)
    add(_box((0.40, -0.35, 0.30), (0.6, 0.6, 0.6), rot_z_deg=-18.0), SHORT)

    return build_scene(np.stack(tris), np.array(mats), specs, device)
