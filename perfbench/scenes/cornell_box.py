"""The Cornell box, 36 triangles: x in [-1, 1], y in [-1, 1], z in [0, 2],
a 0.5 x 0.5 light under the ceiling, two boxes (a frozen copy of the
port's `scene/cornell.py` `cornell_box` with its default arguments)."""

from __future__ import annotations

import numpy as np

LAMBERT = 1   # MatType.LAMBERT


def _quad(p0, p1, p2, p3):
    """Two CCW triangles for the quad p0..p3."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return [np.stack([p0, p1, p2]), np.stack([p0, p2, p3])]


def _box(center, size, rot_z_deg=0.0):
    cx, cy, cz = center
    sx, sy, sz = (s / 2.0 for s in size)
    c, s = np.cos(np.radians(rot_z_deg)), np.sin(np.radians(rot_z_deg))

    def p(dx, dy, dz):
        x, y = dx * sx, dy * sy
        return np.array([cx + c * x - s * y, cy + s * x + c * y, cz + dz * sz],
                        np.float32)

    tris = []
    tris += _quad(p(-1, -1, 1), p(1, -1, 1), p(1, 1, 1), p(-1, 1, 1))
    tris += _quad(p(-1, 1, -1), p(1, 1, -1), p(1, -1, -1), p(-1, -1, -1))
    tris += _quad(p(-1, -1, -1), p(1, -1, -1), p(1, -1, 1), p(-1, -1, 1))
    tris += _quad(p(1, 1, -1), p(-1, 1, -1), p(-1, 1, 1), p(1, 1, 1))
    tris += _quad(p(1, -1, -1), p(1, 1, -1), p(1, 1, 1), p(1, -1, 1))
    tris += _quad(p(-1, 1, -1), p(-1, -1, -1), p(-1, -1, 1), p(-1, 1, 1))
    return tris


def arrays(light_size: float = 0.5,
           light_emission=(17.0, 12.0, 4.0)):
    white, red, green, light, tall, short = range(6)
    specs = [
        dict(name="white", mat_type=LAMBERT, diffuse=(0.73, 0.73, 0.73)),
        dict(name="red", mat_type=LAMBERT, diffuse=(0.65, 0.05, 0.05)),
        dict(name="green", mat_type=LAMBERT, diffuse=(0.12, 0.45, 0.15)),
        dict(name="light", mat_type=LAMBERT, diffuse=(0.78, 0.78, 0.78),
             emission=tuple(light_emission)),
        dict(name="tall_box", mat_type=LAMBERT, diffuse=(0.73, 0.73, 0.73),
             specular=(0.0, 0.0, 0.0), shininess=120.0),
        dict(name="short_box", mat_type=LAMBERT, diffuse=(0.73, 0.73, 0.73)),
    ]
    tris, mats = [], []

    def add(ts, m):
        tris.extend(ts)
        mats.extend([m] * len(ts))

    add(_quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)), white)
    add(_quad((-1, 1, 2), (1, 1, 2), (1, -1, 2), (-1, -1, 2)), white)
    add(_quad((-1, 1, 0), (1, 1, 0), (1, 1, 2), (-1, 1, 2)), white)
    add(_quad((-1, -1, 0), (-1, 1, 0), (-1, 1, 2), (-1, -1, 2)), red)
    add(_quad((1, 1, 0), (1, -1, 0), (1, -1, 2), (1, 1, 2)), green)
    h = light_size / 2.0
    z_l = 2.0 - 1e-3
    add(_quad((-h, h, z_l), (h, h, z_l), (h, -h, z_l), (-h, -h, z_l)), light)
    add(_box((-0.35, 0.30, 0.60), (0.6, 0.6, 1.2), rot_z_deg=15.0), tall)
    add(_box((0.40, -0.35, 0.30), (0.6, 0.6, 0.6), rot_z_deg=-18.0), short)
    return np.stack(tris), np.array(mats, np.int32), specs
