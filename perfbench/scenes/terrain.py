"""A fractal-noise heightfield terrain of at least n_tris triangles (a
(g, g) vertex grid gives 2 (g - 1)^2) with a 2-triangle emissive panel,
the "sun", above it (a frozen copy of the port's `scene/procedural.py`
`_fbm` and `terrain_scene` array code)."""

from __future__ import annotations

import numpy as np

LAMBERT = 1   # MatType.LAMBERT


def _fbm(n: int, rng: np.random.Generator, octaves: int = 5) -> np.ndarray:
    """Fractal value noise heightfield (n, n) in [0, 1]."""
    h = np.zeros((n, n), np.float64)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        cells = min(2 ** (o + 2), n)
        coarse = rng.standard_normal((cells + 1, cells + 1))
        xs = np.linspace(0, cells, n)
        i0 = np.clip(xs.astype(np.int64), 0, cells - 1)
        f = xs - i0
        row = (coarse[i0] * (1 - f)[:, None] + coarse[i0 + 1] * f[:, None])
        h += amp * (row[:, i0] * (1 - f)[None, :]
                    + row[:, i0 + 1] * f[None, :])
        total += amp
        amp *= 0.5
    h /= total
    return (h - h.min()) / max(h.max() - h.min(), 1e-9)


def arrays(n_tris: int = 100_000, seed: int = 3, extent: float = 10.0,
           height: float = 1.6):
    rng = np.random.default_rng(seed)
    g = int(np.ceil(np.sqrt(n_tris / 2.0))) + 1
    hmap = _fbm(g, rng) * height
    xs = np.linspace(-extent / 2, extent / 2, g)
    vx, vy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([vx, vy, hmap], axis=-1).astype(np.float32)
    a = verts[:-1, :-1]
    b = verts[1:, :-1]
    c = verts[1:, 1:]
    d = verts[:-1, 1:]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)
    zl = height + extent * 0.5
    s = extent * 0.15
    panel = np.array([[[-s, -s, zl], [s, s, zl], [s, -s, zl]],
                      [[-s, -s, zl], [-s, s, zl], [s, s, zl]]], np.float32)
    mats = np.concatenate([np.zeros(len(t1) + len(t2), np.int32),
                           np.ones(2, np.int32)])
    specs = [
        dict(name="ground", mat_type=LAMBERT, diffuse=(0.45, 0.42, 0.35)),
        dict(name="sun", mat_type=LAMBERT, diffuse=(0.78, 0.78, 0.78),
             emission=(40.0, 36.0, 30.0)),
    ]
    return np.concatenate([t1, t2, panel]), mats, specs
