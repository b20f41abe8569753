"""Procedural large scenes (counterpart of `tpu_restir.scene.procedural`):
a fractal-noise terrain (mostly flat, locally coherent, globally large)
and a random triangle soup (incoherent geometry, the traversal's worst
case). Both are clustered scenes. Z-up like all scenes."""

from __future__ import annotations

import numpy as np

from tpu_restir_torch.scene.materials import MaterialSpec, MatType
from tpu_restir_torch.scene.scene import SceneArrays, build_scene


def _fbm(n: int, rng: np.random.Generator, octaves: int = 5) -> np.ndarray:
    """Fractal value noise heightfield (n, n) in [0, 1]."""
    h = np.zeros((n, n), np.float64)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        cells = min(2 ** (o + 2), n)
        coarse = rng.standard_normal((cells + 1, cells + 1))
        # bilinear upsample to (n, n)
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


# the terrain's materials: ground, and the emissive panel ("sun")
TERRAIN_SPECS = [
    MaterialSpec("ground", MatType.LAMBERT, diffuse=(0.45, 0.42, 0.35)),
    MaterialSpec("sun", MatType.LAMBERT, diffuse=(0.78, 0.78, 0.78),
                 emission=(40.0, 36.0, 30.0)),
]


def terrain_scene(device, n_tris: int = 100_000, seed: int = 3,
                  extent: float = 10.0, height: float = 1.6) -> SceneArrays:
    """Heightfield terrain of at least n_tris triangles (a (g, g) vertex
    grid gives 2 (g-1)^2) with a 2-triangle emissive panel, the "sun",
    above it. Camera convention: stand near (0, -0.7 extent, ~2) and look
    at the origin."""
    rng = np.random.default_rng(seed)
    g = int(np.ceil(np.sqrt(n_tris / 2.0))) + 1
    hmap = _fbm(g, rng) * height

    xs = np.linspace(-extent / 2, extent / 2, g)
    vx, vy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([vx, vy, hmap], axis=-1).astype(np.float32)  # (g, g, 3)

    a = verts[:-1, :-1]
    b = verts[1:, :-1]
    c = verts[1:, 1:]
    d = verts[:-1, 1:]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)

    # the sun: high above the terrain, facing down
    zl = height + extent * 0.5
    s = extent * 0.15
    panel = np.array([[[-s, -s, zl], [s, s, zl], [s, -s, zl]],
                      [[-s, -s, zl], [-s, s, zl], [s, s, zl]]], np.float32)
    mats = np.concatenate([np.zeros(len(t1) + len(t2), np.int32),
                           np.ones(2, np.int32)])
    return build_scene(np.concatenate([t1, t2, panel]), mats, TERRAIN_SPECS,
                       device)


def triangle_soup(device, n_tris: int = 10_000, seed: int = 5,
                  extent: float = 2.0, tri_size: float = 0.08) -> SceneArrays:
    """Random small triangles in a cube, plus one emissive triangle above
    it so that the light CDF is valid."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n_tris, 1, 3))
    offs = rng.uniform(-tri_size, tri_size, (n_tris, 3, 3))
    tris = (centers + offs).astype(np.float32)
    light = np.array([[[-0.3, -0.3, extent + 0.5],
                       [0.3, 0.3, extent + 0.5],
                       [0.3, -0.3, extent + 0.5]]], np.float32)
    mats = np.concatenate([np.zeros(n_tris, np.int32),
                           np.ones(1, np.int32)])
    specs = [
        MaterialSpec("grey", MatType.LAMBERT, diffuse=(0.6, 0.6, 0.6)),
        MaterialSpec("light", MatType.LAMBERT, diffuse=(0.78, 0.78, 0.78),
                     emission=(20.0, 20.0, 20.0)),
    ]
    return build_scene(np.concatenate([tris, light]), mats, specs, device)
