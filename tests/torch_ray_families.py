"""Seeded ray families on which the ray/triangle tests of the port hold
their kernels and plain versions: random rays, rays that graze shared
edges of the Cornell box, determinants near 1e-18, u just above 1, and
v = -0.0. Shared by tests/test_torch_closest_skips.py (the CPU facts the
kernels' skips rest on) and tests/test_torch_cuda.py (the kernels on the
card)."""

import numpy as np

from tpu_restir_torch.scene.cornell import cornell_box

FAMILIES = ["random", "shared_edges", "tiny_det", "u_above_1", "v_neg_zero"]


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _aimed(g, tris, n, params):
    """n rays from random origins above the triangles to the points
    v0 + u e1 + v e2 for (u, v) drawn from params (k, 2), in float64."""
    k = g.integers(0, tris.shape[0], n)
    uv = params[g.integers(0, params.shape[0], n)]
    v0 = tris[k, 0].astype(np.float64)
    e1 = tris[k, 1] - v0
    e2 = tris[k, 2] - v0
    target = v0 + uv[:, :1] * e1 + uv[:, 1:] * e2
    o = target + g.uniform(-1.0, 1.0, (n, 3)) + np.array([0.0, 0.0, 2.0])
    return o, _unit(target - o)


def family(name, seed=0, n=4096):
    """(tris (T, 3, 3), o (n, 3), d (n, 3), tnear (n,), tfar (n,)), all
    float32 numpy, of a ray family."""
    g = np.random.default_rng(seed)
    if name == "random":
        tris = g.uniform(-1, 1, (64, 1, 3)) + g.uniform(-0.3, 0.3, (64, 3, 3))
        o = g.uniform(-2, 2, (n, 3))
        d = _unit(g.normal(size=(n, 3)))
    elif name == "shared_edges":
        # the Cornell box; rays from its camera at its vertices, the
        # midpoints of its edges and random points on its edges
        tris = cornell_box("cpu").tri_v.numpy().astype(np.float64)
        t = tris.shape[0]
        k = g.integers(0, t, n)
        a = g.integers(0, 3, n)
        s = np.where(g.random(n) < 0.5, g.choice([0.0, 0.5, 1.0], n),
                     g.random(n))[:, None]
        p = tris[k, a] * (1 - s) + tris[k, (a + 1) % 3] * s
        o = np.array([0.0, -3.9, 1.0]) + g.normal(0, 0.2, (n, 3))
        d = _unit(p - o)
    elif name == "tiny_det":
        # triangles in the plane z = 0, rays nearly parallel to it that
        # cross it near t = 2: det and dw of a few 1e-19 to 1e-17
        tris = np.zeros((64, 3, 3))
        tris[:, :, :2] = g.uniform(-1, 1, (64, 1, 2)) \
            + g.uniform(-0.5, 0.5, (64, 3, 2))
        k = g.integers(0, 64, n)
        c = tris[k].mean(1)
        th = g.uniform(0, 2 * np.pi, n)
        eps = g.choice([-1.0, 1.0], n) * 10.0 ** g.uniform(-19.5, -16.5, n)
        d = np.stack([np.cos(th), np.sin(th), eps], -1)
        o = c - 2.0 * d * g.choice([1.0, 1.001, 0.999], n)[:, None]
    elif name == "u_above_1":
        tris = g.uniform(-1, 1, (32, 1, 3)) + g.uniform(-0.5, 0.5, (32, 3, 3))
        ulp = 2.0 ** -23
        us = [1 + j * ulp for j in range(-4, 5)] \
            + [1 + 1e-5 + j * ulp for j in range(-4, 5)]
        vs = [0.0, 1e-7, -1e-7, 1e-3]
        params = np.array([(u, v) for u in us for v in vs])
        o, d = _aimed(g, tris, n, params)
    elif name == "v_neg_zero":
        # z = 0 triangles (0,0,0), (1,0,0), (0,-1,0) shifted by integers, so
        # that det < 0 for rays straight down; rays onto the edge v0 v1,
        # where v = 0 * (1 / det) = -0.0; and their mirror images (v = +0)
        shift = np.stack([g.integers(-3, 4, 32), g.integers(-3, 4, 32),
                          np.zeros(32)], -1).astype(np.float64)
        base = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
        tris = np.concatenate([base[None] + shift[:, None],
                               base[None, [0, 2, 1]] + shift[:, None]])
        k = g.integers(0, tris.shape[0], n)
        s = g.choice([0.0, 0.25, 0.5, 0.75, 1.0], n)[:, None]
        o = tris[k, 0] + s * (tris[k, 1] - tris[k, 0]) \
            + np.array([0.0, 0.0, 2.0])
        d = np.tile([0.0, 0.0, -1.0], (n, 1))
    else:
        raise ValueError(name)
    tn = np.full(n, 1e-3)
    tf = np.where(g.random(n) < 0.25, np.inf, g.uniform(0.5, 6.0, n))
    return tuple(np.asarray(x, np.float32) for x in (tris, o, d, tn, tf))
