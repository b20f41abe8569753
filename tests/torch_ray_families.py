"""Seeded ray families on which the ray/triangle tests of the port hold
their kernels and plain versions: random rays, rays that graze shared
edges of the Cornell box, determinants near 1e-18, u just above 1, and
v = -0.0 (FAMILIES); and, for the slab cull of the any-hit kernel, rays
that graze the triangles' own boxes (ANY_FAMILIES adds "box_grazing").
Shared by tests/test_torch_closest_skips.py and
tests/test_torch_any_skips.py (the CPU facts the kernels' skips rest on)
and tests/test_torch_cuda.py (the kernels on the card)."""

import numpy as np

from tpu_restir_torch.scene.cornell import cornell_box

FAMILIES = ["random", "shared_edges", "tiny_det", "u_above_1", "v_neg_zero"]
ANY_FAMILIES = FAMILIES + ["box_grazing"]


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


def _grazing_tris(g):
    """48 triangles: 16 random ones, 16 flat right triangles with legs
    along the axes (boxes of zero thickness), and 8 terrain cells of two
    triangles (legs along x and y, heights random), so that triangle
    edges lie in the planes of their boxes' faces."""
    rand = g.uniform(-1, 1, (16, 1, 3)) + g.uniform(-0.5, 0.5, (16, 3, 3))
    flat = np.zeros((16, 3, 3))
    for i in range(16):
        a = i % 3                              # the constant axis
        b, c = (a + 1) % 3, (a + 2) % 3
        p = g.uniform(-1, 1, 3)
        s = g.uniform(0.2, 1.0, 2) * g.choice([-1.0, 1.0], 2)
        flat[i] = p
        flat[i, 1, b] += s[0]
        flat[i, 2, c] += s[1]
    cells = []
    for _ in range(8):
        x, y = g.uniform(-1, 1, 2)
        s = g.uniform(0.2, 0.6)
        h = g.uniform(-0.3, 0.3, 4)
        p00, p10 = [x, y, h[0]], [x + s, y, h[1]]
        p01, p11 = [x, y + s, h[2]], [x + s, y + s, h[3]]
        cells += [[p00, p10, p01], [p11, p01, p10]]
    return np.concatenate([rand, flat, np.array(cells)])


def _box_grazing(g, n):
    """Rays against `_grazing_tris`, four quarters: segments aimed at the
    triangles' corners, edges and insides that end within 1e-6 to 1e-4 of
    the box entry or of the target; rays lying in the plane of a box face
    (the component along its axis +0.0 or -0.0) through a triangle point
    in that plane; origins inside the box (some on its faces and
    corners); and rays through a triangle point whose component along one
    axis is +-{0.5, 0.99, 1, 1.01, 2} x 1e-20. -> tris, o, d, tn, tf, in
    float64 (tn 1e-3)."""
    tris = _grazing_tris(g)
    t = tris.shape[0]
    lo, hi = tris.min(1), tris.max(1)
    q = n // 4
    # 1. segments ending near the box entry or near the target
    corners = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.5, 0.0],
                        [0.0, 0.5], [0.5, 0.5], [0.2, 0.3]])
    k = g.integers(0, t, q)
    uv = corners[g.integers(0, corners.shape[0], q)]
    v0 = tris[k, 0]
    target = v0 + uv[:, :1] * (tris[k, 1] - v0) + uv[:, 1:] * (tris[k, 2] - v0)
    o1 = target + g.uniform(-1.0, 1.0, (q, 3)) * np.array([1.0, 1.0, 0.5]) \
        + np.array([0.0, 0.0, 1.5])
    d1 = _unit(target - o1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ta = (lo[k] - o1) / d1
        tb = (hi[k] - o1) / d1
    entry = np.nanmax(np.minimum(ta, tb), 1)
    end = np.where(g.random(q) < 0.5, entry, np.linalg.norm(target - o1,
                                                            axis=1))
    tf1 = end + g.choice([-1.0, 1.0], q) * 10.0 ** g.uniform(-6, -4, q)
    # 2. rays in the plane of a box face, through a triangle point in it
    o2, d2 = np.zeros((q, 3)), np.zeros((q, 3))
    for i in range(q):
        kk = g.integers(0, t)
        a = g.integers(0, 3)
        face = hi[kk, a] if g.random() < 0.5 else lo[kk, a]
        on = tris[kk][tris[kk][:, a] == face]
        s = g.random() if g.random() < 0.7 else g.choice([0.0, 0.5, 1.0])
        p = on[0] * (1 - s) + on[-1] * s
        p[a] = face
        off = g.normal(size=3)
        off[a] = 0.0
        o2[i] = p + off / np.linalg.norm(off) * g.uniform(0.3, 2.0)
        o2[i, a] = face
        d2[i] = _unit(p - o2[i])
        d2[i, a] = 0.0 if g.random() < 0.5 else -0.0
    # 3. origins inside the box, some on its faces and corners
    k = g.integers(0, t, q)
    w = g.random((q, 3))
    w = np.where(g.random((q, 3)) < 0.3, g.choice([0.0, 1.0], (q, 3)), w)
    o3 = lo[k] + w * (hi[k] - lo[k])
    d3 = _unit(g.normal(size=(q, 3)))
    axis = g.random(q) < 0.3
    d3[axis] = np.eye(3)[g.integers(0, 3, int(axis.sum()))] \
        * g.choice([-1.0, 1.0], (int(axis.sum()), 1))
    # 4. a component near 1e-20, through a triangle point
    r = n - 3 * q
    k = g.integers(0, t, r)
    uv = g.dirichlet([1.0, 1.0, 1.0], r)
    p = (uv[:, :, None] * tris[k]).sum(1)
    o4 = p + _unit(g.normal(size=(r, 3))) * g.uniform(0.5, 2.0, (r, 1))
    d4 = _unit(p - o4)
    a = g.integers(0, 3, r)
    tiny = g.choice([0.5, 0.99, 1.0, 1.01, 2.0], r) * 1e-20 \
        * g.choice([-1.0, 1.0], r)
    d4[np.arange(r), a] = tiny
    o4[np.arange(r), a] = p[np.arange(r), a]
    o = np.concatenate([o1, o2, o3, o4])
    d = np.concatenate([d1, d2, d3, d4])
    m = n - q
    tf = np.concatenate([tf1, np.where(g.random(m) < 0.25, np.inf,
                                       g.uniform(0.5, 6.0, m))])
    return tris, o, d, np.full(n, 1e-3), tf


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
    elif name == "box_grazing":
        return tuple(np.asarray(x, np.float32)
                     for x in _box_grazing(g, n))
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
