"""The port's intersection backends brute, woop_mxu, cluster, fcluster and
bvh against the JAX package's same backends on the CPU, with their
structures (the wide BVH, the BVH2 arrays), the backend choice and its
refusals, and the repaired slab test. The slice as a whole (frames and
passes under these backends) is tests/test_torch_backends_frame.py.

The JAX side runs as its own tests run it: plain XLA, no Pallas kernel.

Tolerances. Hit and occlusion masks are exact on these random-ray
families, and so are triangle ids, except between coplanar triangles hit
at the same t (a ray from inside one of Cornell's boxes meets its bottom
face and the floor at one point; one rounding picks the winner), fewer
than 1% of the rays. t, u and v: XLA's CPU code contracts the products
and sums of both tests into fused multiply-adds (and sums its Woop dot in
an order of its own), while the port keeps K1's and K5's unfused order,
so t agrees within rtol 1e-6 and atol 1e-6 (atol for t near 0, where a
relative bound means nothing), and u and v within rtol 1e-6 plus 64
float32 ulps of their conditioning: one rounding in the products of the
test moves u by about |o - v0| |e2| / |det| ulps (v likewise with e1),
which is 2.3e-6 absolute for the camera fan, 4 units from Cornell's
2-unit walls, and 8.3e-6 on triangle_soup's small triangles
(`_uv_bounds`). Gradients of sum(hit g t) in o
and d: rtol 1e-5, atol 1e-5 of the largest entry of the JAX gradient.
Frames and passes: tests/test_torch_restir_large.py's tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir.accel import traverse as jtraverse
from tpu_restir.accel import wide as jwide
from tpu_restir.accel.bvh import build_bvh2 as j_build_bvh2
from tpu_restir.config import IntersectorConfig as JConfig
from tpu_restir.render import intersect as jintersect
from tpu_restir.scene.cornell import cornell_box as j_cornell
from tpu_restir.scene.cornell import many_lights_scene as j_many_lights
from tpu_restir.scene.materials import MaterialSpec as JMaterialSpec
from tpu_restir.scene.procedural import triangle_soup as j_soup
from tpu_restir.scene.scene import build_scene as j_build_scene
from tpu_restir_torch import convert, tracing
from tpu_restir_torch.accel import bvh as tbvh
from tpu_restir_torch.accel import traverse as ttraverse
from tpu_restir_torch.accel import wide as twide
from tpu_restir_torch.config import IntersectorConfig
from tpu_restir_torch.render import intersect as tintersect
from tpu_restir_torch.scene.cornell import cornell_box as t_cornell
from tpu_restir_torch.scene.cornell import many_lights_scene as t_many_lights
from tpu_restir_torch.scene.materials import MaterialSpec
from tpu_restir_torch.scene.procedural import triangle_soup as t_soup
from tpu_restir_torch.scene.scene import SceneArrays, build_scene

TOL = dict(rtol=1e-6, atol=1e-6)          # t against the JAX backend
UV_ULPS = 64      # u, v: rtol 1e-6 plus this many ulps of their conditioning
GRAD_RTOL = 1e-5
MAX_DIFF_SHARE = 0.01
N_RAYS = 512
CORNELL_VIEW = (0.0, -3.9, 1.0)   # the Cornell camera

SCENES = {
    "cornell": (j_cornell, lambda: t_cornell("cpu")),
    "lights200": (lambda: j_many_lights(200),
                  lambda: t_many_lights("cpu", 200)),
    "soup3000": (lambda: j_soup(3000), lambda: t_soup("cpu", 3000)),
}


@pytest.fixture(scope="module")
def scenes():
    return {k: (j(), t()) for k, (j, t) in SCENES.items()}


def _rays(seed, n=N_RAYS, grid=None):
    """Random rays from the box [-1, 1]^2 x [0, 2], or (grid = (h, w)) a
    pinhole fan from the Cornell camera; tnear 1e-3, tfar 1e4 (closest)
    and 1.5 (any)."""
    g = np.random.default_rng(seed)
    if grid is None:
        o = g.uniform([-1, -1, 0], [1, 1, 2], (n, 3)).astype(np.float32)
        d = g.standard_normal((n, 3)).astype(np.float32)
    else:
        h, w = grid
        o = np.tile(np.array(CORNELL_VIEW, np.float32), (h, w, 1))
        ys, xs = np.meshgrid((np.arange(h) + 0.5) / h - 0.5,
                             (np.arange(w) + 0.5) / w - 0.5, indexing="ij")
        d = np.stack([xs * 0.8, np.ones_like(xs), -ys * 0.8 + 0.05],
                     -1).astype(np.float32)
        d += g.normal(0, 1e-3, d.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _query(kind, js, ts, o, d, jcfg, tcfg):
    # the camera fan (2-D rays) starts 3.9 from the box: occluded within
    # 4.5 where it meets a box or the floor first
    tf = 1e4 if kind == "closest" else (4.5 if o.ndim == 3 else 1.5)
    if kind == "closest":
        jh = jintersect.intersect_closest(js, jnp.asarray(o), jnp.asarray(d),
                                          1e-3, tf, jcfg)
        th = tintersect.intersect_closest(ts, torch.from_numpy(o),
                                          torch.from_numpy(d), 1e-3, tf,
                                          tcfg)
        return jax.tree.map(np.asarray, jh), th
    jo = jintersect.intersect_any(js, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                  tf, jcfg)
    return np.asarray(jo), tintersect.intersect_any(
        ts, torch.from_numpy(o), torch.from_numpy(d), 1e-3, tf, tcfg)


CASES = [
    ("cornell", "brute", {}, None),
    ("cornell", "woop_mxu", {}, None),
    ("lights200", "cluster", {}, None),
    ("lights200", "fcluster", {}, None),
    ("lights200", "fcluster", {"bin_rays": True}, None),
    ("lights200", "fcluster", {"shortlist_k": 1}, None),
    ("lights200", "fcluster", {}, (16, 32)),
    ("lights200", "bvh", {}, None),
    ("soup3000", "bvh", {}, None),
]


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("scene,backend,extra,grid", CASES)
def test_backend_matches_jax(scenes, scene, backend, extra, grid, kind):
    js, ts = scenes[scene]
    o, d = _rays(len(scene) + len(backend), grid=grid)
    jcfg = JConfig(backend=backend, **extra)
    tcfg = IntersectorConfig(backend=backend, **extra)
    with tracing.recording() as rec:
        want, got = _query(kind, js, ts, o, d, jcfg, tcfg)
    log = tintersect.queries(rec)
    assert log == [{"kind": kind, "backend": backend,
                    "rays": int(np.prod(o.shape[:-1]))}]
    if kind == "any":
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < want.size
        return
    np.testing.assert_array_equal(got.hit.numpy(), want.hit)
    hit = want.hit
    assert hit.sum() >= 50
    # ids differ only between coplanar triangles at the same t (Cornell's
    # box bottoms lie on its floor), where one rounding picks the winner
    tie = hit & (got.tri.numpy() != want.tri)
    assert tie.mean() < MAX_DIFF_SHARE
    np.testing.assert_allclose(got.t.numpy()[hit], want.t[hit], **TOL)
    same = hit & ~tie
    for f, bound in zip(("u", "v"), _uv_bounds(ts, o, d, want.tri)):
        g, w = getattr(got, f).numpy()[same], getattr(want, f)[same]
        assert (np.abs(g - w) <= 1e-6 * np.abs(w) + bound[same]).all(), \
            (f, np.abs(g - w).max())


def _uv_bounds(ts, o, d, tri):
    """Per-ray absolute bounds on the difference in u and v that one
    rounding apart in the test's products can make: UV_ULPS float32 ulps
    of |o - v0| |e2| / |det| (u) and |o - v0| |e1| / |det| (v) of the
    winning triangle (u = (o - v0).(d x e2) / det, v = d.((o - v0) x e1)
    / det)."""
    t = np.maximum(tri, 0)
    v0, e1, e2 = (x.numpy().astype(np.float64)[t]
                  for x in (ts.tri_v0, ts.tri_e1, ts.tri_e2))
    o, d = o.reshape(t.shape + (3,)), d.reshape(t.shape + (3,))
    det = np.abs((e1 * np.cross(d, e2)).sum(-1))
    tv = np.linalg.norm(o - v0, axis=-1)
    ulp = UV_ULPS * 2.0 ** -24
    return (ulp * tv * np.linalg.norm(e2, axis=-1) / det,
            ulp * tv * np.linalg.norm(e1, axis=-1) / det)


@pytest.mark.parametrize("scene,backend", [
    ("cornell", "brute"), ("cornell", "woop_mxu"), ("lights200", "cluster"),
    ("lights200", "fcluster"), ("lights200", "bvh")])
def test_backend_gradients_match_jax(scenes, scene, backend):
    """d/d(o, d) of sum(hit g t): autograd through brute, woop_mxu and
    cluster, the detached-winner derivative through fcluster and bvh,
    against jax.grad of the same backend."""
    js, ts = scenes[scene]
    o, d = _rays(7, n=256)
    g = np.random.default_rng(8).standard_normal(256).astype(np.float32)

    def jloss(o_, d_):
        h = jintersect.intersect_closest(js, o_, d_, 1e-3, 1e4,
                                         JConfig(backend=backend))
        return jnp.sum(h.hit.astype(jnp.float32) * jnp.asarray(g) * h.t)

    jgo, jgd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(o), jnp.asarray(d))
    to = torch.from_numpy(o).requires_grad_(True)
    td = torch.from_numpy(d).requires_grad_(True)
    h = tintersect.intersect_closest(ts, to, td, 1e-3, 1e4,
                                     IntersectorConfig(backend=backend))
    (h.hit.float() * torch.from_numpy(g) * h.t).sum().backward()
    for got, want in ((to.grad, jgo), (td.grad, jgd)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# Structures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["lights200", "soup3000"])
def test_collapse_bvh8_matches_jax(scenes, scene):
    """The wide BVH collapsed from the same BVH2 equals the JAX package's
    bit for bit, its leaves partition the primitives, and the scene's
    device arrays are those of the JAX scene."""
    js, ts = scenes[scene]
    # the scene's own triangles, shuffled, so the BVH2 is built afresh
    v = np.asarray(js.tri_v)
    v = v[np.random.default_rng(3).permutation(v.shape[0])]
    want = jwide.collapse_bvh8(j_build_bvh2(v, leaf_size=4))
    got = twide.collapse_bvh8(tbvh.build_bvh2(v, leaf_size=4))
    for f in ("boxes", "meta", "order"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.max_depth, got.max_leaf) == (want.max_depth, want.max_leaf)
    meta = got.meta.reshape(-1)
    enc = -meta[meta < 0] - 1
    idx = np.sort(np.concatenate([np.arange(s, s + c) for s, c in
                                  zip(enc >> 5, enc & 31)]))
    np.testing.assert_array_equal(idx, np.arange(v.shape[0]))
    internal = meta[meta > 0]
    assert internal.min() > 0 and internal.max() < got.meta.shape[0]
    np.testing.assert_array_equal(ts.bvh.boxes.numpy(),
                                  np.asarray(js.bvh.boxes))
    np.testing.assert_array_equal(ts.bvh.meta.numpy(),
                                  np.asarray(js.bvh.meta))
    assert (ts.bvh.max_depth, ts.bvh.max_leaf) == (js.bvh.max_depth,
                                                    js.bvh.max_leaf)


def test_bvh2_arrays_and_traversal_match_jax(scenes):
    """bvh_to_device's arrays equal JAX's, and the BVH2 walk gives JAX's
    winners and occlusion on random rays (tests/test_accel.py's query)."""
    js, ts = scenes["lights200"]
    v = np.asarray(js.tri_v)
    jb = jtraverse.bvh_to_device(j_build_bvh2(v, leaf_size=4))
    tb = ttraverse.bvh_to_device(tbvh.build_bvh2(v, leaf_size=4), "cpu")
    for f in ("node_min", "node_max", "left", "right", "start", "count",
              "order"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert (tb.max_depth, tb.leaf_size) == (jb.max_depth, jb.leaf_size)
    o, d = _rays(4, n=300)
    n = o.shape[0]
    jargs = (js.tri_v0, js.tri_e1, js.tri_e2, jnp.asarray(o), jnp.asarray(d),
             jnp.full((n,), 1e-3))
    targs = (ts.tri_v0, ts.tri_e1, ts.tri_e2, torch.from_numpy(o),
             torch.from_numpy(d), torch.full((n,), 1e-3))
    want = [np.asarray(x) for x in jtraverse.bvh_closest(
        jb, *jargs, jnp.full((n,), jnp.inf))]
    got = ttraverse.bvh_closest(tb, *targs, torch.full((n,), torch.inf))
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    hit = want[3] >= 0
    assert hit.mean() > 0.3
    for g_, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g_.numpy()[hit], w_[hit], **TOL)
    occ = ttraverse.bvh_any(tb, *targs, torch.full((n,), 1.5))
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jtraverse.bvh_any(jb, *jargs,
                                                  jnp.full((n,), 1.5))))


def test_convert_carries_the_wide_bvh(scenes):
    js, _ts = scenes["soup3000"]
    port = convert.from_tree(SceneArrays, jax.tree.map(np.asarray, js),
                             "cpu")
    assert isinstance(port.bvh, twide.BVH8Arrays)
    np.testing.assert_array_equal(port.bvh.boxes.numpy(),
                                  np.asarray(js.bvh.boxes))
    np.testing.assert_array_equal(port.bvh.meta.numpy(),
                                  np.asarray(js.bvh.meta))
    assert (port.bvh.max_depth, port.bvh.max_leaf) == (js.bvh.max_depth,
                                                        js.bvh.max_leaf)
    o, d = _rays(5, n=128)
    want = jintersect.intersect_closest(js, jnp.asarray(o), jnp.asarray(d),
                                        1e-3, 1e4, JConfig(backend="bvh"))
    got = tintersect.intersect_closest(port, torch.from_numpy(o),
                                       torch.from_numpy(d), 1e-3, 1e4,
                                       IntersectorConfig(backend="bvh"))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))


def _two_tris(kind):
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                    [[0, 0, 1], [1, 0, 1], [0, 1, 1]]], np.float32)
    if kind == "jax":
        return j_build_scene(tri, np.zeros(2, np.int32), [JMaterialSpec()])
    return build_scene(tri, np.zeros(2, np.int32), [MaterialSpec()], "cpu")


def _cornell_cluster1024(kind):
    """Cornell's 36 triangles plus a grid of 564 small quads' halves, 600
    in all, built at cluster_size 1024: no clusters, above 512."""
    v = np.asarray(j_cornell().tri_v)
    g = np.random.default_rng(2)
    extra = (g.uniform(-1, 1, (564, 1, 3))
             + g.uniform(-0.02, 0.02, (564, 3, 3))).astype(np.float32)
    v = np.concatenate([v, extra])
    mats = np.zeros(v.shape[0], np.int32)
    if kind == "jax":
        return j_build_scene(v, mats, [JMaterialSpec()], cluster_size=1024)
    return build_scene(v, mats, [MaterialSpec()], "cpu", cluster_size=1024)


def _unclustered_blocks(kind, scenes):
    """lights200 without its cluster blocks (cluster AABBs kept): the
    chain's fcluster/cluster rungs."""
    js, ts = scenes["lights200"]
    return js.replace(cluster_tris=None) if kind == "jax" \
        else dataclasses.replace(ts, cluster_tris=None)


BACKEND_TABLE = [
    ("cornell", {}, "fused"),
    ("cornell", {"fused_max_tris": 16}, "woop_mxu"),
    ("cluster1024", {}, "woop_mxu"),
    ("lights200", {}, "fused"),
    ("lights200", {"fused_max_tris": 16}, "ptrace"),
    ("soup3000", {}, "ptrace"),
    ("no_blocks", {"fused_max_tris": 16}, "cluster"),
    ("no_blocks", {"fused_max_tris": 16, "bvh_threshold": 100}, "fcluster"),
    ("soup3000", {"backend": "bvh"}, "bvh"),
    ("soup3000", {"backend": "brute"}, "brute"),
    ("lights200", {"backend": "cluster"}, "cluster"),
    ("lights200", {"backend": "fcluster"}, "fcluster"),
    ("cornell", {"backend": "woop_mxu"}, "woop_mxu"),
    ("lights200", {"backend": "ptrace"}, "ptrace"),
]


@pytest.mark.parametrize("scene,extra,want", BACKEND_TABLE)
def test_backend_choice_matches_jax(scenes, monkeypatch, scene, extra,
                                    want):
    """`_backend` chooses as the JAX `_backend` does off the CPU (its
    default backend patched to a non-CPU name, in this test only). On the
    parent, Cornell with fused_max_tris=16 raised ValueError."""
    def pair(kind):
        if scene == "cluster1024":
            return _cornell_cluster1024(kind)
        if scene == "no_blocks":
            return _unclustered_blocks(kind, scenes)
        return scenes[scene][0 if kind == "jax" else 1]

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert jintersect._backend(pair("jax"), JConfig(**extra)) == want
    assert tintersect._backend(pair("port"), IntersectorConfig(**extra)) \
        == want


@pytest.mark.parametrize("backend,match", [
    ("bvh", "no wide BVH"), ("fcluster", "no cluster"),
    ("cluster", "no cluster"), ("ptrace", "no cluster")])
def test_backend_refusals_match_jax(backend, match):
    """Forcing an accelerated backend on a scene without its arrays raises
    where the JAX package raises, with its message
    (tests/test_fcluster.py::test_backend_errors_without_accel_arrays)."""
    js, ts = _two_tris("jax"), _two_tris("port")
    assert ts.bvh is None and ts.cluster_min is None
    with pytest.raises(ValueError, match=match):
        jintersect._backend(js, JConfig(backend=backend))
    with pytest.raises(ValueError, match=match):
        tintersect._backend(ts, IntersectorConfig(backend=backend))


def test_bvh_fence_matches_jax():
    """'bvh' is refused above 50,000 triangles on both sides, checked on
    stand-ins that claim the size (no 50k scene is built)."""
    class Big:
        bvh = object()
        num_tris = 50_001
        cluster_min = cluster_tris = woop = None

    with pytest.raises(ValueError, match="fenced"):
        jintersect._backend(Big(), JConfig(backend="bvh"))
    with pytest.raises(ValueError, match="fenced"):
        tintersect._backend(Big(), IntersectorConfig(backend="bvh"))


def test_tile_perm_inverse():
    h, w = 24, 96
    perm = tintersect._tile_perm(h, w)
    inv = tintersect._tile_perm_inv(h, w)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(jintersect._tile_perm(h, w)))
    np.testing.assert_array_equal(perm[inv].numpy(), np.arange(h * w))
    np.testing.assert_array_equal(inv[perm].numpy(), np.arange(h * w))


# ---------------------------------------------------------------------------
# The slab repair: a ray in the plane of a box's max face
# ---------------------------------------------------------------------------

# o = (0.5, -1, 1), d = (0, 1, 0) lies in z = 1, the max-face plane of the
# box [0, 0, 0]-[1, 0.1, 1]; it hits the triangle v0 = (0, 0.05, 0),
# e1 = (1, 0, 0), e2 = (0.5, 0, 1) at t = 1.05 (u = 0, v = 1)
PROBE_O = np.array([[0.5, -1.0, 1.0]], np.float32)
PROBE_D = np.array([[0.0, 1.0, 0.0]], np.float32)
PROBE_TRI = np.array([[0.0, 0.05, 0.0], [1.0, 0.05, 0.0],
                      [0.5, 0.05, 1.0]], np.float32)


def _probe_scene():
    """The probe triangle and 80 small triangles below z = 0.9 in the box
    [0, 0, 0]-[1, 0.1, 1], as a clustered scene: every box that holds the
    probe triangle (its cluster's, the wide BVH's and the BVH2's) has its
    max z face in z = 1, the probe ray's plane."""
    g = np.random.default_rng(6)
    small = g.uniform([0.05, 0.0, 0.05], [0.95, 0.1, 0.85], (80, 1, 3)) \
        + g.uniform(-0.03, 0.03, (80, 3, 3))
    small = np.clip(small, [0, 0, 0], [1, 0.1, 0.9]).astype(np.float32)
    v = np.concatenate([PROBE_TRI[None], small])
    return build_scene(v, np.zeros(v.shape[0], np.int32), [MaterialSpec()],
                       "cpu")


def test_slab_repair_keeps_a_ray_in_a_max_face_plane():
    """brute, cluster, bvh and the BVH2 walk find the probe's hit on the
    probe triangle; JAX's `_aabb_hits` misses its box (the reference's
    fault, documented here)."""
    lo = np.array([[0.0, 0.0, 0.0]], np.float32)
    hi = np.array([[1.0, 0.1, 1.0]], np.float32)
    tn, tf = np.full(1, 1e-3, np.float32), np.full(1, 1e4, np.float32)
    assert not bool(np.asarray(jintersect._aabb_hits(
        jnp.asarray(PROBE_O), jnp.asarray(PROBE_D), jnp.asarray(tn),
        jnp.asarray(tf), jnp.asarray(lo), jnp.asarray(hi)))[0, 0])
    assert bool(tintersect._aabb_hits(
        *(torch.from_numpy(x) for x in (PROBE_O, PROBE_D, tn, tf, lo,
                                        hi)))[0, 0])
    scene = _probe_scene()
    probe = int(np.nonzero((scene.tri_v.numpy() == PROBE_TRI).all((1, 2)))
                [0][0])
    o, d = torch.from_numpy(PROBE_O), torch.from_numpy(PROBE_D)
    got = {}
    for backend in ("brute", "cluster", "bvh"):
        h = tintersect.intersect_closest(scene, o, d, 1e-3, 1e4,
                                         IntersectorConfig(backend=backend))
        got[backend] = (int(h.tri[0]), float(h.t[0]))
        assert bool(tintersect.intersect_any(
            scene, o, d, 1e-3, 1e4, IntersectorConfig(backend=backend))[0])
    assert got["brute"][0] == probe
    assert abs(got["brute"][1] - 1.05) < 1e-6
    assert got["cluster"] == got["bvh"] == got["brute"], got
    b2 = ttraverse.bvh_to_device(tbvh.build_bvh2(scene.tri_v.numpy()),
                                 "cpu")
    args = (scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d,
            torch.full((1,), 1e-3))
    assert int(ttraverse.bvh_closest(b2, *args, torch.full((1,), 1e4))[3]
               [0]) == probe
    assert bool(ttraverse.bvh_any(b2, *args, torch.full((1,), 1e4))[0])


def test_host_syncs_are_counted(scenes):
    """Each loop read on the host adds one to its counter."""
    _js, ts = scenes["lights200"]
    o, d = (torch.from_numpy(x) for x in _rays(9, n=64))
    before = tracing.COUNTS.copy()
    for backend in ("fcluster", "cluster", "bvh"):
        tintersect.intersect_closest(ts, o, d, 1e-3, 1e4,
                                     IntersectorConfig(backend=backend))
    after = tracing.COUNTS
    assert all(after["sync." + k] > before["sync." + k]
               for k in ("fcluster", "cluster", "bvh8"))
