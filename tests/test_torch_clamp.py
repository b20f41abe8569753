"""Phase 1's scene-box clamp (`accel.fcluster._clamp_tfar_bbox`) on rays
that lie in the plane of the scene box's max face, against the JAX
package's, on the CPU.

The clamp replaces a direction component of magnitude at most 1e-20 by
+-1e-20. The JAX package's clamp then puts a ray lying in the plane of the
box's max face out of the box at t = 0, and `pack` kills it, although it
hits the triangle edges in that plane. The port's clamp gives such an
axis an exit of +inf unless the ray lies beyond the slab, as the kernels'
slab cull (`slab_exit` of csrc/cluster_trace.cu) does.

Rays: in the plane x = max of terrain_scene(5_000)'s box (d.x = 0, the
origin's x equal to the box's), from 2 above the terrain onto points of
its boundary edges there. Brute force over every triangle (`ray_tri`'s
plain Woop closest hit; `cluster_trace._mt` for the Moller-Trumbore test)
finds their hits. Tolerance: none (exact tfar, ids and t, u, v).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_restir.accel import fcluster as jfc
from tpu_restir_torch.accel import fcluster as tfc
from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.kernels import ray_tri
from tpu_restir_torch.scene.procedural import terrain_scene


def _edge_rays(scene, n=384, seed=0):
    """Rays in the plane of the scene box's max-x face (d.x = +0 or -0),
    from above onto points of the terrain's boundary edges in that plane
    -> o, d, tnear, tfar."""
    g = np.random.default_rng(seed)
    x_max = scene.cluster_max.amax(0)[0]
    v = scene.tri_v
    on = v[:, :, 0] == x_max
    edge = torch.nonzero(on.sum(1) == 2)[:, 0]
    k = edge[torch.from_numpy(g.integers(0, edge.numel(), n))]
    ends = v[k][on[k]].view(n, 2, 3)
    s = torch.from_numpy(g.uniform(0.05, 0.95, (n, 1))).float()
    p = ends[:, 0] * (1 - s) + ends[:, 1] * s
    p[:, 0] = x_max
    o = p + torch.stack([torch.zeros(n),
                         torch.from_numpy(g.uniform(-1, 1, n)).float(),
                         torch.full((n,), 2.0)], 1)
    o[:, 0] = x_max
    d = p - o
    d = d / d.norm(dim=-1, keepdim=True)
    d[::2, 0] = -0.0
    assert bool((d[:, 0] == 0.0).all())
    return (o.contiguous(), d.contiguous(), torch.full((n,), 1e-3),
            torch.full((n,), 1e4))


def _brute_mt(scene, o, d, tn, tf):
    """Closest hit of `cluster_trace._mt` over every triangle of the
    cluster blocks, the first of least t -> (t, u, v, tri)."""
    blk = scene.cluster_tris.reshape(1, -1, 9)
    rays = [x[None, None] for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                                    d[:, 1], d[:, 2], tn, tf)]
    t, u, v, ok = (x[0] for x in ct._mt(blk, *rays))       # (T, N)
    tt = torch.where(ok, t, torch.inf)
    j = torch.argmin(tt, 0, keepdim=True)
    hit = ok.any(0)
    return (torch.where(hit, tt.gather(0, j)[0], torch.inf),
            torch.where(hit, u.gather(0, j)[0], 0.0),
            torch.where(hit, v.gather(0, j)[0], 0.0),
            torch.where(hit, j[0].to(torch.int32), -1))


@pytest.fixture(scope="module")
def scenes():
    scene = terrain_scene("cpu", 5_000)
    return {64: scene, 128: chip_smoke._woop_rebuild(scene, "cpu")}


@pytest.mark.parametrize("block", [64, 128])
def test_max_face_plane_rays_survive_the_clamp(scenes, block):
    """Every ray of the plane hits a boundary edge by the plain Woop test;
    after `pack` each stays live with tfar at or past its hit, and the
    traversal's plain version (Moller-Trumbore at cluster size 64, Woop at
    128) finds the brute-force hit of its own test over every triangle."""
    scene = scenes[block]
    o, d, tn, tf = _edge_rays(scene)
    n = o.shape[0]
    woop = ray_tri.closest_hit_ref(ray_tri.woop_rows(scene), o, d, tn, tf)
    assert bool((woop[3] >= 0).all())
    pk = ct.pack(scene.cluster_min, scene.cluster_max, o, d, tn, tf, 1)
    tfar = pk.tfar[:n]
    assert bool((tfar >= tn).all())
    assert bool((tfar >= woop[0]).all())
    if block == 64:
        want = _brute_mt(scene, o, d, tn, tf)
        got = ct.trace_closest_ref(scene.cluster_tris, pk)
        assert int((want[3] >= 0).sum()) > n // 2
    else:
        want = woop
        got = ct.trace_closest_mxu_ref(scene.cluster_woop, pk)
    for a, b in zip(got, want):
        assert torch.equal(a[:n], b)


def test_jax_clamp_kills_max_face_plane_rays(scenes):
    """The JAX package's clamp kills every ray of the plane (tfar < tnear),
    though each hits: a fault of the reference, repaired in the port
    (ROADMAP queue 3)."""
    scene = scenes[64]
    o, d, tn, tf = _edge_rays(scene)
    lo, hi = scene.cluster_min.amin(0), scene.cluster_max.amax(0)
    got = np.asarray(jfc._clamp_tfar_bbox(
        *(jnp.asarray(x.numpy()) for x in (o, d, tn, tf, lo, hi))))
    assert bool((got < tn.numpy()).all())
    hits = ray_tri.closest_hit_ref(ray_tri.woop_rows(scene), o, d, tn, tf)
    assert bool((hits[3] >= 0).all())


def test_clamp_keeps_jax_tfar_without_clamped_components(scenes):
    """Rays with zero or tiny direction components, origins inside the
    box, on its faces and beyond them: where no component is clamped (its
    magnitude above 1e-20, or NaN) the port's tfar equals the JAX
    package's bit for bit; elsewhere it is never shorter, and rays lying
    in the plane of the face they would leave by (the origin on the max
    face for a component clamped to +1e-20, on the min face for -1e-20)
    stay live where the JAX package kills them."""
    scene = scenes[64]
    lo, hi = scene.cluster_min.amin(0), scene.cluster_max.amax(0)
    g = np.random.default_rng(5)
    n = 4096
    w = g.uniform(-0.2, 1.2, (n, 3))
    w = np.where(g.random((n, 3)) < 0.2, g.choice([0.0, 1.0], (n, 3)), w)
    o = torch.from_numpy(lo.numpy() + w * (hi - lo).numpy()).float()
    d = torch.from_numpy(g.standard_normal((n, 3))).float()
    d = d / d.norm(dim=-1, keepdim=True)
    zero = torch.from_numpy(g.random((n, 3)) < 0.3)
    tiny = torch.from_numpy(g.choice([0.0, -0.0, 5e-21, -1e-20, 2e-20],
                                     (n, 3))).float()
    d = torch.where(zero, tiny, d)
    d[::97] = float("nan")
    tn = torch.full((n,), 1e-3)
    tf = torch.from_numpy(g.uniform(0.5, 40.0, n)).float()
    got = tfc._clamp_tfar_bbox(o, d, tn, tf, lo, hi)
    want = torch.from_numpy(np.array(jfc._clamp_tfar_bbox(
        *(jnp.asarray(x.numpy()) for x in (o, d, tn, tf, lo, hi)))))
    clamped = d.abs() <= 1e-20
    free = ~clamped.any(-1)
    assert int(free.sum()) > n // 4 and int((~free).sum()) > n // 4
    assert torch.equal(got[free], want[free])
    assert bool((got[~free] >= want[~free]).all())
    exit_face = torch.where(d >= 0.0, o == hi, o == lo)
    plane = (clamped & exit_face).any(-1)
    kept = plane & (got >= tn) & (want < tn)
    assert int(kept.sum()) > 0
