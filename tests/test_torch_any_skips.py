"""The facts that the any-hit kernels K6's and K8's shortcuts rest on,
checked on the plain versions on the CPU.

K6 (`csrc/cluster_trace.cu`, cull mode 5) skips the rows of a slot for a
warp none of whose live, unoccluded rays passes the per-ray slab test of
the slot's box, and drops a slab-dead ray from a row's candidates: that is
exact if no ray whose slab test (`cluster_trace.slab_live_ref`, upper =
tfar) fails has a hit in the box in the plain Moller-Trumbore test
(`cluster_trace._mt`). It is held with each triangle's own box, the
tightest case, on the ray families of tests/torch_ray_families.py and on
rays that graze the boxes (segments that end next to them, rays in the
plane of a face, origins inside, direction components near the 1e-20
clamp). The JAX kernel's slab test fails it on rays lying in a box's
max-face plane; the port's exit rule repairs that. K8 (the Woop test)
culls the same way, on boxes grown by the Woop test's reach
(`cluster_trace.woop_cull_boxes`): its watertight slack hits points just
outside a triangle, which the slab test of the triangle's own box calls
dead; held on the same families with the grown boxes.

K6 then skips the division, q, v and t of a row for a warp none of
whose wanting lanes passes a division-free test of u's numerator against
|det| (`u_may_pass`): exact if every pair with ok_det and 0 <= u <= 1
passes it, held on the same families.

Then a plain emulation of K6's skips in groups of 32 rays (a warp): the
block's all-occluded exit and mode-5 slot vote, the per-warp slab skip,
the u-first row skip (no lane both wants a hit and passes the
division-free test) and the warp's exit once no lane wants a hit; its
mask must equal `trace_any_ref` on a terrain (cull mode 5) and on the
many-lights room (no cull). Likewise K8's skips (the mode-5 slot vote
and per-warp slab skip on the grown boxes, the t-first and u-first row
skips in row groups and the warp's exit) against `trace_any_mxu_ref`, on
the ray families and on a terrain's own rays, over terrain_scene(10_000)
rebuilt at cluster size 128 (79 clusters: cull mode 5; at 5_000
triangles it has 40, and no cull). Tolerance: none (exact booleans).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_restir.kernels import cluster_trace as jct
from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.kernels import ray_tri
from tpu_restir_torch.kernels.woop import build_woop_matrices
from tpu_restir_torch.scene.cornell import many_lights_scene
from tpu_restir_torch.scene.procedural import terrain_scene
from torch_kernel_emulation import per_group, woop_terrain
from torch_ray_families import ANY_FAMILIES, FAMILIES, family


def _pairs(name, woop=False):
    """Every (triangle, ray) pair of a family: the hit mask (T, N) of the
    plain test (Moller-Trumbore, or with woop the Woop test of
    `ray_tri`), the rays and each triangle's own box (T, 1, 3)."""
    tris, o, d, tn, tf = (torch.from_numpy(x) for x in family(name))
    if woop:
        w = torch.from_numpy(build_woop_matrices(tris.numpy()))
        ok = ray_tri._woop_tuvok(o, d, tn, tf, w.reshape(-1, 12))[3].T
    else:
        tr = torch.cat([tris[:, 0], tris[:, 1] - tris[:, 0],
                        tris[:, 2] - tris[:, 0]], 1)[None]
        comps = [x[None, None] for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                                         d[:, 1], d[:, 2], tn, tf)]
        ok = ct._mt(tr, *comps)[3][0]
    return ok, (o, d, tn, tf), tris.amin(1)[:, None], tris.amax(1)[:, None]


def _in_max_face_plane(o, d, bmax):
    """(T, N): the ray has a zero component along an axis and its origin
    lies on the box's max face of that axis."""
    return ((d[None] == 0.0) & (o[None] == bmax)).any(-1)


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("name", ANY_FAMILIES)
def test_slab_dead_rays_have_no_hit(name, block):
    """No ray that `slab_live_ref` calls dead for a triangle's box hits the
    triangle: K6's (block 64: Moller-Trumbore on the box itself) and K8's
    (block 128: the Woop test on the box grown by `woop_cull_boxes`)
    per-warp slab skip and per-ray slab flag are exact."""
    woop = block == 128
    ok, (o, d, tn, tf), bmin, bmax = _pairs(name, woop)
    gmin, gmax = ct.woop_cull_boxes(bmin, bmax) if woop else (bmin, bmax)
    live = ct.slab_live_ref(o[None], d[None], tn[None], tf[None], gmin, gmax)
    assert int(ok.sum()) > 0
    assert int((ok & ~live).sum()) == 0
    assert 0 < int(live.sum()) < live.numel()
    if name in ("v_neg_zero", "box_grazing"):
        # the family reaches the case that the clamp alone gets wrong
        assert int((ok & _in_max_face_plane(o, d, bmax)).sum()) > 0
    if woop and name == "u_above_1":
        # Woop hits past u = 1 that the triangle's own box would cull
        own = ct.slab_live_ref(o[None], d[None], tn[None], tf[None], bmin,
                               bmax)
        assert int((ok & ~own).sum()) > 0


def test_jax_slab_test_culls_hits_in_a_max_face_plane():
    """The JAX kernel's slab test (`_ray_inv`, `_slab_entry_exit`,
    `_slab_live`) calls dead some rays that hit: rays lying in the plane of
    a box's max face, which its clamp sends out of the box at t = 0. A
    fault of the reference's mode-5 cull, repaired in the port (ROADMAP
    queue 3)."""
    ok, (o, d, tn, tf), bmin, bmax = _pairs("box_grazing")
    box = jnp.asarray(np.concatenate([bmin[:, 0].numpy().T,
                                      bmax[:, 0].numpy().T,
                                      np.zeros((2, bmin.shape[0]),
                                               np.float32)]))
    q = jnp.arange(bmin.shape[0])[:, None]
    ch = [jnp.asarray(x.numpy())[None] for x in
          (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], tn, tf)]
    ix, iy, iz = jct._ray_inv(*ch[3:6])
    tent, texit = jct._slab_entry_exit(box, q, *ch[:3], ix, iy, iz, ch[6])
    jax_live = torch.from_numpy(np.array(jct._slab_live(tent, texit,
                                                        ch[7])))
    culled = ok & ~jax_live
    assert int(culled.sum()) > 0
    assert bool(_in_max_face_plane(o, d, bmax)[culled].all())


def _u_parts(tr, ox, oy, oz, dx, dy, dz, tn, tf):
    """det and u's numerator of `cluster_trace._mt`, in its operation
    order -> (det, un, u)."""
    v0x, v0y, v0z = tr[..., 0:1], tr[..., 1:2], tr[..., 2:3]
    e2x, e2y, e2z = tr[..., 6:7], tr[..., 7:8], tr[..., 8:9]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = chip_smoke.mt_det(tr, dx, dy, dz)
    un = (ox - v0x) * px + (oy - v0y) * py + (oz - v0z) * pz
    ok_det = det.abs() > 1e-18
    inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    return det, un, un * inv


def _u_may_pass(un, det):
    """`u_may_pass` of csrc/cluster_trace.cu, in float32."""
    a = det.abs()
    s = torch.where(det > 0, un, -un)
    return (a > 1e-18) & (s >= -1e-6 * a) & (s <= 1.000001 * a)


@pytest.mark.parametrize("name", ANY_FAMILIES)
def test_u_test_without_division_is_conservative(name):
    """Every pair with ok_det and 0 <= u <= 1 in the plain test passes
    K6's division-free test of u's numerator against |det|: its warp skip
    of the division, v and t is exact."""
    tris, o, d, tn, tf = (torch.from_numpy(x) for x in family(name))
    tr = torch.cat([tris[:, 0], tris[:, 1] - tris[:, 0],
                    tris[:, 2] - tris[:, 0]], 1)[None]
    rays = [x[None, None] for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                                     d[:, 1], d[:, 2], tn, tf)]
    det, un, u = _u_parts(tr, *rays)
    _t, u_ref, _v, ok = ct._mt(tr, *rays)
    assert torch.equal(u, u_ref)
    cand = (det.abs() > 1e-18) & (u >= 0.0) & (u <= 1.0)
    pre = _u_may_pass(un, det)
    assert int(ok.sum()) > 0 and int(cand.sum()) > 0
    assert int((cand & ~pre).sum()) == 0
    assert int((~pre).sum()) > 0
    if name == "u_above_1":
        # pairs just past u = 1 pass the margin, and the exact u decides
        assert int((pre & ~cand).sum()) > 0


def _emulate_k6(ctris, cmin, cmax, pk, stats):
    """K6's traversal at factor 1 in groups of 32 rays, as
    csrc/cluster_trace.cu runs it: per slot the block's all-occluded exit
    and (cull mode 5) slab vote, then per group the slab skip, and per row
    the u-first skip and the group's exit. -> (Rp*P,) bool; stats counts
    what each skip dropped."""
    rp = pk.count.shape[0]
    c = ctris.shape[0]
    mode = ct._skip_for("any", c, pk.factor)
    o = pk.o.view(rp, ct.P, 3)
    d = pk.d.view(rp, ct.P, 3)
    tn = pk.tnear.view(rp, ct.P)
    tf = pk.tfar.view(rp, ct.P)
    live = tf >= tn
    occ = torch.zeros((rp, ct.P), dtype=torch.bool)
    rays = ct._packet_rays(pk)
    for j in range(int(pk.count.max())):
        a = torch.nonzero((pk.count > j) & ~(occ | ~live).all(1))[:, 0]
        cl = pk.shortlist[a, j].long()
        open_ = live[a] & ~occ[a]
        slab = torch.ones_like(open_)
        if mode == 5:
            slab = open_ & ct.slab_live_ref(o[a], d[a], tn[a], tf[a],
                                            cmin[cl, None], cmax[cl, None])
            staged = slab.any(1)
            a, cl, open_, slab = a[staged], cl[staged], open_[staged], \
                slab[staged]
        want = open_ & slab & per_group(open_ & slab)
        stats["groups skipped by the slab"] += int(
            (per_group(open_) & ~per_group(open_ & slab)).sum()) // 32
        tr = ctris[cl]
        r = [x[a] for x in rays]
        ok = ct._mt(tr, *r)[3]
        det, un, _u = _u_parts(tr, *r)
        pre = _u_may_pass(un, det)
        hit_a = torch.zeros_like(want)
        for row in range(tr.shape[1]):
            cand = want & pre[:, row]
            tested = per_group(cand)
            stats["rows skipped by u"] += int(
                (per_group(want) & ~tested).sum()) // 32
            hit = tested & cand & ok[:, row]
            hit_a |= hit
            left = per_group(want)
            want &= ~hit
            stats["groups left early"] += int(
                (left & ~per_group(want)).sum()) // 32 \
                if row < tr.shape[1] - 1 else 0
        occ[a] |= hit_a
    return occ.reshape(-1)


def _terrain_rays(scene, n, seed):
    """G-buffer-like rays of the terrain's camera as occlusion rays, and
    random segments through its box, a tenth of each dead."""
    g = torch.Generator().manual_seed(seed)
    frm = torch.tensor(chip_smoke.TERRAIN_VIEW[0])
    at = torch.tensor(chip_smoke.TERRAIN_VIEW[1])
    d1 = (at - frm) + 2.0 * (torch.rand((n, 3), generator=g) - 0.5) \
        * torch.tensor([1.5, 0.2, 1.0])
    o1 = frm.expand(n, 3)
    o2 = (torch.rand((n, 3), generator=g) - 0.5) * 8.0 \
        + torch.tensor([0.0, 0.0, 1.0])
    d2 = torch.randn((n, 3), generator=g)
    o, d = torch.cat([o1, o2]), torch.cat([d1, d2])
    d = d / d.norm(dim=-1, keepdim=True)
    tf = torch.cat([torch.full((n,), 1e4), torch.full((n,), 2.0)])
    tf[torch.rand((2 * n,), generator=g) < 0.1] = -1.0
    return o.contiguous(), d.contiguous(), torch.full((2 * n,), 1e-3), tf


def _room_rays(n, seed):
    """Rays in the many-lights room, coherent per group of 32 as a shadow
    packet's (an origin and a direction each, spread a little), a tenth
    dead."""
    g = torch.Generator().manual_seed(seed)
    m = n // 32
    o = (torch.rand((m, 1, 3), generator=g) - 0.5) * 1.6 \
        + torch.tensor([0.0, 0.0, 1.0]) \
        + 0.02 * torch.randn((m, 32, 3), generator=g)
    d = torch.randn((m, 1, 3), generator=g) \
        + 0.1 * torch.randn((m, 32, 3), generator=g)
    o, d = o.reshape(n, 3), d.reshape(n, 3)
    d = d / d.norm(dim=-1, keepdim=True)
    tf = torch.rand((n,), generator=g) * 3.0
    tf[torch.rand((n,), generator=g) < 0.1] = -1.0
    return o.contiguous(), d.contiguous(), torch.full((n,), 1e-3), tf


@pytest.mark.parametrize("name", ["terrain", "lights"])
def test_k6_skips_emulated_match_plain(name):
    """K6's skips, emulated in groups of 32 rays, give `trace_any_ref`'s
    mask on a terrain (79 clusters: cull mode 5) and on the many-lights
    room (9 clusters: no cull); the skips fire."""
    if name == "terrain":
        scene = terrain_scene("cpu", 5_000)
        rays = _terrain_rays(scene, 2048, 7)
    else:
        scene = many_lights_scene("cpu", 500)
        rays = _room_rays(4096, 8)
    pk = ct.pack(scene.cluster_min, scene.cluster_max, *rays, 1)
    stats = {"groups skipped by the slab": 0, "rows skipped by u": 0,
             "groups left early": 0}
    got = _emulate_k6(scene.cluster_tris, scene.cluster_min,
                      scene.cluster_max, pk, stats)
    want = ct.trace_any_ref(scene.cluster_tris, pk)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int((pk.tfar >= pk.tnear).sum())
    assert stats["rows skipped by u"] > 0 and stats["groups left early"] > 0
    if name == "terrain":
        assert stats["groups skipped by the slab"] > 0
    else:
        assert stats["groups skipped by the slab"] == 0


K8_GROUP = 4   # kWoopGroup of csrc/cluster_trace.cu: rows per unrolled group


def _emulate_k8(cwoop, cmin, cmax, pk, stats):
    """K8's traversal at factor 1 in groups of 32 rays, as
    csrc/cluster_trace.cu runs it: per slot the block's all-occluded exit
    and (cull mode 5) slab vote on the grown boxes, per group the slab
    skip, per row the t-first skip (no wanting lane with t in its folded
    range: finite, within [tnear, tfar]) and the u-first skip of v (no
    such lane with u in [-1e-5, 1.001]) and, once a row group, the group's
    exit when no lane wants a hit. -> (Rp*P,) bool; stats counts
    what each skip dropped."""
    rp = pk.count.shape[0]
    mode = ct._skip_for("any", cwoop.shape[0], pk.factor)
    bmin, bmax = ct.woop_cull_boxes(cmin, cmax)
    o = pk.o.view(rp, ct.P, 3)
    d = pk.d.view(rp, ct.P, 3)
    tn = pk.tnear.view(rp, ct.P)
    tf = pk.tfar.view(rp, ct.P)
    live = tn <= tf
    occ = torch.zeros((rp, ct.P), dtype=torch.bool)
    rays = ct._packet_rays(pk)
    for j in range(int(pk.count.max())):
        a = torch.nonzero((pk.count > j) & ~(occ | ~live).all(1))[:, 0]
        cl = pk.shortlist[a, j].long()
        open_ = live[a] & ~occ[a]
        slab = torch.ones_like(open_)
        if mode == 5:
            slab = open_ & ct.slab_live_ref(o[a], d[a], tn[a], tf[a],
                                            bmin[cl, None], bmax[cl, None])
            staged = slab.any(1)
            stats["slots skipped by the vote"] += int((~staged).sum())
            a, cl, open_, slab = a[staged], cl[staged], open_[staged], \
                slab[staged]
        want = open_ & slab & per_group(open_ & slab)
        stats["groups skipped by the slab"] += int(
            (per_group(open_) & ~per_group(want)).sum()) // 32
        t, u, _v, ok = ct._woop(cwoop[cl], *(x[a] for x in rays))
        in_range = torch.isfinite(t) & (t >= tn[a, None]) \
            & (t <= tf[a, None])
        hit_a = torch.zeros_like(want)
        for g0 in range(0, ct.WOOP_BLOCK, K8_GROUP):
            going = per_group(want)
            if g0:
                stats["groups left early"] += int(
                    (left & ~going).sum()) // 32
            left = going
            for row in range(g0, g0 + K8_GROUP):
                test = want & in_range[:, row]
                tested = per_group(test)
                stats["rows skipped by t"] += int(
                    (going & ~tested).sum()) // 32
                cand = tested & test & (u[:, row] >= -1e-5) \
                    & (u[:, row] <= 1.001)
                u_ok = per_group(cand)
                stats["rows skipped by u"] += int(
                    (tested & ~u_ok).sum()) // 32
                hit = u_ok & cand & ok[:, row]
                hit_a |= hit
                want &= ~hit
        occ[a] |= hit_a
    return occ.reshape(-1)


@pytest.mark.parametrize("name", ANY_FAMILIES + ["terrain"])
def test_k8_skips_emulated_match_plain(name):
    """K8's skips, emulated in groups of 32 rays, give
    `trace_any_mxu_ref`'s mask on the Woop terrain (cull mode 5), for the
    rays of each family (their own triangles left out) and for the
    terrain camera's rays as occlusion rays with random segments; the
    slab, t-first and u-first skips fire, and (but for tiny_det's rays,
    which list one cluster and hit nothing) the slot vote and the exit."""
    scene = woop_terrain()
    assert ct._skip_for("any", scene.cluster_woop.shape[0]) == 5
    if name == "terrain":
        rays = _terrain_rays(scene, 1024, 11)
    else:
        rays = tuple(torch.from_numpy(x) for x in family(name, n=2048)[1:])
    pk = ct.pack(scene.cluster_min, scene.cluster_max, *rays, 1)
    stats = {"slots skipped by the vote": 0, "groups skipped by the slab": 0,
             "rows skipped by t": 0, "rows skipped by u": 0,
             "groups left early": 0}
    got = _emulate_k8(scene.cluster_woop, scene.cluster_min,
                      scene.cluster_max, pk, stats)
    want = ct.trace_any_mxu_ref(scene.cluster_woop, pk)
    assert torch.equal(got, want)
    assert stats["groups skipped by the slab"] > 0
    assert stats["rows skipped by t"] > 0 and stats["rows skipped by u"] > 0
    if name != "tiny_det":   # rays along z = 0: under the terrain, unlisted
        assert 0 < int(want.sum()) < int((pk.tfar >= pk.tnear).sum())
        assert stats["slots skipped by the vote"] > 0
        assert stats["groups left early"] > 0
