"""The facts that the closest-hit kernels' shortcuts rest on, checked on the
plain versions on the CPU, and the per-ray bound of chip_smoke.py.

K5 (`csrc/cluster_trace.cu`) skips q, v, t of a Moller-Trumbore row where
no lane of a warp has ok_det and 0 <= u <= 1: that is exact if every hit
of `cluster_trace._mt` has ok_det and u in [0, 1]. K1 (`csrc/ray_tri.cu`)
skips u and v of a Woop row where no lane has |dw| > 1e-18 and a t in
[tnear, min(tfar, best t)): that is exact if dropping every such row
before the plain closest fold gives the same (t, u, v, tri), bit for bit.
K1 then skips v where no such lane has u in [-1e-5, 1.001]: that is exact
if every hit of the plain Woop test has u in that range. All are
held on seeded numpy rays of five families: random rays, rays that graze
shared edges, determinants near 1e-18, u just above 1, and v = -0.0.
K7 (the clustered Woop closest hit) takes K1's row code into the
traversal: an emulation of its skips in groups of 32 rays (the block's
entry vote, the per-warp slot skip, the t-first and u-first row skips,
each ray's range folded) must give `trace_closest_mxu_ref`'s (t, u, v,
tri) bit for bit, on the families' rays and the terrain camera's over
terrain_scene(10_000) rebuilt at cluster size 128.
Tolerance: none (exact booleans and bitwise equal tensors).

`chip_smoke.closest_pairs` counts the (live ray, listed cluster) pairs a
closest-hit query needs per ray; it must equal a loop over rays and
slots and stay at most the count per packet. `chip_smoke.ray_tri_ops` and
`chip_smoke.trace_ops` count the operations per ray that K1/K2 and K5-K8
need, a row charged as far as its test must run, and in cull mode 5 (K6,
K8) only on slab-live pairs; each must equal a loop over the rows of
sampled rays. `chip_smoke.slab_live_share` must count
the listed pairs of an any-hit query whatever its chunking.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_restir_torch.config import CameraConfig
from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.kernels import ray_tri
from tpu_restir_torch.kernels.woop import build_woop_matrices
from tpu_restir_torch import rng
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render import intersect
from tpu_restir_torch.scene.procedural import terrain_scene
from torch_kernel_emulation import per_group, woop_terrain
from torch_ray_families import FAMILIES, family


def _mt_inputs(tris, o, d, tn, tf):
    """`_mt`'s inputs: the (1, T, 9) block (v0, e1, e2, as build_clusters
    makes them) and the rays as (1, 1, N) components."""
    v = torch.from_numpy(tris)
    tr = torch.cat([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], 1)[None]
    oo, dd = torch.from_numpy(o), torch.from_numpy(d)
    comps = [x[None, None] for x in (oo[:, 0], oo[:, 1], oo[:, 2], dd[:, 0],
                                     dd[:, 1], dd[:, 2])]
    return tr, comps + [torch.from_numpy(tn)[None, None],
                        torch.from_numpy(tf)[None, None]]


@pytest.mark.parametrize("name", FAMILIES)
def test_mt_hit_needs_ok_det_and_u_in_unit(name):
    """Every hit of the plain Moller-Trumbore test has ok_det and
    0 <= u <= 1: K5's u-first warp skip is exact."""
    tris, o, d, tn, tf = family(name)
    tr, rays = _mt_inputs(tris, o, d, tn, tf)
    t, u, v, ok = ct._mt(tr, *rays)
    det = chip_smoke.mt_det(tr, *rays[3:6])
    ok_det = torch.abs(det) > 1e-18
    assert int(ok.sum()) > 0
    assert bool((ok <= (ok_det & (u >= 0.0) & (u <= 1.0))).all())
    # the family reaches the edge it is named for
    hits = ok_det & (u >= 0.0)
    if name == "tiny_det":
        near = (torch.abs(det) > 1e-19) & (torch.abs(det) < 1e-17)
        assert int(near.sum()) > 0 and int((near & ~ok_det).sum()) > 0
    elif name == "u_above_1":
        assert int((hits & (u > 1.0) & (v >= 0.0)).sum()) > 0
    elif name == "v_neg_zero":
        neg0 = ok & (v == 0.0) & torch.signbit(v)
        assert int(neg0.sum()) > 0


def _woop_inputs(tris, o, d, tn, tf):
    w = torch.from_numpy(build_woop_matrices(tris)).reshape(-1, 12)
    return w, *(torch.from_numpy(x) for x in (o, d, tn, tf))


@pytest.mark.parametrize("name", FAMILIES)
def test_closest_fold_ignores_rows_out_of_range(name):
    """Dropping every Woop row whose t is not in [tnear, min(tfar, best t))
    (best t: the fold's running minimum over the earlier rows), or whose
    |dw| <= 1e-18, before the plain closest fold of ray_tri gives the same
    (t, u, v, tri), bit for bit: K1's t-first warp skip is exact."""
    w, o, d, tn, tf = _woop_inputs(*family(name))
    t, u, v, ok = ray_tri._woop_tuvok(o, d, tn, tf, w)
    dw = d[:, 0:1] * w[:, 8] + d[:, 1:2] * w[:, 9] + d[:, 2:3] * w[:, 10]
    tt = torch.where(ok, t, torch.inf)
    best = torch.cummin(tt, 1).values
    before = torch.cat([torch.full_like(best[:, :1], torch.inf),
                        best[:, :-1]], 1)
    keep = (torch.abs(dw) > 1e-18) & (t >= tn[:, None]) \
        & (t <= tf[:, None]) & (t < before)
    kept = torch.where(ok & keep, t, torch.inf)
    j = torch.argmin(kept, 1, keepdim=True)
    hit = (ok & keep).any(1)
    got = (torch.where(hit, kept.gather(1, j)[:, 0], torch.inf),
           torch.where(hit, u.gather(1, j)[:, 0], 0.0),
           torch.where(hit, v.gather(1, j)[:, 0], 0.0),
           torch.where(hit, j[:, 0].to(torch.int32), -1))
    want = ray_tri.closest_hit_ref(w, o, d, tn, tf)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((want[3] >= 0).sum()) > 0
    # the shortcut drops rows that the fold would otherwise see
    assert int((ok & ~keep).sum()) > 0 or name == "tiny_det"
    if name == "tiny_det":
        assert int(((torch.abs(dw) > 1e-19) & (torch.abs(dw) < 1e-17))
                   .sum()) > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_woop_hit_needs_u_in_skip_range(name):
    """Every hit of the plain Woop test (`ray_tri._woop_tuvok`) has
    -1e-5 <= u <= 1.001 (kUMax of csrc/ray_tri.cu): K1's u-first warp
    skip of v is exact."""
    w, o, d, tn, tf = _woop_inputs(*family(name))
    _t, u, v, ok = ray_tri._woop_tuvok(o, d, tn, tf, w)
    assert int(ok.sum()) > 0
    assert bool((ok <= ((u >= -1e-5) & (u <= 1.001))).all())
    if name == "u_above_1":
        # hits past u = 1 within the test's slack, and misses past it
        assert int((ok & (u > 1.0)).sum()) > 0
        assert int((~ok & (u > 1.0 + 1e-5) & (v >= 0.0)).sum()) > 0


def _terrain_packets(scene, h=32, w=64):
    """The bench's terrain camera at w x h in 8x32-tile packet order,
    packed at factor 1."""
    cc = CameraConfig(width=w, height=h, fov_y_deg=45.0,
                      view_from=chip_smoke.TERRAIN_VIEW[0],
                      view_at=chip_smoke.TERRAIN_VIEW[1],
                      pixel_sampler="random")
    cam = cam_mod.make_camera(cc, "cpu")
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    o, d = cam_mod.generate_rays_at(cam, cc, rng.make_frame_seed(0, 0), ys,
                                    xs)
    o, d = (intersect._tile_fold(x.reshape(-1, 3), h, w, 1).contiguous()
            for x in (o, d))
    n = o.shape[0]
    return ct.pack(scene.cluster_min, scene.cluster_max, o, d,
                   torch.full((n,), 1e-3), torch.full((n,), 1e4), 1)


def test_closest_bound_counts_per_ray():
    scene = terrain_scene("cpu", 2_000)
    pk = _terrain_packets(scene)
    t = ct.trace_closest_ref(scene.cluster_tris, pk)[0]
    per_ray, per_packet = chip_smoke.closest_pairs(
        pk, t, scene.cluster_tris.shape[0])
    want = 0
    for p in range(pk.count.shape[0]):
        ent = pk.entry[p, :int(pk.count[p])].numpy()
        for k in range(ct.P):
            i = p * ct.P + k
            if pk.tfar[i] >= pk.tnear[i]:
                reach = min(float(t[i]), float(pk.tfar[i]))
                want += int((ent <= reach).sum())
    assert want > 0 and per_ray == want
    assert per_ray <= per_packet
    bnd, whole = chip_smoke.trace_bound("trace_closest", scene, pk, (t,))
    rows = scene.cluster_tris.shape[1]
    assert whole["pairs"][0] == per_ray * rows
    assert whole["pairs per packet"][0] == per_packet * rows
    assert bnd[0] < whole["pairs"][1][0] <= whole["pairs per packet"][1][0]


def _woop_rows_loop(t, u, ok, tn, tf, best):
    """Operations of one ray's Woop rows, row by row (best None: any hit);
    -> (operations, best after the rows)."""
    cs = chip_smoke
    ops = 0
    for j in range(len(t)):
        ops += cs.WOOP_T_OPS
        if (np.isfinite(t[j]) and tn <= t[j] <= tf
                and (best is None or t[j] < best)):
            ops += cs.WOOP_TU_OPS - cs.WOOP_T_OPS
            eps = np.float32(1e-5)
            if u[j] >= -eps and u[j] - eps <= np.float32(1.0 + 1e-5):
                ops += cs.WOOP_OPS - cs.WOOP_TU_OPS
        if best is not None and ok[j]:
            best = min(best, t[j])
    return ops, best


def _sample(n, k=64, seed=0):
    return np.random.default_rng(seed).choice(n, size=min(k, n),
                                              replace=False)


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("name", ["random", "shared_edges", "u_above_1"])
def test_ray_tri_ops_match_a_loop(name, kind):
    """chip_smoke.ray_tri_ops, the operations K1 (closest) or K2 (any) needs
    per ray, against a loop over the rows of sampled rays: the t half of
    every row, u where t is in range (closest: and below the best t of the
    earlier rows), the rest where u does not rule a hit out; an occluded
    ray one whole test, a dead ray none."""
    cs = chip_smoke
    w, o, d, tn, tf = _woop_inputs(*family(name))
    tf = torch.where(torch.arange(tf.shape[0]) % 13 == 0, -1.0, tf)  # dead
    occ = ray_tri.any_hit_ref(w, o, d, tn, tf) if kind == "any" else None
    got = cs.ray_tri_ops(w, o, d, tn, tf, occ)
    t, u, _v, ok = (x.numpy() for x in ray_tri._woop_tuvok(o, d, tn, tf, w))
    tn_, tf_ = tn.numpy(), tf.numpy()
    for i in _sample(o.shape[0], 256):
        if tf_[i] < tn_[i]:
            want = 0
        elif occ is not None and bool(occ[i]):
            want = cs.WOOP_OPS
        else:
            want = _woop_rows_loop(t[i], u[i], ok[i], tn_[i], tf_[i],
                                   np.inf if occ is None else None)[0]
        assert int(got[i]) == want, i
    tested = tf >= tn if occ is None else (tf >= tn) & ~occ
    n = int(tested.sum()) * w.shape[0]
    assert n * cs.WOOP_T_OPS <= int(got[tested].sum()) < n * cs.WOOP_OPS
    assert int(got[tf < tn].sum()) == 0


def _ptrace_scene(kind):
    scene = terrain_scene("cpu", 2_000)
    return chip_smoke._woop_rebuild(scene, "cpu") \
        if kind.endswith("_mxu") else scene


@pytest.mark.parametrize("kind", ["trace_closest", "trace_any",
                                  "trace_closest_mxu", "trace_any_mxu"])
def test_trace_ops_match_a_loop(kind):
    """chip_smoke.trace_ops, the operations a clustered query needs per ray
    (K5-K8), against a loop over the slots and rows of sampled rays:
    closest hit, the rows of the listed slots whose entry is within the
    ray's min(t, tfar); any hit, every listed row of a visible ray and one
    whole test of an occluded one; rows charged as far as their test must
    run (Moller-Trumbore: through u; Woop: the t half, then u, with the
    best t carried across slots)."""
    cs = chip_smoke
    scene = _ptrace_scene(kind)
    pk = _terrain_packets(scene)
    pk.tfar[::17] = -1.0                 # dead rays inside live packets
    woop = kind.endswith("_mxu")
    blocks = scene.cluster_woop if woop else scene.cluster_tris
    test = ct._woop if woop else ct._mt
    closest = kind.startswith("trace_closest")
    ref = {"trace_closest": lambda: ct.trace_closest_ref(blocks, pk),
           "trace_any": lambda: ct.trace_any_ref(blocks, pk),
           "trace_closest_mxu": lambda: ct.trace_closest_mxu_ref(blocks, pk),
           "trace_any_mxu": lambda: ct.trace_any_mxu_ref(blocks, pk)}[kind]
    out = ref()
    got = cs.trace_ops(kind, scene, pk, out)
    whole = cs.WOOP_OPS if woop else cs.MT_OPS
    seen = set()
    dead = torch.nonzero(pk.tfar < pk.tnear)[:, 0].numpy()
    rest = torch.nonzero(pk.tfar >= pk.tnear)[:, 0].numpy()
    for i in np.concatenate([dead[_sample(len(dead), 8)],
                             rest[_sample(len(rest), 40, seed=3)]]):
        p = i // ct.P
        tn, tf = float(pk.tnear[i]), float(pk.tfar[i])
        ray = [x.reshape(1, 1, 1) for x in (*pk.o[i], *pk.d[i])]
        lim = [x.reshape(1, 1, 1) for x in (pk.tnear[i], pk.tfar[i])]
        want, best = 0, np.inf
        if tf < tn:
            seen.add("dead")
        elif not closest and bool(out[i]):
            want = whole
            seen.add("occluded")
        else:
            seen.add("tested")
            reach = min(float(out[0][i]), tf) if closest else np.inf
            for s in range(int(pk.count[p])):
                if float(pk.entry[p, s]) > reach:
                    break
                tr = blocks[pk.shortlist[p, s].long()][None]
                t, u, _v, ok = (x[0, :, 0].numpy()
                                for x in test(tr, *ray, *lim))
                if woop:
                    n, best = _woop_rows_loop(t, u, ok, tn, tf,
                                              best if closest else None)
                    want += n
                else:
                    det = cs.mt_det(tr, *ray[3:])[0, :, 0].numpy()
                    full = (np.abs(det) > 1e-18) & (u >= 0) & (u <= 1)
                    want += int(np.where(full, whole, cs.MT_U_OPS).sum())
        assert int(got[i]) == want, i
    assert "tested" in seen and "dead" in seen
    bnd, pairs = cs.trace_bound(kind, scene, pk, out)
    assert bnd[0] < pairs["pairs"][1][0]


def test_slab_live_share_counts_listed_pairs():
    scene = terrain_scene("cpu", 5_000)
    g = torch.Generator().manual_seed(4)
    n = 2048
    o = (torch.rand((n, 3), generator=g) - 0.5) * 8.0
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    pk = ct.pack(scene.cluster_min, scene.cluster_max, o, d,
                 torch.full((n,), 1e-3), torch.full((n,), 2.0), 1)
    occ = ct.trace_any_ref(scene.cluster_tris, pk)
    listed, live, warp, kept = chip_smoke.slab_live_share(scene, pk, occ)
    rp = pk.count.shape[0]
    visible = ((pk.tfar >= pk.tnear) & ~occ).view(rp, ct.P).sum(1)
    assert listed == int((visible * pk.count.long()).sum()) > 0
    assert 0.0 < live <= warp <= kept <= 1.0
    assert chip_smoke.slab_live_share(scene, pk, occ, chunk=3) \
        == (listed, live, warp, kept)


def _check_slab_ops(kind, scene):
    """chip_smoke.trace_ops with slab=True against a loop over the listed
    slots of sampled rays: a visible live ray its reciprocal direction,
    one box test per listed slot and the rows (Moller-Trumbore: through u,
    or whole; Woop: the t half, then u, then the rest) of the slots whose
    cull box `slab_live_ref` leaves it (K8: grown by `woop_cull_boxes`); an
    occluded ray one whole test; a dead ray none. The bound it gives lies
    under the listed-pair bound."""
    cs = chip_smoke
    woop = kind.endswith("_mxu")
    g = torch.Generator().manual_seed(9)
    n = 2048
    o = (torch.rand((n, 3), generator=g) - 0.5) * 8.0
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    tf = torch.where(torch.arange(n) % 19 == 0, -1.0, 2.0)
    pk = ct.pack(scene.cluster_min, scene.cluster_max, o, d,
                 torch.full((n,), 1e-3), tf, 1)
    if woop:
        blocks, test, whole = scene.cluster_woop, ct._woop, cs.WOOP_OPS
        occ = ct.trace_any_mxu_ref(blocks, pk)
        bmin, bmax = ct.woop_cull_boxes(scene.cluster_min, scene.cluster_max)
    else:
        blocks, test, whole = scene.cluster_tris, ct._mt, cs.MT_OPS
        occ = ct.trace_any_ref(blocks, pk)
        bmin, bmax = scene.cluster_min, scene.cluster_max
    got = cs.trace_ops(kind, scene, pk, occ, slab=True)
    seen = set()
    for i in _sample(pk.o.shape[0], 48, seed=5):
        p = i // ct.P
        tn, tf_i = pk.tnear[i], pk.tfar[i]
        if tf_i < tn:
            want = 0
            seen.add("dead")
        elif bool(occ[i]):
            want = whole
            seen.add("occluded")
        else:
            want = cs.SAFE_INV_OPS
            ray = [x.reshape(1, 1, 1) for x in (*pk.o[i], *pk.d[i], tn, tf_i)]
            for s in range(int(pk.count[p])):
                c = int(pk.shortlist[p, s])
                want += cs.SLAB_OPS
                if not bool(ct.slab_live_ref(pk.o[i], pk.d[i], tn, tf_i,
                                             bmin[c], bmax[c])):
                    seen.add("slab-dead")
                    continue
                tr = blocks[c][None]
                if woop:
                    t, u, _v, ok = (x[0, :, 0].numpy() for x in test(tr, *ray))
                    want += _woop_rows_loop(t, u, ok, float(tn), float(tf_i),
                                            None)[0]
                    continue
                u = ct._mt(tr, *ray)[1][0, :, 0].numpy()
                det = cs.mt_det(tr, *ray[3:6])[0, :, 0].numpy()
                full = (np.abs(det) > 1e-18) & (u >= 0) & (u <= 1)
                want += int(np.where(full, cs.MT_OPS, cs.MT_U_OPS).sum())
            seen.add("visible")
        assert int(got[i]) == want, i
    assert {"dead", "visible", "slab-dead"} <= seen
    bnd, extra = cs.trace_bound(kind, scene, pk, occ, slab=True)
    assert extra["listed pairs"][0] \
        == int(cs.trace_ops(kind, scene, pk, occ).sum())
    assert bnd[0] < extra["listed pairs"][1][0] < extra["pairs"][1][0]


def test_slab_aware_ops_match_a_loop():
    """K6's slab-aware count (`_check_slab_ops`) on terrain_scene(5_000)."""
    _check_slab_ops("trace_any", terrain_scene("cpu", 5_000))


def test_slab_aware_woop_ops_match_a_loop():
    """K8's slab-aware count (`_check_slab_ops`, Woop rows, grown boxes) on
    terrain_scene(5_000) rebuilt at cluster size 128."""
    _check_slab_ops("trace_any_mxu", _ptrace_scene("trace_any_mxu"))


def _emulate_k7(cwoop, pk, stats):
    """K7's traversal at factor 1 in groups of 32 rays, as
    csrc/cluster_trace.cu runs it: each ray's [tnear, tfar] folded (a dead
    ray, or a NaN bound, gets an empty range); per slot the block's vote
    (some live ray's min(best t, tfar) reaches the entry distance, less the
    slab test's slack: the kernel's within_reach) and the same
    condition per group; per row the t-first skip (no lane with t in range
    and below its best t) and the u-first skip (no such lane with u in
    [-1e-5, 1.001]); a strictly smaller t replaces. -> (t, u, v, tri),
    each (Rp*P,); stats counts what each skip dropped."""
    rp = pk.count.shape[0]
    tn = pk.tnear.view(rp, ct.P)
    tf = pk.tfar.view(rp, ct.P)
    live = tn <= tf
    tf_f = torch.where(live, tf.clamp(max=torch.finfo(torch.float32).max),
                       -torch.inf)
    bt = torch.full((rp, ct.P), torch.inf)
    bu = torch.zeros((rp, ct.P))
    bv = torch.zeros((rp, ct.P))
    btri = torch.full((rp, ct.P), -1, dtype=torch.int32)
    going = torch.ones(rp, dtype=torch.bool)
    rays = ct._packet_rays(pk)
    for j in range(int(pk.count.max())):
        a = torch.nonzero(going & (pk.count > j))[:, 0]
        reach = torch.minimum(bt[a], tf_f[a])
        ent = pk.entry[a, j, None]
        act = live[a] & (ent - (1e-4 * (ent.abs() + reach.abs()) + 1e-5)
                         <= reach)
        stop = ~act.any(1)
        stats["packets stopped by the vote"] += int(stop.sum())
        going[a[stop]] = False
        a, act = a[~stop], act[~stop]
        warp = per_group(act)
        stats["groups skipped by the slot"] += int((~warp).sum()) // 32
        cl = pk.shortlist[a, j].long()
        t, u, v, ok = ct._woop(cwoop[cl], *(x[a] for x in rays))
        in_range = torch.isfinite(t) & (t >= tn[a, None]) \
            & (t <= tf[a, None]) & live[a, None]
        b_t, b_u, b_v, b_tri = bt[a], bu[a], bv[a], btri[a]
        for row in range(ct.WOOP_BLOCK):
            test = warp & in_range[:, row] & (t[:, row] < b_t)
            t_ok = per_group(test)
            stats["rows skipped by t"] += int((warp & ~t_ok).sum()) // 32
            cand = t_ok & test & (u[:, row] >= -1e-5) & (u[:, row] <= 1.001)
            u_ok = per_group(cand)
            stats["rows skipped by u"] += int((t_ok & ~u_ok).sum()) // 32
            better = u_ok & cand & ok[:, row]
            b_t = torch.where(better, t[:, row], b_t)
            b_u = torch.where(better, u[:, row], b_u)
            b_v = torch.where(better, v[:, row], b_v)
            b_tri = torch.where(better, (cl[:, None] * ct.WOOP_BLOCK + row)
                                .to(torch.int32), b_tri)
        bt[a], bu[a], bv[a], btri[a] = b_t, b_u, b_v, b_tri
    return bt.reshape(-1), bu.reshape(-1), bv.reshape(-1), btri.reshape(-1)


@pytest.mark.parametrize("name", FAMILIES + ["terrain"])
def test_k7_skips_emulated_match_plain(name):
    """K7's skips, emulated in groups of 32 rays, give
    `trace_closest_mxu_ref`'s (t, u, v, tri) bit for bit on the Woop
    terrain, for the rays of each family (their own triangles left out)
    and for the terrain camera's rays; the t-first and u-first row skips
    fire, and on the camera's coherent packets the block vote and the
    per-warp slot skip."""
    scene = woop_terrain()
    if name == "terrain":
        pk = _terrain_packets(scene)
        pk.tfar[::17] = -1.0                 # dead rays inside live packets
    else:
        rays = tuple(torch.from_numpy(x) for x in family(name, n=2048)[1:])
        pk = ct.pack(scene.cluster_min, scene.cluster_max, *rays, 1)
    stats = {"packets stopped by the vote": 0, "groups skipped by the slot": 0,
             "rows skipped by t": 0, "rows skipped by u": 0}
    got = _emulate_k7(scene.cluster_woop, pk, stats)
    want = ct.trace_closest_mxu_ref(scene.cluster_woop, pk)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert stats["rows skipped by t"] > 0 and stats["rows skipped by u"] > 0
    if name != "tiny_det":   # rays along z = 0: under the terrain
        assert 0 < int((want[3] >= 0).sum()) < want[3].numel()
    if name == "terrain":    # coherent packets, each ray's hit found early
        assert stats["packets stopped by the vote"] > 0
        assert stats["groups skipped by the slot"] > 0
