"""The port's roofline.py: the JAX module's API on the H100's ceilings.

`summarize_query_log` of the queries' `rays.` counts equals the JAX
package's on the same queries' log; the ceilings that `chip_smoke.bound`
divides by are roofline.py's (patched there, the bound follows); no
constant of `tpu_restir/roofline.py` (the TPU's rates and its cost
model) appears in the port's module.
"""

import ast
import inspect

import pytest
import torch

import chip_smoke
from torch_phase1_cases import K9_CASES, phase1_case
from tpu_restir import roofline as jroofline
from tpu_restir_torch import roofline
from tpu_restir_torch.kernels import cluster_trace as ct


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")
            and (inspect.isfunction(getattr(mod, n))
                 or inspect.isclass(getattr(mod, n)))
            and getattr(getattr(mod, n), "__module__", "") == mod.__name__}


def test_same_api_as_jax():
    assert _public(jroofline) <= _public(roofline)


def test_summarize_query_log_matches_jax():
    """The port's summary of a recording's `rays.<kind>.<backend>` counts
    equals the JAX package's of the same queries' log; the recording's
    other counts are not queries."""
    log = [{"kind": "closest", "backend": "fused", "rays": 2_073_600},
           {"kind": "any", "backend": "fused", "rays": 2_073_600},
           {"kind": "any", "backend": "ptrace", "rays": 10},
           {"kind": "closest", "backend": "fcluster", "rays": 7}]
    recorded = [(f"rays.{e['kind']}.{e['backend']}", e["rays"]) for e in log]
    recorded.insert(1, ("launch.closest_hit", 1))
    assert roofline.summarize_query_log(recorded) \
        == jroofline.summarize_query_log(log)
    assert roofline.summarize_query_log([]) \
        == jroofline.summarize_query_log([])


def test_chip_smoke_bound_takes_the_ceilings_of_roofline(monkeypatch):
    assert chip_smoke.bound(roofline.HBM_BYTES_PER_S * 1e-3, 0) \
        == pytest.approx((1.0, "bytes"))
    assert chip_smoke.bound(0, roofline.FP32_OPS_PER_S * 1e-3) \
        == pytest.approx((1.0, "operations"))
    for b, o in ((1e6, 1e12), (1e9, 1e9), (123.0, 0.0)):
        ms, by = chip_smoke.bound(b, o)
        t_b = b / roofline.HBM_BYTES_PER_S * 1e3
        t_o = o / roofline.FP32_OPS_PER_S * 1e3
        assert ms == pytest.approx(max(t_b, t_o))
        assert by == ("operations" if t_o > t_b else "bytes")
    monkeypatch.setattr(roofline, "HBM_BYTES_PER_S", 1e12)
    assert chip_smoke.bound(1e9, 0)[0] == pytest.approx(1.0)
    assert (roofline.WOOP_OPS, roofline.MT_OPS, roofline.SLAB_OPS) \
        == (chip_smoke.WOOP_OPS, chip_smoke.MT_OPS, chip_smoke.SLAB_OPS) \
        == (40, 46, 28)


def _constants(mod):
    """{NAME: value} of the module-level upper-case assignments."""
    tree = ast.parse(inspect.getsource(mod))
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.isupper():
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def test_no_tpu_constant_in_the_port():
    tpu = _constants(jroofline)
    rates = ("HBM_GBPS", "MXU_BF16_TFLOPS", "VPU_F32_TOPS_EST",
             "TAKE_TILE_OPS_PER_S")
    assert set(rates) <= set(tpu)
    port = _constants(roofline)
    assert not set(tpu) & set(port)
    assert not {tpu[k] for k in rates} & set(port.values())
    assert (port["HBM_BYTES_PER_S"], port["FP32_OPS_PER_S"]) \
        == (3.35e12, 33.5e12)


def test_specs_on_the_card_ceilings():
    q = roofline.fused_query_spec("k1", 2_073_600, 36)
    assert q.flops == 2_073_600 * 36 * roofline.WOOP_OPS
    assert q.bound == "operations"
    assert q.sol_time_s() == pytest.approx(q.flops / 33.5e12)
    g = roofline.gather_spec("k3", 1920 * 1080, 5, 24, 30)
    n = 1920 * 1080
    # chip_smoke.check_gather's bytes: payload, two coordinates a tap, taps
    assert g.bytes_hbm == 4 * (n * 24 + 2 * 5 * n + 5 * n * 24)
    assert g.flops == 0 and g.bound == "bytes"
    p = roofline.ptrace_query_spec("k5", 2_073_600, 100_000, 64)
    assert p.flops == 100_000 * 64 * 256 * roofline.MT_OPS
    frame = roofline.FrameModel()
    for spec in (q, g, p):
        frame.add(spec)
    assert frame.total_sol_s() == pytest.approx(
        q.sol_time_s() + g.sol_time_s() + p.sol_time_s())
    assert "frame bound" in frame.report(0.2)


# ---------------------------------------------------------------------------
# The K5/K6 bound at any supercluster factor (chip_smoke.trace_ops,
# closest_pairs, slab_live_share): each distinct (ray, cluster) pair once
# ---------------------------------------------------------------------------

# chip_smoke's counts at factor 1 on `_packets(1)`, as they were before the
# count was written for every factor: closest_pairs, trace_ops of K5, of K6
# and of K6 slab-aware, slab_live_share
FACTOR1 = {"pairs": (60690, 73984), "trace_closest": 94675382,
           "trace_any": 10650872, "trace_any slab": 1341746,
           "slab share": (6811, 0.09925121127587726, 0.1763324034649831,
                          0.4401703127294083)}


def _packets(factor):
    """terrain_scene(5_000) (79 clusters of 64) and 2,048 rays from the
    terrain camera's eye to a 64x32 grid over and beyond the terrain (322
    miss it), packed at `factor`, with K5's t and K6's mask on them."""
    import numpy as np
    import torch

    from tpu_restir_torch.kernels import cluster_trace as ct
    from tpu_restir_torch.scene.procedural import terrain_scene
    scene = terrain_scene("cpu", 5_000)
    h, w = 32, 64
    ys, xs = np.meshgrid(np.linspace(-3.0, 9.0, h), np.linspace(-6.0, 6.0, w),
                         indexing="ij")
    at = np.stack([xs, ys, np.full_like(xs, 0.3)], -1).reshape(-1, 3)
    o = np.tile(np.array([0.0, -7.0, 4.0]), (h * w, 1))
    d = at - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = h * w
    pk = ct.pack(scene.cluster_min, scene.cluster_max,
                 torch.tensor(o, dtype=torch.float32),
                 torch.tensor(d, dtype=torch.float32),
                 torch.full((n,), 1e-3), torch.full((n,), 1e4), factor)
    t = ct.trace_closest_ref(scene.cluster_tris, pk)[0]
    occ = ct.trace_any_ref(scene.cluster_tris, pk)
    return scene, pk, t, occ


def _distinct(pk, p, c):
    """[(cluster, entry distance)] of packet p: each listed supercluster's
    F clusters min(sc F + r, c - 1) in order, a repeat left out."""
    out, seen = [], set()
    for q in range(int(pk.count[p])):
        sc = int(pk.shortlist[p, q])
        for r in range(pk.factor):
            cl = min(sc * pk.factor + r, c - 1)
            if cl not in seen:
                seen.add(cl)
                out.append((cl, float(pk.entry[p, q])))
    return out


def _counts_by_loop(scene, pk, t, occ):
    """The counts of chip_smoke's bound, packet by packet over the
    per-cluster expansion of the shortlists (`_distinct`): a live ray
    needs a cluster whose entry is within its min(t, tfar) (closest hit);
    a visible ray every listed cluster, an occluded ray one whole test
    (any hit); slab-aware, a box test each and rows only where the ray is
    slab-live on the cluster's box (upper min(t, tfar), or tfar)."""
    import torch

    from tpu_restir_torch.kernels import cluster_trace as ct
    cs = chip_smoke
    c = scene.cluster_tris.shape[0]
    got = dict.fromkeys(("per ray", "per packet", "trace_closest",
                         "trace_closest slab", "trace_any", "trace_any slab",
                         "listed", "slab-live"), 0)
    for p in range(pk.count.shape[0]):
        sl = slice(p * ct.P, (p + 1) * ct.P)
        o, d, tn, tf = pk.o[sl], pk.d[sl], pk.tnear[sl], pk.tfar[sl]
        live = tf >= tn
        vis = live & ~occ[sl]
        reach = torch.minimum(t[sl], tf)
        top = float(reach[live].max()) if live.any() else -float("inf")
        ray = [x.reshape(1, 1, ct.P) for x in (*o.T, *d.T)]
        got["trace_closest slab"] += cs.SAFE_INV_OPS * int(live.sum())
        got["trace_any"] += cs.MT_OPS * int(occ[sl].sum())
        got["trace_any slab"] += cs.SAFE_INV_OPS * int(vis.sum()) \
            + cs.MT_OPS * int(occ[sl].sum())
        for cl, ent in _distinct(pk, p, c):
            tr = scene.cluster_tris[cl][None]
            u = ct._mt(tr, *ray, tn.view(1, 1, -1), tf.view(1, 1, -1))[1]
            rows = cs.mt_row_ops(u, cs.mt_det(tr, *ray[3:]))[0].sum(0)
            box = scene.cluster_min[cl], scene.cluster_max[cl]
            within = live & (ent <= reach)
            got["per ray"] += int(within.sum())
            got["per packet"] += int(live.sum()) if ent <= top else 0
            got["trace_closest"] += int(rows[within].sum())
            near = ct.slab_live_ref(o, d, tn, reach, *box)
            got["trace_closest slab"] += cs.SLAB_OPS * int(within.sum()) \
                + int(rows[within & near].sum())
            far = ct.slab_live_ref(o, d, tn, tf, *box)
            got["trace_any"] += int(rows[vis].sum())
            got["trace_any slab"] += cs.SLAB_OPS * int(vis.sum()) \
                + int(rows[vis & far].sum())
            got["listed"] += int(vis.sum())
            got["slab-live"] += int((vis & far).sum())
    return got


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_trace_counts_each_distinct_cluster_once(factor):
    """chip_smoke's K5/K6 counts at factor F against a loop over the
    per-cluster expansion of the same shortlists (79 clusters: at F = 2
    and 4 the last supercluster repeats cluster 78 in its clamped slots);
    at F = 1 they are the counts written for factor 1 alone."""
    cs = chip_smoke
    scene, pk, t, occ = _packets(factor)
    c = scene.cluster_tris.shape[0]
    want = _counts_by_loop(scene, pk, t, occ)
    got = {
        "pairs": cs.closest_pairs(pk, t, c),
        "trace_closest": int(cs.trace_ops("trace_closest", scene, pk,
                                          (t,)).sum()),
        "trace_closest slab": int(cs.trace_ops("trace_closest", scene, pk,
                                               (t,), slab=True).sum()),
        "trace_any": int(cs.trace_ops("trace_any", scene, pk, occ).sum()),
        "trace_any slab": int(cs.trace_ops("trace_any", scene, pk, occ,
                                           slab=True).sum()),
        "slab share": cs.slab_live_share(scene, pk, occ)}
    assert got["pairs"] == (want["per ray"], want["per packet"])
    for k in ("trace_closest", "trace_closest slab", "trace_any",
              "trace_any slab"):
        assert got[k] == want[k], k
    listed, live = got["slab share"][:2]
    assert listed == want["listed"] > 0
    assert live == pytest.approx(want["slab-live"] / want["listed"], rel=1e-12)
    if factor == 1:
        assert {k: v for k, v in got.items()
                if k != "trace_closest slab"} == FACTOR1
    assert 0 < got["trace_closest slab"] < got["trace_closest"]
    bnd, extra = cs.trace_bound("trace_closest", scene, pk, (t,), slab=True)
    assert extra["listed pairs"][0] == got["trace_closest"]
    assert extra["pairs"][0] == want["per ray"] * 64
    assert bnd[0] < extra["listed pairs"][1][0]


@pytest.mark.parametrize("factor", [2, 4])
def test_repeated_slots_are_not_counted(factor):
    """Where C is not a multiple of F, the clamp of the last supercluster's
    slots repeats its last cluster (79 = 4 * 19 + 3 = 2 * 39 + 1: the last
    slot of supercluster 19, or 39, lists cluster 78 again):
    `distinct_slots` lists every slot of the kernels' expansion but those
    repeats, and `listed_clusters` counts the same pairs."""
    scene, pk, _t, _occ = _packets(factor)
    c = scene.cluster_tris.shape[0]
    s_last = -(-c // factor) - 1
    repeats = s_last * factor + factor - c
    assert repeats == {2: 1, 4: 1}[factor]
    rp = pk.count.shape[0]
    with_last = sum(
        int((pk.shortlist[p, :int(pk.count[p])] == s_last).any())
        for p in range(rp))
    assert with_last > 0
    pairs = [(int(p), int(cl)) for a, _q, cls in
             chip_smoke.distinct_slots(pk, c) for p, cl in zip(a, cls)]
    assert len(pairs) == len(set(pairs)) \
        == int(pk.count.sum()) * factor - with_last * repeats
    assert all(cl < c for _p, cl in pairs)
    assert sorted(pairs) == sorted(
        (p, cl) for p in range(rp) for cl, _e in _distinct(pk, p, c))
    assert int(chip_smoke.listed_clusters(pk, c).sum()) == len(pairs)


@pytest.mark.parametrize("case", K9_CASES)
def test_key_work_emulates_the_keys_kernel(case):
    """chip_smoke.key_work runs phase 1's keys as K9 does, the interval
    test up to the first axis after which a pair fails and the slice
    boxes up to the first overlap: its keys (as int32 bits) and counts
    equal `shortlist_keys`', so those early exits are exact; its
    operations lie between every pair's first axis and every pair's
    whole test, beside KEY_RAY_OPS a live ray."""
    cmin, cmax, rays, factor, packed = phase1_case(torch.device("cpu"),
                                                   case)
    if packed:
        pk = ct.pack(cmin, cmax, *rays, factor)
        smin, smax = ct._super_boxes(cmin, cmax, factor)
        args = (pk.o, pk.d, pk.tnear, pk.tfar, smin.contiguous(),
                smax.contiguous())
    else:
        args = (*rays, cmin, cmax)
    key, count, ops = chip_smoke.key_work(*args)
    want_key, want_count = ct.shortlist_keys(*args)
    assert torch.equal(key.view(torch.int32), want_key.view(torch.int32))
    assert torch.equal(count, want_count)
    o, d, tn, tf = args[:4]
    rp, c = key.shape
    live = ((tf >= tn) & torch.isfinite(o).all(-1)
            & torch.isfinite(d).all(-1)).reshape(rp, ct.P).sum(1)
    rows = ops - roofline.KEY_RAY_OPS * live
    least = roofline.KEY_PAIR_OPS + roofline.KEY_SPAN0_AXIS_OPS
    most = roofline.KEY_PAIR_OPS + 3 * roofline.KEY_AXIS_OPS \
        + 8 * roofline.KEY_SLICE_OPS
    assert ops.dtype == torch.int64 and ops.shape == (rp,)
    assert bool((rows >= least * c).all()) and bool((rows <= most * c).all())
    # a listed pair ran all three axes
    assert bool((rows >= least * c + count * 2 * roofline.KEY_SPAN0_AXIS_OPS)
                .all())
