"""K5's per-ray slab cull at supercluster factor 1 (cull mode 5 on every
clustered scene above SMALL_C clusters), and the counter and metric that
say how often it stages a slot.

On the CPU: an emulation of K5's slot loop in mode 5
(`csrc/cluster_trace.cu` `trace_kernel<true, false>`), at block grain
(the packet's early exit on the entry distance with the slab test's
slack, and its vote on the per-ray slab test of the slot's cluster box
up to min(best_t, tfar)), warp grain (a group of 32 rays none of which
is within reach, or none live and slab-live, skips the rows) and lane
grain (only a live, slab-live ray is a candidate in the rows, whose
u-first skip it drives), must give `trace_closest_ref`'s (t, u, v, tri)
bit for bit on incoherent bounce packets over a terrain of 5,000
triangles (79 clusters), on the terrain camera's coherent packets with
dead rays among them, on rays lying in the plane of a patch's max-x
face, which a slab test that clamps the exit would cull, and on a ray of
terrain1M's G-buffer query whose float32 hit lies outside its cluster's
box, before the box's entry distance; and on the bounce packets it
stages fewer slots than their shortlists list. The counters
`phase2.staged` and `phase2.closest_packets` of a stubbed launch, and
the reader of `staged_mean.frame` (the cull mode each launch asks for:
tests/test_torch_terrain1m.py). Marked `gpu`: K5 held bit for bit to
`trace_closest_ref` on terrain100k's G-buffer query and on a subset of
its NEE-MIS bounce-1 path query at 1080p.

The file imports nothing of JAX or of the JAX package (`python -m
pytest --noconftest -q tests/test_torch_k5_cull.py`). Tolerance: none.
"""

import collections
import contextlib
import ctypes
import types

import pytest
import torch

import chip_smoke
from perfbench import harness, trace
from perfbench.scenes import terrain
from tpu_restir_torch import rng, tracing
from tpu_restir_torch.config import CameraConfig
from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render import intersect
from tpu_restir_torch.scene.materials import MaterialSpec
from tpu_restir_torch.scene.procedural import terrain_scene
from tpu_restir_torch.scene.scene import build_scene
from torch_kernel_emulation import per_group
from torch_phase1_cases import max_face_rays, patches_scene

P = ct.P


def _emulate_k5(scene, pk, stats):
    """K5 in cull mode 5 on per-cluster boxes, as csrc/cluster_trace.cu
    runs it, a group of 32 rays for a warp. Per slot (at factor F, slot j
    is cluster min(sl[j // F] F + j % F, C - 1) behind entry distance
    q = j // F): the block's early exit (no live ray's min(best t, tfar)
    reaches the entry distance, less the slab test's slack: act); `want`,
    a ray live and slab-live for the slot's cluster box up to min(best t,
    tfar) (`slab_live_ref`);
    the block's vote (no ray wants: the slot is not staged); per group
    the slot skip (no ray act, or none wants); per row the u-first skip
    (no wanting lane has ok_det and u in [0, 1]); a strictly smaller t
    replaces, in row order. -> (t, u, v, tri), each (Rp*P,); stats counts
    the slots listed and staged and what each skip dropped."""
    ctris, cmin, cmax = scene.cluster_tris, scene.cluster_min, \
        scene.cluster_max
    c, b = ctris.shape[:2]
    f = pk.factor
    rp = pk.count.shape[0]
    o = pk.o.view(rp, P, 3)
    d = pk.d.view(rp, P, 3)
    tn = pk.tnear.view(rp, P)
    tf = pk.tfar.view(rp, P)
    live = ~(tf < tn)
    bt = torch.full((rp, P), torch.inf)
    bu = torch.zeros((rp, P))
    bv = torch.zeros((rp, P))
    btri = torch.full((rp, P), -1, dtype=torch.int32)
    going = torch.ones(rp, dtype=torch.bool)
    rays = ct._packet_rays(pk)
    rows = torch.arange(b)[None, :, None]
    n_slots = pk.count.long() * f
    stats["slots listed"] += int(n_slots.sum())
    for j in range(int(n_slots.max()) if rp else 0):
        a = torch.nonzero(going & (n_slots > j))[:, 0]
        q = min(j // f, pk.shortlist.shape[1] - 1)
        reach = torch.fmin(bt[a], tf[a])              # fminf: NaN tfar
        ent = pk.entry[a, q, None]
        act = live[a] & (ent - (1e-4 * (ent.abs() + reach.abs()) + 1e-5)
                         <= reach)
        stop = ~act.any(1)
        stats["packets stopped by the vote"] += int(stop.sum())
        going[a[stop]] = False
        a, act, reach = a[~stop], act[~stop], reach[~stop]
        cl = torch.clamp(pk.shortlist[a, q].long() * f + j % f, max=c - 1)
        want = live[a] & ct.slab_live_ref(
            o[a], d[a], tn[a], reach, cmin[cl][:, None], cmax[cl][:, None])
        staged = want.any(1)
        stats["slots culled by the vote"] += int((~staged).sum())
        a, cl, want, act = a[staged], cl[staged], want[staged], act[staged]
        stats["slots staged"] += int(a.shape[0])
        warp = per_group(act) & per_group(want)
        stats["groups skipped by the slot"] += int((~warp).sum()) // 32
        r = [x[a] for x in rays]
        t, u, v, ok = ct._mt(ctris[cl], *r)            # (A, B, P)
        ok_det = torch.abs(chip_smoke.mt_det(ctris[cl], *r[3:6])) > 1e-18
        cand = (warp & want)[:, None] & ok_det & (u >= 0.0) & (u <= 1.0)
        u_ok = per_group(cand)
        stats["rows skipped by u"] += \
            int((warp[:, None] & ~u_ok).sum()) // 32
        # the kernel's fold: row by row, a strictly smaller t replaces; so
        # the least t of the candidates' hits, the lower row on a tie
        tt = torch.where(u_ok & cand & ok, t, torch.inf)
        tmin = tt.amin(1, keepdim=True)
        jwin = torch.where(tt <= tmin, rows, b).amin(1, keepdim=True)
        jwin = torch.clamp(jwin, max=b - 1)
        tmin = tmin[:, 0]
        better = tmin < bt[a]
        bt[a] = torch.where(better, tmin, bt[a])
        bu[a] = torch.where(better, u.gather(1, jwin)[:, 0], bu[a])
        bv[a] = torch.where(better, v.gather(1, jwin)[:, 0], bv[a])
        btri[a] = torch.where(better, (cl[:, None] * b + jwin[:, 0])
                              .to(torch.int32), btri[a])
    return bt.reshape(-1), bu.reshape(-1), bv.reshape(-1), btri.reshape(-1)


def bounce_rays(scene, n, seed):
    """n bounce rays, as a path tracer's first bounce makes them from a
    tile of pixels: each packet's rays from random points of the
    triangles of two consecutive clusters of the leaf order (a patch of
    the surface), offset along the geometric normal turned to +z, in
    uniform directions of that hemisphere; every seventeenth ray dead
    (tfar < tnear)."""
    g = torch.Generator().manual_seed(seed)
    tv = scene.tri_v
    patch = 2 * scene.cluster_size
    start = torch.randint(0, tv.shape[0] - patch, (n // P,), generator=g)
    k = start.repeat_interleave(P) + torch.randint(0, patch, (n,),
                                                   generator=g)
    uv = torch.rand((n, 2), generator=g)
    flip = uv.sum(1, keepdim=True) > 1.0
    uv = torch.where(flip, 1.0 - uv, uv)
    v0, v1, v2 = tv[k, 0], tv[k, 1], tv[k, 2]
    p = v0 + uv[:, :1] * (v1 - v0) + uv[:, 1:] * (v2 - v0)
    nrm = torch.nn.functional.normalize(torch.linalg.cross(v1 - v0, v2 - v0),
                                        dim=1)
    nrm = torch.where(nrm[:, 2:] < 0.0, -nrm, nrm)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    d = torch.where((d * nrm).sum(1, keepdim=True) < 0.0, -d, d)
    o = p + 1e-4 * nrm
    tf = torch.full((n,), 1e4)
    tf[::17] = -1.0
    return (o.contiguous(), d.contiguous(), torch.full((n,), 1e-4),
            tf.contiguous())


def camera_packets(scene, h=32, w=64):
    """The bench's terrain camera at w x h in 8x32-tile packet order,
    packed at factor 1, every seventeenth ray dead."""
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
    tf = torch.full((n,), 1e4)
    tf[::17] = -1.0
    return ct.pack(scene.cluster_min, scene.cluster_max, o, d,
                   torch.full((n,), 1e-3), tf, 1)


@pytest.fixture(scope="module")
def terrain5k():
    return terrain_scene("cpu", 5_000)


CASES = ["bounce", "camera", "max_face_plane"]


@pytest.mark.parametrize("case", CASES)
def test_k5_mode5_emulated_matches_plain(terrain5k, case):
    """K5's cull in mode 5 at factor 1, emulated, gives `trace_closest_ref`
    bit for bit; its votes and skips fire. On incoherent bounce packets
    the block vote leaves most listed slots unstaged; on the max-face
    rays (the slab test's clamped-exit case) every hit is kept."""
    if case == "max_face_plane":
        scene = patches_scene("cpu")
        rays = max_face_rays("cpu")
        pk = ct.pack(scene.cluster_min, scene.cluster_max, *rays, 1)
    else:
        scene = terrain5k
        pk = ct.pack(scene.cluster_min, scene.cluster_max,
                     *bounce_rays(scene, 8 * P, 7), 1) \
            if case == "bounce" else camera_packets(scene)
    c = scene.cluster_tris.shape[0]
    assert c > ct.SMALL_C and ct.launch_mode("trace_closest", c, 1) == 5
    stats = dict.fromkeys(
        ("slots listed", "slots staged", "slots culled by the vote",
         "packets stopped by the vote", "groups skipped by the slot",
         "rows skipped by u"), 0)
    got = _emulate_k5(scene, pk, stats)
    want = ct.trace_closest_ref(scene.cluster_tris, pk)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    live = pk.tfar >= pk.tnear
    hits = int((want[3] >= 0).sum())
    assert 0 < hits < int(live.sum())
    assert 0 < stats["slots staged"] <= stats["slots listed"]
    assert stats["rows skipped by u"] > 0
    if case == "bounce":
        # incoherent packets: each lists most of the scene, and few of
        # the listed boxes lie on any of its rays within reach
        assert stats["slots listed"] > 0.5 * c * pk.count.shape[0]
        assert stats["slots staged"] < 0.5 * stats["slots listed"]
        assert stats["slots culled by the vote"] > 0
    if case == "camera":
        assert stats["packets stopped by the vote"] > 0
        assert stats["groups skipped by the slot"] > 0
    if case == "max_face_plane":
        assert hits > pk.n_rays // 2


# --- a float32 hit outside its cluster's box (terrain1M) -------------------

@pytest.fixture(scope="module")
def terrain1m():
    """The benchmark's terrain1M scene (1,002,530 triangles, 15,665
    clusters), built on the CPU (~9 s)."""
    cell = harness.find_cell(harness.load_spec(), "terrain1M.restir")
    v, m, specs = terrain.arrays(**cell.config["scene_args"])
    return build_scene(v, m, [MaterialSpec(**x) for x in specs], "cpu")


# the card's direction of pixel (1728, 408) of the bench camera's 1080p
# frame 0 on terrain1M, the first ray of packet 3114 of its G-buffer query
# (the pixel sampler's jitter differs between the card and the CPU)
EDGE_RAY_D = ("0x1.0303f8p-1", "0x1.9cdbd2p-1", "-0x1.39b46ep-2")
EDGE_TRI, EDGE_T = 921_832, 9.871846199035645


def _edge_rays(alone):
    """The 8x32 tile of packet 3114 (the CPU's camera rays, the first one
    the card's), or that first ray alone."""
    build, view = chip_smoke.SCENES["terrain1M"]
    cfg = chip_smoke.bench_cfg(1920, 1080, view)
    cam = cam_mod.make_camera(cfg.camera, "cpu")
    ys, xs = torch.meshgrid(torch.arange(408, 416), torch.arange(1728, 1760),
                            indexing="ij")
    o, d = cam_mod.generate_rays_at(cam, cfg.camera,
                                    rng.make_frame_seed(cfg.seed, 0), ys, xs)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3).clone()
    d[0] = torch.tensor([float.fromhex(x) for x in EDGE_RAY_D])
    n = 1 if alone else P
    return (o[:n].contiguous(), d[:n].contiguous(), torch.full((n,), 0.01),
            torch.full((n,), torch.inf))


@pytest.mark.parametrize("alone", [False, True])
@pytest.mark.parametrize("factor", [4, 1])
def test_k5_keeps_a_hit_outside_its_cluster_box(terrain1m, factor, alone):
    """The plain test takes a hit of triangle 921,832 at t 9.871846 that
    exact arithmetic misses (v = -3.2e-3, rounded to 0 in float32): the
    hit lies outside its cluster's box, 1.8e-4 before the box's entry
    distance and before the ray's hit at 9.872017 in an earlier slot. K5's
    early exits (`within_reach`) and its slab cull keep it through their
    slack, at the cell's factor 4 and at factor 1, in its packet and
    alone; exits on the bare entry distance (the TPU kernel's) lose it in
    each case."""
    scene = terrain1m
    pk = ct.pack(scene.cluster_min, scene.cluster_max, *_edge_rays(alone),
                 factor)
    want = ct.trace_closest_ref(scene.cluster_tris, pk)
    assert int(want[3][0]) == EDGE_TRI and float(want[0][0]) == EDGE_T
    stats = collections.Counter()
    got = _emulate_k5(scene, pk, stats)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    cl = EDGE_TRI // scene.cluster_tris.shape[1]
    listed = pk.shortlist[0, :int(pk.count[0])].long()
    q = int(torch.nonzero((listed * factor <= cl)
                          & (cl < (listed + 1) * factor))[0, 0])
    assert float(pk.entry[0, q]) > EDGE_T


# --- the counters of a launch ---------------------------------------------

class _FakeLib:
    """Stands in for the kernel library: a closest-hit launch succeeds and
    writes `slots` into its staged tensor (a CPU tensor here) as K5
    would."""

    def __init__(self, slots):
        self.slots = slots

    def cluster_trace_closest(self, *args):
        staged = args[-2]             # before the stream
        n = len(self.slots)
        (ctypes.c_int32 * n).from_address(staged)[:] = self.slots
        return 0


@contextlib.contextmanager
def _stubbed(monkeypatch, lib):
    monkeypatch.setattr(ct, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    yield


def _small_pack(c=100, n_rays=3 * P, factor=1):
    g = torch.Generator().manual_seed(2)
    lo = torch.rand((c, 3), generator=g)
    hi = lo + 0.1
    o = torch.rand((n_rays, 3), generator=g)
    d = torch.rand((n_rays, 3), generator=g)
    pk = ct.pack(lo, hi, o, d, torch.zeros(()), torch.full((), 10.0),
                 factor)
    return lo, hi, pk


def test_a_closest_launch_counts_its_staged_slots_and_packets(monkeypatch):
    """Tracing off, a K5 launch opens no span and adds to the registry
    only its host ints, `launch.trace_closest`, `cull.trace_closest` and
    `phase2.closest_packets`; the staged slots, a tensor the kernel
    writes, reach a wrapper of `tracing.count` as that tensor and the
    registry never."""
    def refuse(name):
        raise AssertionError(f"span {name} opened with tracing off")

    lo, hi, pk = _small_pack()
    rp = pk.count.shape[0]
    lib = _FakeLib([5, 0, 7])
    monkeypatch.setattr(tracing, "_recorded", refuse)
    ctris = torch.rand((lo.shape[0], 8, 9))
    seen = []
    orig = tracing.count
    before = tracing.COUNTS.copy()
    with _stubbed(monkeypatch, lib):
        monkeypatch.setattr(tracing, "count",
                            lambda name, v: (seen.append((name, v)),
                                             orig(name, v)))
        outs = ((torch.empty(pk.o.shape[0]),) * 3
                + (torch.empty(pk.o.shape[0], dtype=torch.int32),))
        ct._launch("trace_closest", ctris, pk, outs, lo, hi)
    delta = {k: tracing.COUNTS[k] - before.get(k, 0)
             for k in tracing.COUNTS if tracing.COUNTS[k] != before.get(k, 0)}
    assert delta == {"launch.trace_closest": 1, "cull.trace_closest": 1,
                     "phase2.closest_packets": rp}
    got = dict(seen)
    assert torch.is_tensor(got["phase2.staged"])
    assert got["phase2.staged"].tolist() == [5, 0, 7]
    assert got["phase2.closest_packets"] == rp == 3


# --- the reader of staged_mean.frame -----------------------------------------

def _traced(counts):
    doc = {"traceEvents": [{"ph": "X", "cat": "user_annotation",
                            "name": "frame", "ts": 0.0, "dur": 100.0}]}
    tl = trace.parse_chrome_trace(doc, 1)
    return trace.Traced(device=tl, spans=tl, counts=counts, count_units=1,
                        missing={}, period_ms=1.0)


def test_the_staged_reader_reads_its_counts():
    mod = harness.metric_module("staged_mean.frame")
    (spec,) = mod.COUNTS
    assert (spec.module, spec.attr) == ("tpu_restir_torch.tracing", "count")
    others = [s.name for m in ("shortlist_mean.frame", "slots_mean.frame")
              for s in harness.metric_module(m).COUNTS]
    assert spec.name not in others
    staged = torch.tensor([3, 4, 0], dtype=torch.int32)
    assert spec.shape(("phase2.staged", staged), {}) == \
        ("phase2.staged", 7.0)
    calls = [("phase1.listed", 3000.0), ("phase1.packets", 4.0),
             ("launch.trace_closest", 1.0), ("cull.trace_closest", 1.0),
             ("phase2.staged", 200.0), ("phase2.closest_packets", 4.0),
             ("phase2.slots", 3000.0), ("phase1.listed", 1000.0),
             ("phase1.packets", 4.0), ("phase2.slots", 1000.0),
             ("launch.trace_any", 1.0), ("cull.trace_any", 1.0)]
    traced = _traced({"count.staged": calls})
    assert mod.read(traced) == pytest.approx(50.0)
    line = mod.describe(traced)
    assert ("50 a packet, against 500 clusters listed and 500 slots given"
            in line)
    assert "mode 5: 1 of 1" in line
    # a program that counts no staged slots (the parent) reads nothing
    uncounted = [x for x in calls if not x[0].startswith("phase2.")]
    assert mod.read(_traced({"count.staged": uncounted})) is None
    assert mod.read(_traced({})) is None
    mod.describe(_traced({}))


def test_the_staged_reader_through_the_benchmark_wrapper(monkeypatch):
    """The metric's wrapper installed as in a traced run's counted unit,
    with the shortlist and slots readers' beside it: a stubbed K5 launch
    that stages 5, 0 and 7 slots of three packets reads 4 a packet."""
    mods = [harness.metric_module(m) for m in
            ("shortlist_mean.frame", "slots_mean.frame", "staged_mean.frame")]
    lib = _FakeLib([5, 0, 7])
    sp = trace.Spans([s for m in mods for s in m.COUNTS], ranges=False)
    with _stubbed(monkeypatch, lib):
        sp.install()
        try:
            lo, hi, pk = _small_pack()
            ctris = torch.rand((lo.shape[0], 8, 9))
            outs = ((torch.empty(pk.o.shape[0]),) * 3
                    + (torch.empty(pk.o.shape[0], dtype=torch.int32),))
            ct._launch("trace_closest", ctris, pk, outs, lo, hi)
        finally:
            sp.remove()
    assert not sp.missing and tracing.count.__name__ == "count"
    traced = _traced(sp.calls)
    short, slots, staged = (m.read(traced) for m in mods)
    assert staged == pytest.approx(4.0)
    assert short == slots > staged


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_k5_mode5_on_terrain100k_gbuffer_and_bounce_queries(cuda):
    """K5 at factor 1 in cull mode 5 against `trace_closest_ref`, bit for
    bit, on terrain100k at 1080p: the G-buffer query (coherent packets,
    ~5 clusters listed) and every 32nd packet of the NEE-MIS frame's
    bounce-1 path query (incoherent, ~1,000 listed), where it stages far
    fewer slots than it is given."""
    scene, view = chip_smoke.large_scene("terrain100k", cuda)
    c = scene.cluster_tris.shape[0]
    assert ct.launch_mode("trace_closest", c, 1) == 5
    gbuf, _any = chip_smoke.capture_packets(
        scene, chip_smoke.bench_cfg(1920, 1080, view), cuda)
    cfg = chip_smoke.path_cfg(1920, 1080, "nee", view,
                              direct_strategy="mis")
    calls = []
    with tracing.recording() as rec, chip_smoke.all_packets(calls):
        chip_smoke._path_frame(scene, cfg, cuda, 1)
    qlog = intersect.queries(rec)
    roles = chip_smoke.QUERY_ROLES["nee-mis"]
    # the first chunk of bounce 1's path query: its queries' calls in order
    chunk = cfg.intersector.ptrace_chunk
    at = sum(-(-e["rays"] // chunk) for e in qlog[:len(roles)])
    kind, bounce = calls[at]
    assert kind == "closest" and qlog[len(roles)]["kind"] == "closest"
    bounce = bounce.take(torch.arange(0, bounce.count.shape[0], 32,
                                      device=cuda))
    for pk, what in ((gbuf, "G-buffer"), (bounce, "bounce 1")):
        got = ct.closest_packets(scene.cluster_tris, scene.cluster_min,
                                 scene.cluster_max, pk)
        want = ct.trace_closest_ref(scene.cluster_tris, pk)
        for x, y in zip(got, want):
            assert torch.equal(x, y), what
        assert int((want[3] >= 0).sum()) > 0, what
        staged = chip_smoke.staged_slots(
            lambda: ct.closest_packets(scene.cluster_tris, scene.cluster_min,
                                       scene.cluster_max, pk))
        listed = float(pk.count.float().mean())
        assert 0 < staged <= listed, what
        if what == "bounce 1":
            assert listed > 500 and staged < 0.25 * listed
