"""The benchmark's terrain1M configuration and what its cell reads, on the
CPU: the clustered traversal at supercluster factor 4 through the
harness's own path against the plain reference, the frozen generator at
1,000,000 triangles and the traversal's shape on it, the spans and
counters of the factor > 1 path (`phase1.superboxes`, `phase2.slots`,
`cull.*`), and the two metric readers that read them. One test, marked
`gpu`, runs the cell at 64x32 on the card with the full scene. The file
imports nothing of JAX or of the JAX package, so it also runs where they
are absent (`python -m pytest --noconftest -q tests/test_torch_terrain1m.py`).
Its plain K5/K6 loops run many mid-sized ops, which under parallel test
workers wait on PyTorch's thread pool: the one-thread rule of
`tests/conftest.py` is what keeps them fast.
"""

import contextlib
import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import check, harness, run, trace, window
from perfbench.scenes import terrain
from tpu_restir_torch import tracing
from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.renderer import Renderer
from tpu_restir_torch.tools import bench_terrain1m

CELL = "terrain1M.restir"
CPU = torch.device("cpu")
SMALL = (64, 32)


def _cell(**scene_args):
    cell = harness.find_cell(harness.load_spec(), CELL)
    cfg = dict(cell.config, scene_args=dict(cell.config["scene_args"],
                                            **scene_args))
    return dataclasses.replace(cell, config=cfg)


def _totals(recorded, prefix=""):
    """The counts of a `tracing.recording()` summed by name, a tensor value
    summed over its elements (as the benchmark's wrappers do)."""
    out = {}
    for name, v in recorded:
        if name.startswith(prefix):
            out[name] = out.get(name, 0.0) + (
                float(v.sum()) if hasattr(v, "sum") else float(v))
    return out


# --- factor 4 through the harness's path, against the reference -----------

def test_factor4_frames_through_the_harness_equal_the_reference(monkeypatch):
    """The cell's scene cut to ~5,000 triangles (79 clusters) with
    SUPER_MAX lowered to 20: every query packs at factor 4 and closest
    hit would cull in mode 5 on the card. Three chained frames of the
    Renderer that the harness builds equal the reference's to the bound
    of the terrain100k case (at most 2 pixels off)."""
    monkeypatch.setattr(ct, "SUPER_MAX", 20)
    cell = _cell(n_tris=5_000)
    seeds = harness.run_seeds(2 ** 33 + 21)
    prog = window.Program(cell, seeds, CPU, SMALL)
    c = prog.scene.cluster_tris.shape[0]
    assert ct.pick_factor(c) == 4
    assert ct._skip_for("closest", c, 4) == 5
    assert ct.cull_boxes(prog.scene.cluster_min, prog.scene.cluster_max,
                         4)[2]
    r = Renderer(prog.scene, prog.cfg, CPU)
    with tracing.recording() as seen:
        port = [r.step().clone() for _ in range(3)]
    got = _totals(seen)
    # the slots given to phase 2 are the listed superclusters times 4
    assert got["phase1.listed"] > 0
    assert got["phase2.slots"] == 4 * got["phase1.listed"]
    ref = check.ref_restir_frames(cell, seeds, 3, CPU, SMALL)
    for p, q in zip(port, ref):
        assert check.pixels_off(p, q) <= 2.0 / (SMALL[0] * SMALL[1])


# --- the frozen generator at 1M ---------------------------------------------

def test_the_frozen_generator_at_1m_gives_the_factor4_scene():
    v, m, specs = terrain.arrays(**harness.find_cell(
        harness.load_spec(), CELL).config["scene_args"])
    assert v.shape == (1_002_530, 3, 3) and m.shape == (1_002_530,)
    from tpu_restir_torch.scene.materials import MaterialSpec
    from tpu_restir_torch.scene.scene import build_scene
    scene = build_scene(v, m, [MaterialSpec(**d) for d in specs], "cpu")
    info = bench_terrain1m.scene_info(scene)
    assert info == {"triangles": 1_002_530, "clusters": 15_665,
                    "cluster_size": 64, "factor": 4, "S": 3_917,
                    "cull_modes": {"closest": 5, "any": 5},
                    "per_cluster_boxes": True}


# --- the spans and counters of the factor > 1 path -------------------------

def _boxes_and_rays(n_rays=700, n_clusters=40, seed=0):
    """Random cluster boxes in [-1, 1]^3 and rays from above them."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.rand((n_clusters, 3), generator=g) * 1.6 - 1.0
    hi = lo + 0.05 + torch.rand((n_clusters, 3), generator=g) * 0.3
    o = torch.rand((n_rays, 3), generator=g) * 0.4 + torch.tensor(
        [-0.2, -0.2, 3.0])
    d = torch.nn.functional.normalize(
        torch.rand((n_rays, 3), generator=g) * 1.2 - torch.tensor(
            [0.6, 0.6, 1.6]), dim=1)
    return lo, hi, o, d, torch.zeros(()), torch.full((), 1e4)


@pytest.mark.parametrize("factor", [1, 4])
def test_a_cpu_pack_opens_the_superboxes_span_under_a_collector(factor):
    opened = []

    @contextlib.contextmanager
    def collector(name):
        opened.append(name)
        yield

    lo, hi, o, d, tn, tf = _boxes_and_rays()
    with tracing.collecting(collector):
        ct.pack(lo, hi, o, d, tn, tf, factor)
    assert opened.count("phase1.superboxes") == 1
    assert opened.index("phase1.superboxes") < opened.index("phase1.sort")


def test_a_profiled_pack_holds_the_superboxes_range():
    lo, hi, o, d, tn, tf = _boxes_and_rays()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ct.pack(lo, hi, o, d, tn, tf, 4)
    names = [e.name for e in prof.events()]
    assert names.count("phase1.superboxes") == 1


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_the_slots_are_the_listed_count_times_the_factor(factor):
    """`phase2.slots` sums to count * factor over the packets, and is
    handed to the registry as a tensor that it leaves untouched."""
    lo, hi, o, d, tn, tf = _boxes_and_rays()
    before = tracing.COUNTS.copy()
    with tracing.recording() as seen:
        pk = ct.pack(lo, hi, o, d, tn, tf, factor)
    got = _totals(seen)
    assert got["phase2.slots"] == factor * float(pk.count.sum()) > 0
    assert got["phase1.packets"] == pk.count.shape[0]
    assert tracing.COUNTS["phase2.slots"] == before["phase2.slots"]
    # the plain version walks exactly those slots
    walked = sum(a.shape[0] for a, _c in ct._slots(lo.shape[0], pk))
    assert walked == got["phase2.slots"]


@pytest.mark.parametrize("factor", [1, 4])
def test_no_launch_is_culled_on_cpu_tensors(factor):
    lo, hi, o, d, tn, tf = _boxes_and_rays()
    g = torch.Generator().manual_seed(1)
    c = lo.shape[0]
    ctris = torch.rand((c, 8, 9), generator=g)
    before = tracing.counted("cull.")
    assert set(before) >= {"cull.trace_closest", "cull.trace_any"}
    ct.trace_closest(ctris, lo, hi, o, d, tn, tf, factor=factor)
    ct.trace_any(ctris, lo, hi, o, d, tn, tf, factor=factor)
    assert tracing.counted("cull.") == before


class _FakeLib:
    """Stands in for the kernel library: every launch succeeds and does
    nothing, and the culling mode it was given is kept."""

    def __init__(self):
        self.skips = []

    def _entry(self, *args):
        self.skips.append(args[16])   # after the rays, tables, boxes, sizes
        return 0

    cluster_trace_closest = cluster_trace_any = _entry


# kind, factor, clusters -> culled in mode 5
@pytest.mark.parametrize("kind,factor,c,culled", [
    ("trace_closest", 1, 100, True), ("trace_closest", 4, 100, True),
    ("trace_closest", 4, 40, False), ("trace_any", 1, 100, True),
    ("trace_any", 4, 100, True), ("trace_any", 1, 40, False),
    ("trace_closest_mxu", 1, 100, False), ("trace_any_mxu", 1, 100, True)])
def test_a_launch_that_culls_in_mode5_is_counted(monkeypatch, kind, factor,
                                                 c, culled):
    """`cull.<kind>` counts the K5/K6 launches whose per-ray cull mode is
    5: closest hit and any hit above SMALL_C clusters (closest hit on
    per-cluster boxes, so at factor 1 too); the Woop closest hit (K7)
    keeps mode 0 on the same scene, its own decision (`launch_mode`), and
    the Woop any hit (K8) culls. The launch itself is stubbed (no card
    here)."""
    lib = _FakeLib()
    monkeypatch.setattr(ct, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    g = torch.Generator().manual_seed(2)
    lo = torch.rand((c, 3), generator=g)
    hi = lo + 0.1
    ctris = torch.rand((c, 4, 3 * ct.WOOP_BLOCK) if kind.endswith("_mxu")
                       else (c, 8, 9), generator=g)
    o = torch.rand((ct.P, 3), generator=g)
    d = torch.rand((ct.P, 3), generator=g)
    pk = ct.pack(lo, hi, o, d, torch.zeros(()), torch.full((), 10.0),
                 factor)
    outs = ((torch.empty(ct.P), torch.empty(ct.P), torch.empty(ct.P),
             torch.empty(ct.P, dtype=torch.int32))
            if kind.startswith("trace_closest")
            else (torch.empty(ct.P, dtype=torch.bool),))
    before = tracing.COUNTS.copy()
    ct._launch(kind, ctris, pk, outs, lo, hi)
    assert lib.skips == [5 if culled else 0]
    assert tracing.COUNTS["launch." + kind] == before["launch." + kind] + 1
    assert tracing.COUNTS["cull." + kind] == before["cull." + kind] \
        + int(culled)


def test_off_the_factor4_pack_opens_nothing(monkeypatch):
    """Without a profiler or a collector the new span is the shared null
    context and `pack` records nothing: no range is opened, and the
    registry holds no tensor count."""
    assert tracing.span("phase1.superboxes") is tracing.span("frame")

    def refuse(name):
        raise AssertionError(f"span {name} opened with tracing off")

    monkeypatch.setattr(tracing, "_recorded", refuse)
    lo, hi, o, d, tn, tf = _boxes_and_rays()
    before = tracing.COUNTS.copy()
    pk = ct.pack(lo, hi, o, d, tn, tf, 4)
    assert tracing.COUNTS["phase2.slots"] == before["phase2.slots"]
    assert tracing.COUNTS["phase1.packets"] == before["phase1.packets"] \
        + pk.count.shape[0]


# --- the readers ------------------------------------------------------------

def _chrome(names, with_spans=True):
    """Two units of 10 ms: span k of `names` 90 us long at 100 (k + 1) us
    into the unit, launching one kernel of 10 (k + 1) us."""
    ev = []
    corr = 0
    for u in range(2):
        base = 10_000.0 * u
        if with_spans:
            ev.append({"ph": "X", "cat": "user_annotation", "name": "frame",
                       "ts": base, "dur": 2_000})
        for k, name in enumerate(names):
            t = base + 100.0 * (k + 1)
            corr += 1
            if with_spans:
                ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                           "ts": t, "dur": 90})
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": t + 10, "dur": 5,
                       "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "kernel", "name": f"k{k}",
                       "ts": t + 20, "dur": 10.0 * (k + 1),
                       "args": {"correlation": corr}})
    return {"traceEvents": ev}


def _traced(doc, counts=None):
    tl = trace.parse_chrome_trace(doc, 2)
    return trace.Traced(device=tl, spans=tl, counts=counts or {},
                        count_units=1, missing={}, period_ms=1.0)


def test_the_superboxes_reader_reads_its_span():
    mod = harness.metric_module("phase1_ms.superboxes")
    assert mod.SPANS == []
    names = ["phase1.superboxes", "phase1.keys", "phase1.sort"]
    traced = _traced(_chrome(names))
    assert mod.read(traced) == pytest.approx(0.010)
    assert "1 calls, 1 launches, kernels 0.010 ms" in mod.describe(traced)
    # a program without the span reads nothing
    absent = _traced(_chrome(names[1:]))
    assert mod.read(absent) is None and "0 calls" in mod.describe(absent)


def test_the_slots_reader_reads_its_counts():
    mod = harness.metric_module("slots_mean.frame")
    (spec,) = mod.COUNTS
    assert (spec.module, spec.attr) == ("tpu_restir_torch.tracing", "count")
    # a distinct record from shortlist_mean.frame's, which wraps the same
    # function in the same counted unit
    (other,) = harness.metric_module("shortlist_mean.frame").COUNTS
    assert spec.name != other.name
    slots = torch.tensor([3, 4], dtype=torch.int32).expand(4, 2)
    assert spec.shape(("phase2.slots", slots), {}) == ("phase2.slots", 28.0)
    calls = [("phase1.listed", 300.0), ("phase1.packets", 8.0),
             ("phase2.slots", 1200.0), ("launch.trace_closest", 1.0),
             ("cull.trace_closest", 1.0), ("launch.trace_any", 1.0),
             ("cull.trace_any", 1.0), ("phase1.listed", 60.0),
             ("phase1.packets", 4.0), ("phase2.slots", 240.0),
             ("launch.trace_any", 1.0), ("cull.trace_any", 1.0)]
    traced = _traced(_chrome(["frame"]), {"count.slots": calls})
    assert mod.read(traced) == pytest.approx(120.0)
    line = mod.describe(traced)
    assert "closest hit (K5) 1 of 1, any hit (K6) 2 of 2" in line
    # a program that counts no slots and no culls reads nothing
    uncounted = [c for c in calls if c[0] != "phase2.slots"
                 and not c[0].startswith("cull.")]
    assert mod.read(_traced(_chrome([]), {"count.slots": uncounted})) is None
    assert mod.read(_traced(_chrome([]), {})) is None


def test_the_slots_reader_through_the_benchmark_wrapper():
    """Both counting wrappers installed together, as in a traced run of
    the cell: each sees every call, and at factor 4 the slots a packet
    are four times the clusters listed a packet."""
    mods = [harness.metric_module(m)
            for m in ("shortlist_mean.frame", "slots_mean.frame")]
    lo, hi, o, d, tn, tf = _boxes_and_rays()
    sp = trace.Spans([s for m in mods for s in m.COUNTS], ranges=False)
    sp.install()
    try:
        ct.pack(lo, hi, o, d, tn, tf, 4)
    finally:
        sp.remove()
    assert not sp.missing and tracing.count.__name__ == "count"
    traced = _traced(_chrome([]), sp.calls)
    short, slots = (m.read(traced) for m in mods)
    assert short > 0 and slots == pytest.approx(4 * short)


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_the_cell_at_64x32_on_the_card(cuda):
    """The whole 1M-triangle scene at 64x32 through the traced run: the
    frames agree with the reference, closest-hit launches cull in mode 5
    and the slots reader reads."""
    cell = harness.find_cell(harness.load_spec(), CELL)
    before = tracing.COUNTS["cull.trace_closest"]
    res = run.run_cell(cell, 2 ** 32 + 7, 0.5, True, cuda, size=SMALL)
    assert res["correct"] is True, res["checks"]
    assert tracing.COUNTS["cull.trace_closest"] > before
    assert res["metrics"]["slots_mean.frame"]["value"] > 0
