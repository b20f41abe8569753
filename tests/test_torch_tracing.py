"""The port's spans and counters (`tpu_restir_torch.tracing`), the
per-pass timers that read the spans, and the benchmark's readers of them
(`perfbench/metrics/`, `perfbench/program_spans.py`), on the CPU.

Without a profiler or a pass collector a span is the shared null
context; the registry never touches a tensor count; under torch.profiler
a ReSTIR frame holds each pass span once, in pipeline order, inside
`frame`, and a clustered query each phase-1 span once a `pack`; the
counts equal the packets' own; a recording keeps every count in call
order, and a Cornell frame's `rays.` counts are its 28 rays a pixel;
frames are bit-identical with tracing on and off; `profile_passes` runs
`restir_step` once a frame."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness, program_spans, trace
from tpu_restir_torch import bench, metrics, rng, roofline, tracing
from tpu_restir_torch import renderer as renderer_mod
from tpu_restir_torch.config import (CameraConfig, RenderConfig,
                                     RenderParams, RestirParams)
from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.render import intersect
from tpu_restir_torch.render.camera import make_camera
from tpu_restir_torch.render.integrators.restir.pipeline import (
    init_restir_state, restir_step)
from tpu_restir_torch.renderer import Renderer
from tpu_restir_torch.scene.cornell import cornell_box

PASSES = ("restir.gbuffer", "restir.initial", "restir.temporal",
          "restir.spatial", "restir.shade")
PHASE1 = ("phase1.interval", "phase1.boxcull", "phase1.sort")


def _cfg(**restir):
    kw = dict(m_area=1, m_brdf=1, do_temporal_reuse=True,
              do_spatial_reuse=True, spatial_neighbor_count=3,
              spatial_mis="pairwise")
    kw.update(restir)
    return RenderConfig(
        camera=CameraConfig(width=16, height=12, fov_y_deg=45.0,
                            view_from=(0.0, -3.9, 1.0),
                            view_at=(0.0, 0.0, 1.0), pixel_sampler="random"),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(**kw), integrator="restir")


@pytest.fixture(scope="module")
def scene():
    return cornell_box("cpu")


def _boxes_and_rays(n_rays=700, n_clusters=40, seed=0):
    """Random cluster boxes in [-1, 1]^3 and rays from outside them."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.rand((n_clusters, 3), generator=g) * 1.6 - 1.0
    hi = lo + 0.05 + torch.rand((n_clusters, 3), generator=g) * 0.3
    o = torch.rand((n_rays, 3), generator=g) * 0.4 + torch.tensor(
        [-0.2, -0.2, 3.0])
    d = torch.nn.functional.normalize(
        torch.rand((n_rays, 3), generator=g) * 1.2 - torch.tensor(
            [0.6, 0.6, 1.6]), dim=1)
    return lo, hi, o, d, torch.zeros(()), torch.full((), 1e4)


def test_off_a_span_is_the_null_context_and_a_tensor_count_untouched():
    assert tracing._collector is None
    assert tracing.span("restir.gbuffer") is tracing.span("frame")
    before = tracing.COUNTS.copy()

    class Untouchable:
        def sum(self, *a, **k):
            raise AssertionError("a tensor count was read with tracing off")

    x = torch.arange(5, dtype=torch.int32)
    tracing.count("phase1.listed", Untouchable())
    tracing.count("phase1.listed", x)
    assert tracing.COUNTS == before
    assert torch.equal(x, torch.arange(5, dtype=torch.int32))
    tracing.count("test.ints", 2)
    assert tracing.COUNTS["test.ints"] == before["test.ints"] + 2


def test_off_the_program_opens_no_range_and_records_no_event(scene,
                                                             monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range or event with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    r = Renderer(scene, _cfg(), device="cpu")
    r.run(2)
    assert not r.timers.mean_ms()


def _program_events(prof, names):
    return sorted((e for e in prof.events() if e.name in names),
                  key=lambda e: e.time_range.start)


def test_a_profiled_frame_holds_each_pass_span_once_inside_frame(scene):
    r = Renderer(scene, _cfg(), device="cpu")
    r.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.step()
    ev = _program_events(prof, ("frame",) + PASSES)
    assert [e.name for e in ev] == ["frame", *PASSES]
    frame = ev[0].time_range
    for e in ev[1:]:
        assert frame.start <= e.time_range.start <= e.time_range.end \
            <= frame.end
    for a, b in zip(ev[1:], ev[2:]):
        assert a.time_range.end <= b.time_range.start


def test_a_profiled_query_holds_each_phase1_span_once_a_pack():
    lo, hi, o, d, tn, tf = _boxes_and_rays()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ct.pack(lo, hi, o, d, tn, tf, 1)
        ct.pack(lo, hi, o[:300], d[:300], tn, tf, 1)
    ev = _program_events(prof, PHASE1)
    assert [e.name for e in ev] == list(PHASE1) * 2


def test_the_counts_are_the_packets_own(monkeypatch):
    """A wrapper in place of `tracing.count` sees every call: phase 1's
    listed pairs are the packets' counts, its packets and pairs their
    number and that times the clusters. Profiled too, the registry
    leaves the tensor count alone: only such a wrapper sums it."""
    lo, hi, o, d, tn, tf = _boxes_and_rays()
    seen = []
    orig = tracing.count
    monkeypatch.setattr(tracing, "count",
                        lambda name, v: (seen.append((name, v)),
                                         orig(name, v)))
    pk = ct.pack(lo, hi, o, d, tn, tf, 1)
    got = {n: v for n, v in seen if n.startswith("phase1.")}
    rp = pk.count.shape[0]
    assert rp == 3 and int(pk.count.sum()) > 0
    assert torch.equal(got["phase1.listed"], pk.count)
    assert got["phase1.packets"] == rp and got["phase1.pairs"] == rp * 40
    monkeypatch.setattr(tracing, "count", orig)
    before = tracing.COUNTS.copy()
    with profile(activities=[ProfilerActivity.CPU]):
        pk = ct.pack(lo, hi, o, d, tn, tf, 1)
    assert tracing.COUNTS["phase1.listed"] == before["phase1.listed"]
    assert tracing.COUNTS["phase1.packets"] == before["phase1.packets"] \
        + rp


def test_a_recording_keeps_every_count_in_call_order():
    """`recording()` keeps each count() call of its block, an int or a
    tensor value as it was given (never read), in call order; COUNTS
    moves as count alone moves it; a recording opened inside another
    takes the calls of its own block."""
    before = tracing.COUNTS.copy()

    class Untouchable:
        def sum(self, *a, **k):
            raise AssertionError("a recording read a tensor count")

    x, u = torch.arange(3), Untouchable()
    with tracing.recording() as outer:
        tracing.count("test.rec_int", 2)
        with tracing.recording() as inner:
            tracing.count("test.rec_tensor", x)
            tracing.count("test.rec_tensor", u)
        tracing.count("test.rec_int", 3)
    tracing.count("test.rec_int", 4)
    assert inner == [("test.rec_tensor", x), ("test.rec_tensor", u)]
    assert inner[0][1] is x and inner[1][1] is u
    assert outer == [("test.rec_int", 2), ("test.rec_int", 3)]
    assert tracing._recording is None
    assert tracing.COUNTS["test.rec_int"] == before["test.rec_int"] + 9
    assert tracing.COUNTS["test.rec_tensor"] == before["test.rec_tensor"]


def test_the_census_of_a_cornell_frame_is_28_rays_a_pixel(scene):
    """The `rays.` counts of one 16x16 Cornell frame of the bench
    configuration, recorded: the G-buffer's closest-hit query and 27
    any-hit queries, each of every pixel, through the fused backend: 28
    rays a pixel, the count of `metrics.rays_per_pixel` and of the
    repository's bench.py. `summarize_query_log` reads the same split,
    and COUNTS gains the same rays."""
    cfg = bench.bench_cfg(16, 16)
    n = 16 * 16
    before = tracing.counted("rays.")
    with tracing.recording() as rec:
        restir_step(scene, make_camera(cfg.camera, "cpu"), cfg,
                    rng.make_frame_seed(0, 0), init_restir_state(16, 16,
                                                                 "cpu"), 0)
    queries = intersect.queries(rec)
    assert [e["kind"] for e in queries] == ["closest"] + ["any"] * 27
    assert all(e["backend"] == "fused" and e["rays"] == n for e in queries)
    assert metrics.rays_per_pixel(cfg) == 28
    assert roofline.summarize_query_log(rec) == {
        "closest": {"queries": 1, "rays": n},
        "any": {"queries": 27, "rays": 27 * n}, "total_rays": 28 * n}
    gained = {k: v - before.get(k, 0)
              for k, v in tracing.counted("rays.").items()}
    assert {k: v for k, v in gained.items() if v} \
        == {"rays.closest.fused": n, "rays.any.fused": 27 * n}


def test_frames_are_identical_with_tracing_on_and_off(scene):
    plain = Renderer(scene, _cfg(), device="cpu")
    plain.run(3)
    traced = Renderer(scene, _cfg(), device="cpu")
    traced.step()
    with profile(activities=[ProfilerActivity.CPU]):
        traced.step()
    timed = Renderer(scene, _cfg().replace(profile_passes=True),
                     device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        timed.step()
    traced.step()
    timed.run(2)
    for r in (traced, timed):
        assert torch.equal(r.accumulator, plain.accumulator)
        assert torch.equal(r.moment2, plain.moment2)


@pytest.mark.parametrize("visibility", [False, True])
def test_profile_passes_runs_the_step_once_a_frame(scene, monkeypatch,
                                                   visibility):
    calls = []
    orig = renderer_mod.restir_step
    monkeypatch.setattr(renderer_mod, "restir_step",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    r = Renderer(scene, _cfg(do_visibility_pass=visibility,
                             spatial_pass_count=2).replace(
                                 profile_passes=True), device="cpu")
    r.run(3)
    assert len(calls) == 3
    ms = r.timers.mean_ms()
    keys = {"gbuffer", "initial", "temporal", "spatial", "shade"}
    assert set(ms) == keys | ({"visibility"} if visibility else set())
    # two spatial passes a frame are one reading a frame
    assert r.timers.counts == {k: 3 for k in ms}
    assert all(v > 0.0 for v in ms.values())


def test_pass_timers_resolve_when_read():
    timers = metrics.PassTimers()
    with timers.frame():
        for name in ("restir.spatial", "restir.spatial", "phase1.sort"):
            with tracing.span(name):
                pass
    assert tracing.span("restir.shade") is tracing.span("frame")
    ms = timers.mean_ms()
    assert set(ms) == {"spatial"} and timers.counts == {"spatial": 1}


# --- the benchmark's readers ----------------------------------------------

def _chrome(with_spans=True, names=None):
    """Two units of 10 ms: each a frame (2 ms) holding restir.initial,
    restir.temporal, restir.shade and the phase-1 spans (or the spans
    `names`), 90 us each and 100 us apart; span k launches kernels of
    10 * (k + 1) us in all (the temporal span two of 10 us, 40 us apart),
    and one kernel of 7 us is launched in the frame outside the spans."""
    ev = []
    corr = [0]

    def x(cat, name, ts, dur):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur})

    def kernel(name, launch, start, dur):
        corr[0] += 1
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": launch, "dur": 5,
                   "args": {"correlation": corr[0]}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start,
                   "dur": dur, "args": {"correlation": corr[0]}})

    names = names or ["restir.initial", "restir.temporal", "restir.shade",
                      "phase1.interval", "phase1.boxcull", "phase1.sort"]
    for u in range(2):
        base = 10_000.0 * u
        if with_spans:
            x("user_annotation", "frame", base, 2_000)
        for k, name in enumerate(names):
            t = base + 100.0 * (k + 1)
            if with_spans:
                x("user_annotation", name, t, 90)
            if name == "restir.temporal":
                kernel("k1a", t + 10, t + 20, 10)
                kernel("k1b", t + 15, t + 70, 10)
            else:
                kernel(f"k{k}", t + 10, t + 20, 10.0 * (k + 1))
        kernel("outside", base + 1_500, base + 1_520, 7)
    return {"traceEvents": ev}


def _traced(doc, counts=None):
    tl = trace.parse_chrome_trace(doc, 2)
    return trace.Traced(device=tl, spans=tl, counts=counts or {},
                        count_units=1, missing={}, period_ms=1.0)


# metric, device ms a unit, launches a unit, idle ms a unit charged to it
@pytest.mark.parametrize("metric,ms,launches,idle", [
    ("pass_ms.initial", 0.010, 1, 0.090),
    ("pass_ms.temporal", 0.020, 2, 0.040),
    ("pass_ms.shade", 0.030, 1, 0.110),
    ("phase1_ms.interval", 0.040, 1, 0.060),
    ("phase1_ms.boxcull", 0.050, 1, 0.0),
    ("phase1_ms.sort", 0.060, 1, 0.0)])
def test_each_span_metric_reads_its_span(metric, ms, launches, idle):
    mod = harness.metric_module(metric)
    assert mod.SPANS == []
    traced = _traced(_chrome())
    assert mod.read(traced) == pytest.approx(ms)
    line = mod.describe(traced)
    assert f"1 calls, {launches} launches, kernels {ms:.3f} ms, device " \
        f"idle {idle:.3f} ms" in line and "(no program span)" in line
    absent = _traced(_chrome(with_spans=False))
    assert mod.read(absent) is None
    assert "0 calls" in mod.describe(absent)
    none = trace.Traced(device=absent.device, spans=None, counts={},
                        count_units=0, missing={})
    assert mod.read(none) is None and mod.describe(none)


# on CUDA tensors phase 1's keys are one K9 launch in `phase1.keys`, in
# place of the plain version's `phase1.interval` and `phase1.boxcull`
CUDA_SPANS = ["restir.initial", "restir.temporal", "restir.shade",
              "phase1.keys", "phase1.sort"]


@pytest.mark.parametrize("metric,ms", [
    ("phase1_ms.keys", 0.040), ("phase1_ms.sort", 0.050),
    ("phase1_ms.interval", None), ("phase1_ms.boxcull", None)])
def test_the_keys_span_metric_reads_the_cuda_path(metric, ms):
    """`phase1_ms.keys` reads the kernels launched in `phase1.keys`; on a
    trace of the CUDA path the interval and box-cull spans are absent, so
    their metrics read nothing; a trace without the span (a program
    before K9) leaves `phase1_ms.keys` out too."""
    mod = harness.metric_module(metric)
    assert mod.SPANS == []
    traced = _traced(_chrome(names=CUDA_SPANS))
    got = mod.read(traced)
    if ms is None:
        assert got is None and "0 calls" in mod.describe(traced)
        return
    assert got == pytest.approx(ms)
    assert f"1 calls, 1 launches, kernels {ms:.3f} ms" in \
        mod.describe(traced)
    if metric == "phase1_ms.keys":
        assert mod.read(_traced(_chrome())) is None
        assert mod.read(_traced(_chrome(names=CUDA_SPANS,
                                        with_spans=False))) is None


def test_the_keys_kernel_count_is_seeded_and_a_cpu_pack_launches_nothing(
        monkeypatch):
    """`launch.shortlist_keys` reads 0 from the import of its module; a
    pack of CPU tensors takes the plain key build (its spans
    `phase1.interval` and `phase1.boxcull`, no `phase1.keys`), builds and
    launches nothing."""
    assert "launch.shortlist_keys" in tracing.COUNTS
    if not torch.cuda.is_available():
        assert tracing.COUNTS["launch.shortlist_keys"] == 0

    def refuse(*a, **k):
        raise AssertionError("a kernel library loaded for CPU tensors")

    monkeypatch.setattr(ct, "_lib", refuse)
    lo, hi, o, d, tn, tf = _boxes_and_rays()
    before = tracing.counted("launch.")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pk = ct.pack(lo, hi, o, d, tn, tf, 1)
    assert tracing.counted("launch.") == before
    names = {e.name for e in prof.events()}
    assert set(PHASE1) <= names and "phase1.keys" not in names
    key, count = ct.packet_keys(pk.o, pk.d, pk.tnear, pk.tfar, lo, hi)
    want_key, want_count = ct.shortlist_keys(pk.o, pk.d, pk.tnear, pk.tfar,
                                             lo, hi)
    assert torch.equal(key, want_key) and torch.equal(count, want_count)
    assert torch.equal(count, pk.count)


def test_idle_is_charged_to_the_innermost_program_span():
    tl = trace.parse_chrome_trace(_chrome(), 2)
    idle = program_spans.idle_us_by_span(tl)
    # a unit's gaps: 40 us inside restir.temporal, the rest inside frame
    # between spans, and the gap between the units outside any span
    assert idle["restir.temporal"] == pytest.approx(80.0)
    assert set(idle) <= set(tl.ranges) | {program_spans.NONE}
    # a range a metric opens (named in `outside`) owns no gap: the
    # enclosing program span takes it
    outer = program_spans.idle_us_by_span(tl, ("restir.temporal",))
    assert "restir.temporal" not in outer
    assert outer["frame"] == pytest.approx(idle["frame"] + 80.0)
    assert sum(outer.values()) == pytest.approx(sum(idle.values()))


def test_the_shortlist_counter_reads_its_calls():
    mod = harness.metric_module("shortlist_mean.frame")
    (spec,) = mod.COUNTS
    assert (spec.module, spec.attr) == ("tpu_restir_torch.tracing", "count")
    listed = torch.tensor([3, 4], dtype=torch.int32)
    assert spec.shape(("phase1.listed", listed), {}) == \
        ("phase1.listed", 7.0)
    assert spec.shape(("phase1.packets", 2), {}) == ("phase1.packets", 2.0)
    calls = [("phase1.listed", 300.0), ("phase1.packets", 8.0),
             ("phase1.pairs", 1000.0), ("launch.trace_any", 1.0),
             ("phase1.listed", 60.0), ("phase1.packets", 4.0),
             ("phase1.pairs", 500.0)]
    traced = _traced(_chrome(), {"count.shortlist": calls})
    assert mod.read(traced) == pytest.approx(30.0)
    assert "0.240000" in mod.describe(traced)
    assert mod.read(_traced(_chrome(), {})) is None
    assert mod.read(_traced(_chrome(), {"count.shortlist": calls[3:4]})) \
        is None


def test_the_shortlist_counter_through_the_benchmark_wrapper():
    """The metric's COUNTS spec wraps the program's `tracing.count` as a
    counted unit does, and reads the mean listed a packet of a query."""
    mod = harness.metric_module("shortlist_mean.frame")
    lo, hi, o, d, tn, tf = _boxes_and_rays()
    sp = trace.Spans(mod.COUNTS, ranges=False)
    sp.install()
    try:
        pk = ct.pack(lo, hi, o, d, tn, tf, 1)
    finally:
        sp.remove()
    assert not sp.missing and tracing.count.__name__ == "count"
    traced = _traced(_chrome(), sp.calls)
    assert mod.read(traced) == pytest.approx(float(pk.count.sum()) / 3)
