"""CPU tests of the benchmark's harness: every file is found by its name,
a cell added as files and an entry runs with no other edit, no forbidden
module is loaded, the window's arithmetic, the roofline arithmetic and
the trace reader. Run with `python -m pytest --noconftest -q
perfbench/tests` (the root conftest imports JAX)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, roofline, run, trace, window

ROOT = Path(__file__).resolve().parents[2]
SMALL = (64, 32)


def test_every_named_file_is_found():
    spec = harness.load_spec()
    assert spec["paths"] == ["perfbench"]
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
    for w in spec["workloads"]:
        cell = harness.find_cell(spec, w["name"])
        assert cell.limits, w["name"]
        assert callable(harness.kind_module(cell.traffic["kind"]).run)
        assert cell.end_to_end and cell.per_layer
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        harness.scene_arrays(cell.config)
    for m in spec["per_layer"]:
        mod = harness.metric_module(m["name"])
        assert callable(mod.read)
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_metric_workloads_report_their_moves():
    spec = harness.load_spec()
    for m in spec["per_layer"]:
        for w in m["workloads"]:
            cell = harness.find_cell(spec, w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}, \
                (m["name"], w)


_NEW_CELL = """
import json, sys, torch
from perfbench import harness, run
cell = harness.find_cell(harness.load_spec(), "cornell.nee-mis")
res = run.run_cell(cell, 77, 0.2, False, torch.device("cpu"), size=(32, 16))
print(json.dumps(res))
"""

# a traffic kind of its own: the progressive render under another name
_NEW_KIND = """from perfbench.kinds.progressive import run  # noqa: F401
"""


@pytest.mark.parametrize("new_kind", [False, True])
def test_a_new_cell_needs_only_new_files_and_an_entry(tmp_path, new_kind):
    """A copy of the benchmark, with one entry added to BENCHMARK.json
    and one limits file, runs the new cell (the Cornell box under the
    NEE-MIS traffic) with every other file unchanged; with new_kind, its
    traffic is a new file that names a new kind, `kinds/<kind>.py`."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.load_spec()
    traffic = "nee-mis"
    if new_kind:
        traffic = "nee-mis-again"
        mix = dict(harness.data_file("traffic", "nee-mis"),
                   kind="progressive_again")
        (tmp_path / "perfbench" / "traffic" / f"{traffic}.json").write_text(
            json.dumps(mix))
        (tmp_path / "perfbench" / "kinds" / "progressive_again.py"
         ).write_text(_NEW_KIND)
    spec["workloads"].append({"name": "cornell.nee-mis", "config": "cornell",
                              "traffic": traffic, "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "terrain100k.nee-mis" in m["workloads"]:
            m["workloads"].append("cornell.nee-mis")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "perfbench" / "limits" / "cornell.nee-mis.json").write_text(
        json.dumps({"pixels_off": 0.01}))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", _NEW_CELL], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"frame_ms", "peak_gib", "setup_s"}


_MODULES = """
import json, sys, torch
from perfbench import harness, run
cell = harness.find_cell(harness.load_spec(), "cornell.restir")
run.run_cell(cell, 5, 0.2, False, torch.device("cpu"), size=(32, 16))
print(json.dumps(sorted(sys.modules)))
"""

_REFERENCE_MODULES = """
import json, sys, torch
from perfbench import check, harness
cell = harness.find_cell(harness.load_spec(), "cornell.restir")
check.ref_restir_frames(cell, harness.run_seeds(5), 2, torch.device("cpu"),
                        (32, 16))
with check.control():
    check.ref_restir_frames(cell, harness.run_seeds(5), 1,
                            torch.device("cpu"), (32, 16))
print(json.dumps(sorted(sys.modules)))
"""


def _modules(script):
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_nor_the_jax_package():
    mods = _modules(_MODULES)
    assert harness.forbidden_modules(mods) == []
    assert "tpu_restir_torch" in mods      # the program is what ran


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(_REFERENCE_MODULES)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "tpu_restir",
                       "tpu_restir_torch"}
    assert "perfbench" in tops


def test_forbidden_names_are_compared_whole():
    mods = ["tpu_restir_torch", "tpu_restir_torch.render", "jaxtyping",
            "flaxen", "numpy"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["tpu_restir.config", "jax",
                                             "flax.linen"]) == [
        "flax.linen", "jax", "tpu_restir.config"]


class _Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _window(completions):
    events = [_Ev(0.0)] + [_Ev(t) for t in completions]
    gaps = window.interval_ms(events)
    return completions[-1] * 1e3 / len(completions), \
        float(np.quantile(gaps, 0.9))


def test_a_stall_raises_the_p90_and_moves_the_mean_by_its_share():
    steady = [0.1 * (i + 1) for i in range(100)]
    mean0, p90_0 = _window(steady)
    assert mean0 == pytest.approx(100.0) and p90_0 == pytest.approx(100.0)
    # 13 frames each held up by 150 ms
    stalled, t = [], 0.0
    for i in range(100):
        t += 0.1 + (0.15 if i % 8 == 0 else 0.0)
        stalled.append(t)
    mean1, p90_1 = _window(stalled)
    assert mean1 == pytest.approx(100.0 + 13 * 150.0 / 100)
    assert p90_1 == pytest.approx(250.0)


@pytest.mark.parametrize("kind,rays,tris", [
    ("closest", 1000, 36), ("closest", 2_073_600, 36), ("any", 4096, 2),
    ("any", 2_073_600, 36), ("closest", 777, 1)])
def test_roofline_arithmetic_equals_the_ports(kind, rays, tris):
    from tpu_restir_torch import roofline as port
    assert roofline.HBM_BYTES_PER_S == port.HBM_BYTES_PER_S
    assert roofline.FP32_OPS_PER_S == port.FP32_OPS_PER_S
    assert roofline.WOOP_OPS == port.WOOP_OPS
    assert roofline.MT_OPS == port.MT_OPS
    assert roofline.SLAB_OPS == port.SLAB_OPS
    ops, nbytes = roofline.fused_query(kind, rays, tris)
    spec = port.fused_query_spec("q", rays, tris)
    assert ops == spec.flops
    if kind == "closest":
        assert nbytes == spec.bytes_hbm
        t, rule = roofline.bound_s(ops, nbytes)
        assert t == pytest.approx(spec.sol_time_s(), rel=1e-12)
        assert rule == spec.bound
    else:   # one byte of output a ray, not a hit record
        assert nbytes == spec.bytes_hbm - rays * (port.HIT_BYTES - 1)


def _chrome():
    """A synthetic trace: two units; kernels K1 (closest_kernel) inside a
    ray_tri range, an elementwise kernel inside a pass range, a copy; host
    calls around the gaps."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": args})

    for u, base in enumerate((0.0, 1000.0)):
        x("user_annotation", "raytri.closest", base + 10, 50)
        x("cuda_runtime", "cudaLaunchKernel", base + 20, 5,
          correlation=10 * u + 1)
        x("kernel", "void closest_kernel<1>(float const*)", base + 100, 100,
          correlation=10 * u + 1)
        x("user_annotation", "pass.spatial", base + 60, 100)
        x("cuda_runtime", "cudaLaunchKernel", base + 70, 5,
          correlation=10 * u + 2)
        x("kernel", "elementwise_kernel", base + 200, 300,
          correlation=10 * u + 2)
        x("cpu_op", "aten::nonzero", base + 500, 200)
        x("gpu_memcpy", "Memcpy DtoH", base + 600, 50)
    return {"traceEvents": ev}


def _traced(units=2, counts=None, missing=None):
    tl = trace.parse_chrome_trace(_chrome(), units)
    return trace.Traced(device=tl, spans=tl, counts=counts or {},
                        count_units=1 if counts else 0,
                        missing=missing or {}, period_ms=1.0)


def test_the_trace_reader():
    tr = trace.parse_chrome_trace(_chrome(), units=2)
    assert len(tr.kernels) == 4
    assert tr.range_device_ms("raytri.closest") == pytest.approx(0.1)
    assert tr.range_device_ms("pass.spatial") == pytest.approx(0.3)
    assert tr.range_device_ms("absent") is None
    # busy 400 + 50 a unit; window 100 .. 1650
    assert tr.busy_us() == pytest.approx(900.0)
    assert tr.window_us() == pytest.approx(1550.0)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::nonzero"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(650e-6)
    top = tr.top_device_ops()
    assert top[0] == ["elementwise_kernel", pytest.approx(600e-6)]
    traced = _traced()
    assert harness.metric_module("launches.frame").read(traced) == 2.0
    # 450 us busy a unit against 1 ms a unit in the untraced units
    for name in ("device_idle.frame", "device_idle.step"):
        assert harness.metric_module(name).read(traced) == \
            pytest.approx(55.0)
    assert harness.metric_module("pass_ms.spatial").read(traced) == \
        pytest.approx(0.3)


def test_the_profiled_units_are_recorded_and_drained():
    """The units under the profiler are recorded, and the device is
    drained after them, before the profiler stops."""
    from torch.profiler import ProfilerActivity
    calls, syncs = [], []

    def unit():
        with torch.profiler.record_function(f"unit{len(calls)}"):
            calls.append(torch.ones(64).sum())

    tl = trace._profile(unit, 2, [ProfilerActivity.CPU],
                        lambda: syncs.append(len(calls)))
    assert len(calls) == 2 and syncs == [2]
    assert tl.units == 2
    assert sorted(n for n in tl.ranges if n.startswith("unit")) == [
        "unit0", "unit1"]


def test_traced_units_run_inside_the_window():
    """A traced run's profiled units are window units run once two units
    and a quarter of the window have passed: each gets its timing event
    and is seen by keep, and the window goes on until its time is up.
    The untraced unit times are those before the traced units."""
    seen = []

    def traced(one):
        one()
        one()
        return "traced"

    win = window.run_window(lambda i: i, 0.05, torch.device("cpu"),
                            keep=lambda i, out: seen.append(out),
                            trace=traced)
    first, end = win.traced_units
    assert win.traced == "traced" and first >= 2 and end == first + 2
    assert seen == list(range(win.units))
    assert len(win.events) == win.units + 1 and win.seconds >= 0.05
    assert win.untraced_unit_ms() == win.unit_ms()[:first]
    # a window shorter than its first units still traces once
    win = window.run_window(lambda i: i, 0.0, torch.device("cpu"),
                            trace=traced)
    assert win.traced_units == (2, 4) and win.units == 4


def test_the_roofline_reader_on_a_trace():
    ops = 1000 * 36 * 13.0
    traced = _traced(counts={"raytri.closest": [("closest", 1000, 36, ops)]})
    m = harness.metric_module("raytri_roofline.frame")
    nbytes = roofline.fused_query("closest", 1000, 36)[1]
    bound = roofline.bound_s(ops, nbytes)[0]
    # two K1 kernels of 100 us over two units: 100 us a frame
    assert m.read(traced) == pytest.approx(100 * bound / 100e-6)
    assert "ruled by" in m.describe(traced)


def test_the_needed_count_of_a_query():
    """Rays down onto a unit triangle at z = 0: a hit costs 40, a miss
    beside it in u 26, a segment that ends above the plane 13; an
    occlusion ray stops at its first hit."""
    m = harness.metric_module("raytri_roofline.frame")
    tri = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]],
                        [[0.0, 0, -1], [1, 0, -1], [0, 1, -1]]])

    class Scene:
        tri_v = tri
        num_tris = 2

    o = torch.tensor([[0.2, 0.2, 1.0], [5.0, 0.2, 1.0], [0.2, 0.2, 1.0]])
    d = torch.tensor([[0.0, 0, -1]] * 3)
    tn = torch.zeros(3)
    tf = torch.tensor([10.0, 10.0, 0.5])
    # ray 0 hits both (40 + 40), ray 1 misses both in u (26 + 26),
    # ray 2 ends above both planes (13 + 13)
    assert m._needed_ops("closest", Scene, o, d, tn, tf) == 158.0
    # the occlusion ray 0 stops at its first hit: 40
    assert m._needed_ops("any", Scene, o, d, tn, tf) == 118.0


def test_a_reader_with_nothing_to_read_is_left_out():
    tl = trace.parse_chrome_trace({"traceEvents": []}, units=1)
    traced = trace.Traced(device=tl, spans=tl, counts={}, count_units=0,
                          missing={"pass.spatial": "gone"})
    cell = harness.find_cell(harness.load_spec(), "cornell.restir")
    lines = []
    out = run.read_per_layer(cell, traced, lines.append)
    assert out == {}
    assert any("pass_ms.spatial" in ln and "gone" in ln for ln in lines)


def test_the_spans_wrap_and_unwrap():
    from tpu_restir_torch.kernels import cluster_trace
    orig = cluster_trace.pack
    spans = trace.Spans([trace.SpanSpec(
        "tpu_restir_torch.kernels.cluster_trace", "pack", "p1"),
        trace.SpanSpec("tpu_restir_torch.kernels.cluster_trace", "nope",
                       "gone")])
    spans.install()
    assert cluster_trace.pack is not orig
    assert "gone" in spans.missing
    spans.remove()
    assert cluster_trace.pack is orig


def test_seeds_beyond_32_bits_and_negative():
    a = harness.run_seeds(2 ** 31 + 12345)
    b = harness.run_seeds(2 ** 31 + 12346)
    c = harness.run_seeds(-(2 ** 40))
    assert a == harness.run_seeds(2 ** 31 + 12345)
    assert a.render != b.render and 0 <= c.render < 2 ** 31


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell.restir", "cornell.fwdbwd"])
def test_a_small_run_on_the_card_is_correct(cuda, name):
    cell = harness.find_cell(harness.load_spec(), name)
    res = run.run_cell(cell, 11, 0.5, True, cuda, size=SMALL)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["busy_s"] > 0
