"""The port's measuring entry points on the CPU: `tpu_restir_torch.bench`
(the counterpart of the repository's `bench.py`), its terrain1M child
`tpu_restir_torch.tools.bench_terrain1m` and the whole-frame roofline
`tpu_restir_torch.tools.roofline_frame`, held to the JAX package's
scripts.

- The bench configuration equals bench.py's literals (its RenderConfig
  call, read from the file and evaluated with the JAX config classes),
  tools/roofline_frame.py's `_cfg()` and, with the terrain camera,
  tools/bench_terrain1m.py's literals and `_terrain_cam()`, field by
  field.
- `bench.rays_per_pixel` is `metrics.rays_per_pixel` and equals
  bench.py's over a grid of RestirParams.
- The bench's own functions at 32x16, one frame each, on small scenes,
  give a line with bench.py's keys and 28 traced rays a pixel; a child
  that fails is reported with its rc and last stderr line.
- terrain1M's path at a small size: factor 4 (SUPER_MAX lowered) renders
  the frames of factor 1 bit for bit.
- The roofline's model lines equal the JAX tool's calls of the same
  models (names and arguments: queries, rays, shortlist entries,
  triangles, pixels, channels); the operation and byte counts are those
  of the port's `roofline.py` on those arguments. The two packages'
  cost models differ (the port counts the plain test's operations at the
  card's ceilings), so their numbers are compared on one model.
"""

import ast
import dataclasses
import json
import os
import sys

import jax
import pytest
import torch

import bench as jbench
from tools import roofline_frame as jtool
from tpu_restir import config as jconfig
from tpu_restir import roofline as jroofline
from tpu_restir.kernels import cluster_trace as jct
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir.scene.cornell import many_lights_scene as j_many_lights
from tpu_restir_torch import bench, metrics, roofline
from tpu_restir_torch.config import RestirParams
from tpu_restir_torch.kernels import cluster_trace as tct
from tpu_restir_torch.scene.cornell import cornell_box, many_lights_scene
from tpu_restir_torch.scene.procedural import terrain_scene
from tpu_restir_torch.tools import bench_terrain1m, roofline_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _render_config_literal(path):
    """The RenderConfig(...) call of a JAX script, evaluated with the JAX
    config classes and the script's WIDTH and HEIGHT."""
    src = open(os.path.join(REPO, path)).read()
    calls = [n for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and getattr(n.func, "id", None)
             == "RenderConfig"]
    assert len(calls) == 1, path
    names = {k: getattr(jconfig, k) for k in dir(jconfig)
             if not k.startswith("_")}
    names.update(WIDTH=1920, HEIGHT=1080)
    return eval(compile(ast.Expression(calls[0]), path, "eval"), names)


def _same(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def test_bench_config_matches_bench_py_and_the_roofline_tool():
    cfg = bench.bench_cfg()
    _same(cfg, _render_config_literal("bench.py"))
    _same(cfg, jtool._cfg())
    _same(cfg.replace(profile_stop_after="spatial"), jtool._cfg("spatial"))
    assert (bench.WIDTH, bench.HEIGHT, bench.N_FRAMES) \
        == (jbench.WIDTH, jbench.HEIGHT, jbench.N_FRAMES)


def test_terrain_camera_matches_the_jax_scripts():
    cfg = bench.bench_cfg(view=bench.TERRAIN_VIEW)
    _same(cfg, _render_config_literal("tools/bench_terrain1m.py"))
    _same(cfg.camera, jtool._terrain_cam())
    assert bench.SCENES["terrain100k"][1] == bench.TERRAIN_VIEW
    assert bench.SCENES["lights1k"][1] == bench.CORNELL_VIEW


GRID = [(vis, mis, passes, temporal)
        for vis in (False, True)
        for mis in ("balance", "pairwise", "constant")
        for passes in (1, 2)
        for temporal in (False, True)]


@pytest.mark.parametrize("vis,mis,passes,temporal", GRID)
def test_rays_per_pixel_matches_bench_py(vis, mis, passes, temporal):
    assert bench.rays_per_pixel is metrics.rays_per_pixel
    cfg = bench.bench_cfg(32, 16).replace(restir=RestirParams(
        m_area=1, m_brdf=1, do_visibility_pass=vis, do_temporal_reuse=temporal,
        do_spatial_reuse=True, spatial_neighbor_count=5, spatial_mis=mis,
        spatial_pass_count=passes))
    assert bench.rays_per_pixel(cfg) == jbench.rays_per_pixel(cfg)


def _stub(code):
    return [sys.executable, "-c", code]


def _small_scenes():
    """bench.SCENES with the secondary scenes cut to a few hundred
    triangles (the plain K5/K6 on the CPU)."""
    scenes = dict(bench.SCENES)
    scenes["lights1k"] = (lambda d: many_lights_scene(d, 100),
                          bench.CORNELL_VIEW)
    scenes["terrain100k"] = (lambda d: terrain_scene(d, 600),
                             bench.TERRAIN_VIEW)
    return scenes


def test_bench_line_on_the_cpu(capsys):
    child = _stub("print('[terrain1M] {\"finite\": true, \"rays\": 14336}');"
                  "print('TERRAIN1M 1.5 rpp 28.0')")
    line, report = bench.run_bench("cpu", 32, 16, scenes=_small_scenes(),
                                   child=child, n_frames=1, n_steps=1,
                                   n_secondary=1)
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "restir_1080p_mrays_per_s_fwd_bwd"
    json.dumps(line)
    unit = line["unit"]
    assert unit.startswith("Mrays/s (fwd ")
    assert unit.endswith("; rpp 28.0 traced/28 analytic)")
    for label in ("lights1k", "terrain100k", "terrain1M"):
        assert f"{label} " in unit and f"{label} failed" not in unit
    assert "terrain1M 1.5 (rpp 28.0)" in unit
    assert "failed:" not in unit
    # both rounded from the step's unrounded rate (rounding the rounded
    # value again would differ for a quarter of the rates)
    mrays = report["rays"]["cornell"] / (report["step_ms"] / 1e3) / 1e6
    assert line["value"] == round(mrays, 2)
    assert line["vs_baseline"] == round(mrays / 2.0, 2)
    assert report["rays"] == {k: 28 * 32 * 16 for k in
                              ("cornell", "lights1k", "terrain100k")}
    assert all(report["finite"].values()) and report["step_finite"]
    assert report["terrain1M"] == {"finite": True, "rays": 14336}
    out = capsys.readouterr().out
    assert "peak memory not measured" in out   # no card: no device figure


@pytest.mark.parametrize("code,timeout,entry,err", [
    ("import sys; print('partial'); print('first', file=sys.stderr);"
     "print('Traceback: the last line', file=sys.stderr); sys.exit(1)", 60,
     "terrain1M failed:rc1", "its last stderr line: Traceback: the last line"),
    ("print('no result line')", 60, "terrain1M failed:rc0",
     "exited with rc 0"),
    ("import time; time.sleep(30)", 0.5, "terrain1M failed:TimeoutExpired",
     "TimeoutExpired"),
])
def test_child_failure_is_reported(capsys, code, timeout, entry, err):
    got, info = bench.run_child(_stub(code), timeout=timeout)
    assert got == entry and info is None
    assert err in capsys.readouterr().err


def test_child_argv_runs_the_terrain1m_module():
    argv = bench.child_argv("cuda")
    assert argv[1:] == ["-m", "tpu_restir_torch.tools.bench_terrain1m",
                        "--device", "cuda"]
    assert bench_terrain1m.N_TRIS == 1_000_000
    assert bench.SCENES["terrain1M"][1] == bench.TERRAIN_VIEW


def test_terrain1m_path_at_factor_4_equals_factor_1(monkeypatch):
    """bench_terrain1m.run on a small terrain (C = 79 > SMALL_C, so the
    queries cull): factor 4 forced by lowering SUPER_MAX, as
    tests/test_torch_ptrace.py does, renders factor 1's frames exactly."""
    scene, seconds = bench_terrain1m.build_timed("cpu", 5000)
    assert seconds["total"] >= seconds["host BVH2 (accel.cpp)"] > 0.0
    cfg = bench.bench_cfg(16, 16, bench.TERRAIN_VIEW)
    flat = bench_terrain1m.run(scene, cfg, "cpu", 1)
    assert bench_terrain1m.scene_info(scene)["factor"] == 1
    monkeypatch.setattr(tct, "SUPER_MAX", 20)
    info = bench_terrain1m.scene_info(scene)
    assert (info["clusters"], info["factor"], info["S"]) == (79, 4, 20)
    assert info["cull_modes"] == {"closest": 5, "any": 5}
    assert info["per_cluster_boxes"]
    sup = bench_terrain1m.run(scene, cfg, "cpu", 1)
    assert flat["rays"] == sup["rays"] == 28 * 16 * 16
    assert flat["rpp"] == 28.0
    assert torch.equal(flat["frame"], sup["frame"])
    assert torch.isfinite(sup["frame"]).all()


class _Recorder:
    """A roofline module whose *_spec calls are recorded."""

    def __init__(self, mod):
        self.mod, self.calls, self.specs = mod, [], []

    def __getattr__(self, name):
        attr = getattr(self.mod, name)
        if not name.endswith("_spec"):
            return attr

        def record(*args):
            self.calls.append((name,) + args)
            self.specs.append(attr(*args))
            return self.specs[-1]
        return record


def _small_tools(monkeypatch, w, h):
    for mod in (jtool, roofline_frame):
        monkeypatch.setattr(mod, "W", w)
        monkeypatch.setattr(mod, "H", h)
        monkeypatch.setattr(mod, "N_PIX", w * h)
    monkeypatch.setattr(jtool, "measure_prefix", lambda *a: 0.01)
    monkeypatch.setattr(roofline_frame, "measure_prefix", lambda *a: 0.01)
    # the JAX tool is written for the chip, where `auto` picks the fused
    # kernel for small scenes; on the CPU it would pick an XLA fallback
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jct, "INTERPRET", True)
    jrec, trec = _Recorder(jroofline), _Recorder(roofline)
    monkeypatch.setattr(jtool, "roofline", jrec)
    monkeypatch.setattr(roofline_frame, "roofline", trec)
    return jrec, trec


def _same_models(jrec, trec):
    assert [c[:2] for c in trec.calls] == [c[:2] for c in jrec.calls]
    assert trec.calls == jrec.calls
    for (name, *args), got in zip(jrec.calls, trec.specs):
        want = getattr(roofline, name)(*args)
        assert (got.name, got.flops, got.bytes_hbm) \
            == (want.name, want.flops, want.bytes_hbm)


def test_roofline_models_match_the_jax_tool_on_cornell(monkeypatch):
    """Cornell at 64x32 (the fused branch): the JAX tool's census is its
    own trace of restir_step (jax.eval_shape), the port's a frame's query
    log."""
    jrec, trec = _small_tools(monkeypatch, 64, 32)
    jblock = jtool.scene_report("cornell", j_cornell_box(),
                                jtool._cfg().camera)
    tblock = roofline_frame.scene_report(
        "cornell", cornell_box("cpu"), bench.bench_cfg(64, 32).camera, "cpu")
    assert [c[0] for c in trec.calls] == [
        "fused_query_spec", "fused_query_spec", "phat_spec", "gather_spec",
        "shading_spec", "shading_spec"]
    _same_models(jrec, trec)
    assert jblock.splitlines()[0] == tblock.splitlines()[0] == \
        "## cornell (36 tris, backend fused, payload 24 ch)"


def test_roofline_models_match_the_jax_tool_on_a_clustered_scene(
        monkeypatch):
    """many_lights_scene(500) (534 triangles, the clustered branch) at
    32x8: the shortlist census of the primary rays and of the seeded
    shadow segments. The JAX tool is given the port's query census (its
    own trace is held on Cornell above), so this case compares the
    shortlists, the supercluster boxes, the scene-box clamp and the light
    picks."""
    jrec, trec = _small_tools(monkeypatch, 32, 8)
    scene = many_lights_scene("cpu", 500)
    cam_cfg = bench.bench_cfg(32, 8).camera
    log = []
    census = roofline_frame.census

    def logged(*args):
        q, c = census(*args)
        log.extend(q)
        return q, c

    monkeypatch.setattr(roofline_frame, "census", logged)
    roofline_frame.scene_report("lights", scene, cam_cfg, "cpu")

    class _Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        def eval_shape(self, *args):
            jtool.intersect_mod.QUERY_LOG.extend(log)

    monkeypatch.setattr(jtool, "jax", _Jax())
    jtool.scene_report("lights", j_many_lights(500), jtool._cfg().camera)
    assert [c[0] for c in trec.calls[:2]] == ["ptrace_query_spec"] * 2
    assert trec.calls[0][3] > 0 and trec.calls[1][3] > 0
    _same_models(jrec, trec)


def test_roofline_tool_refuses_the_jax_record():
    with pytest.raises(ValueError, match="JAX package's record"):
        roofline_frame.main([os.path.join(REPO, "docs", "ROOFLINE.md"),
                             "--device", "cpu"])
