"""CPU tests of what decides `correct`: the frozen scene inputs equal the
port's scenes, the plain reference equals the port on the CPU at 64x32
for each traffic kind, and a run with the timed path broken underneath,
or the control in the program's place, comes out not correct."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench import check, control, harness, run, window
from perfbench.kinds import fwdbwd
from perfbench.scenes import cornell_box as frozen_cornell
from perfbench.scenes import terrain

CPU = torch.device("cpu")
SMALL = (64, 32)


def _cell(name, **scene_args):
    cell = harness.find_cell(harness.load_spec(), name)
    if scene_args:
        cfg = dict(cell.config, scene_args=dict(cell.config["scene_args"],
                                                **scene_args))
        cell = dataclasses.replace(cell, config=cfg)
    return cell


def _same_scene(a, b):
    for f in ("tri_v", "tri_v0", "tri_e1", "tri_e2", "tri_area",
              "vtx_normal", "vtx_uv", "vtx_tangent", "tri_mat", "woop",
              "cluster_min", "cluster_max", "cluster_tris"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in ("diffuse", "specular", "emission", "shininess"):
        assert torch.equal(getattr(a.materials, f), getattr(b.materials, f))
    assert torch.equal(a.lights.tri_idx, b.lights.tri_idx)
    assert torch.equal(a.lights.cdf, b.lights.cdf)


def _port_scene(arrays):
    from tpu_restir_torch.scene.materials import MaterialSpec
    from tpu_restir_torch.scene.scene import build_scene
    v, m, specs = arrays
    return build_scene(v, m, [MaterialSpec(**d) for d in specs], "cpu")


def test_frozen_cornell_box_is_the_ports():
    from tpu_restir_torch.scene.cornell import cornell_box
    _same_scene(_port_scene(frozen_cornell.arrays()), cornell_box("cpu"))


def test_frozen_terrain100k_is_the_ports():
    from tpu_restir_torch.scene.procedural import terrain_scene
    v, m, specs = terrain.arrays(100_000)
    assert v.shape == (100_354, 3, 3)
    port = terrain_scene("cpu", 100_000)
    _same_scene(_port_scene((v, m, specs)), port)
    # the emitters keep their order in the port's leaf order, so both
    # sides pick the same panel triangle from the same draw
    assert torch.equal(port.tri_v[port.lights.tri_idx.long()],
                       torch.tensor(v[-2:]))


def test_the_reference_scene_keeps_the_inputs():
    from perfbench.refrender.scene.materials import MaterialSpec
    from perfbench.refrender.scene.scene import build_ref_scene
    v, m, specs = terrain.arrays(5_000)
    ref = build_ref_scene(v, m, [MaterialSpec(**d) for d in specs], "cpu")
    assert torch.equal(ref.tri_v, torch.tensor(v))
    ids = ref.clusters.ids.reshape(-1)
    assert torch.equal(torch.sort(ids[ids >= 0]).values,
                       torch.arange(len(v), dtype=torch.int32))


def _port_frames(cell, seeds, n):
    from tpu_restir_torch.renderer import Renderer
    prog = window.Program(cell, seeds, CPU, SMALL)
    r = Renderer(prog.scene, prog.cfg, CPU)
    return [r.step().clone() for _ in range(n)]


@pytest.mark.parametrize("name,scene_args", [
    ("cornell.restir", {}), ("terrain100k.restir", {"n_tris": 3_000})])
def test_reference_equals_the_port_on_chained_restir_frames(name,
                                                            scene_args):
    cell = _cell(name, **scene_args)
    seeds = harness.run_seeds(2024)
    port = _port_frames(cell, seeds, 3)
    ref = check.ref_restir_frames(cell, seeds, 3, CPU, SMALL)
    for p, q in zip(port, ref):
        assert check.pixels_off(p, q) <= 2.0 / (SMALL[0] * SMALL[1])


@pytest.mark.parametrize("scene_args", [{"n_tris": 3_000}])
def test_reference_equals_the_port_on_a_nee_mis_frame(scene_args):
    cell = _cell("terrain100k.nee-mis", **scene_args)
    seeds = harness.run_seeds(99)
    port = _port_frames(cell, seeds, 2)
    ref = check.ref_path_frame(cell, seeds, 1, CPU, SMALL)
    assert check.pixels_off(port[1], ref) <= 2.0 / (SMALL[0] * SMALL[1])


def test_reference_equals_the_port_on_gradient_steps():
    cell = _cell("cornell.fwdbwd")
    seeds = harness.run_seeds(31337)
    out = fwdbwd.run(cell, seeds, 0.01, CPU, SMALL, None,
                     time.perf_counter())
    nums = out.numbers()
    assert nums["loss_gap"] < 1e-6
    assert nums["grad_gap"] < 1e-5
    assert nums["change_gap"] < 1e-5


# --- the control and the faults: `correct` comes out false ------------------

def _correct(name, seed=4242, **scene_args):
    cell = _cell(name, **scene_args)
    res = run.run_cell(cell, seed, 0.05, False, CPU, size=SMALL,
                       log=lambda s: None)
    return res["correct"], res["checks"]


@pytest.mark.parametrize("name,scene_args", [
    ("cornell.restir", {}), ("cornell.fwdbwd", {}),
    ("terrain100k.nee-mis", {"n_tris": 3_000})])
def test_the_control_fails_a_limit(name, scene_args):
    cell = _cell(name, **scene_args)
    nums = control.control_numbers(cell, 8, CPU, SMALL)["control"]
    assert any(nums[k] > lim for k, lim in cell.limits.items()), nums


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_a_fault_planted_in_the_reference_fails_a_limit(fault):
    cell = _cell("cornell.fwdbwd")
    nums = control.control_numbers(cell, 9, CPU, SMALL, faults=[fault])
    assert any(nums[fault][k] > lim for k, lim in cell.limits.items()), nums


@pytest.fixture
def patch(monkeypatch):
    return monkeypatch.setattr


def _frame_fault(patch, fault):
    """Wraps the port's frame producers so that each frame is passed
    through fault(frame)."""
    from tpu_restir_torch import renderer
    step, render = renderer.restir_step, renderer._render_frame

    def restir_step(*a, **k):
        frame, state = step(*a, **k)
        return fault(frame), state

    patch(renderer, "restir_step", restir_step)
    patch(renderer, "_render_frame", lambda *a, **k: fault(render(*a, **k)))


def _half(frame):
    out = frame.clone()
    out[frame.shape[0] // 2:] = 0.0
    return out


@pytest.mark.parametrize("name,scene_args", [
    ("cornell.restir", {}), ("terrain100k.nee-mis", {"n_tris": 3_000})])
@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_frame_is_not_correct(patch, name, scene_args, fault):
    assert _correct(name, **scene_args)[0] is True
    _frame_fault(patch, {"altered": lambda f: f * 1.01,
                         "half": _half}[fault])
    assert _correct(name, **scene_args)[0] is False


def test_a_frame_that_keeps_its_state_is_not_correct(patch):
    from tpu_restir_torch import renderer
    step = renderer.restir_step

    def restir_step(scene, cam, cfg, fseed, state, *a, **k):
        frame, _new = step(scene, cam, cfg, fseed, state, *a, **k)
        return frame, state

    patch(renderer, "restir_step", restir_step)
    ok, checks = _correct("cornell.restir")
    assert ok is False, checks


def test_a_step_that_keeps_its_state_is_not_correct(patch):
    patch(torch.optim.Adam, "step", lambda self, closure=None: None)
    ok, checks = _correct("cornell.fwdbwd")
    assert ok is False and checks["change_gap"]["value"] > 0.5


def test_a_loss_over_half_the_pixels_is_not_correct(patch):
    from tpu_restir_torch.diff import render as drender

    def loss_fn(params, scene, cam, cfg, seeds, target):
        img = drender.render_with_params(params, scene, cam, cfg, seeds)
        h = img.shape[0] // 2
        return torch.mean((img[:h] - target[:h]) ** 2)

    patch(drender, "loss_fn", loss_fn)
    assert _correct("cornell.fwdbwd")[0] is False


def test_an_altered_loss_is_not_correct(patch):
    from tpu_restir_torch.diff import render as drender
    loss = drender.loss_fn
    patch(drender, "loss_fn", lambda *a: loss(*a) * 1.01)
    assert _correct("cornell.fwdbwd")[0] is False


def test_pixels_off_counts_pixels_not_channels():
    a = torch.zeros((4, 4, 3))
    b = a.clone()
    b[0, 0, 1] = 1.0
    b[1, 1] = float("nan")
    assert check.pixels_off(b, a) == pytest.approx(2 / 16)
    assert check.pixels_off(a + 5e-4, a) == 0.0
    assert check.norm_gap({"x": np.ones(3)}, {"x": np.ones(3)}) == 0.0
