"""The port's renderer, pipeline options and ray accounting, on the CPU.

Display transfer against the JAX package's display_image at rtol 1e-6 /
atol 1e-6 (float32 pow); the traced ray count per pixel must equal the
bench's analytic count exactly. The denoised display against the JAX
Renderer's, fed the same accumulator, moment, history and G-buffer, with
the JAX side run op by op (jax.disable_jit(); tests/test_torch_denoise.py
gives the reason): rtol 1e-5, atol 1e-6. Frames with the per-pass timers
on (profile_passes) equal the plain ones exactly (the same operations on
the same inputs). The sidecar equals the JAX exporter's text but for the
render time (a wall clock); checkpoints of either package resume in the
other with equal arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir.config import (CameraConfig, RenderConfig, RenderParams,
                               RestirParams)
from tpu_restir.renderer import display_image as j_display_image
from tpu_restir_torch import convert, metrics, rng, tracing
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.render import intersect
from tpu_restir_torch.render.integrators.restir import pipeline as tpipe
from tpu_restir_torch.renderer import Renderer, display_image
from tpu_restir_torch.scene.cornell import cornell_box

CCFG = CameraConfig(width=16, height=12, fov_y_deg=45.0,
                    view_from=(0.0, -3.9, 1.0), view_at=(0.0, 0.0, 1.0),
                    pixel_sampler="random")
BENCH = RestirParams(m_area=1, m_brdf=1, do_temporal_reuse=True,
                     do_spatial_reuse=True, spatial_neighbor_count=5,
                     spatial_mis="pairwise")


def _cfg(restir=BENCH, **kw):
    return RenderConfig(camera=CCFG, params=RenderParams(use_skybox=False),
                        restir=restir, integrator="restir", **kw)


@pytest.fixture(scope="module")
def scene():
    return cornell_box("cpu")


def test_renderer_run_display_export(scene, tmp_path):
    r = Renderer(scene, _cfg(), device="cpu")
    acc = r.run(3)
    assert acc.shape == (12, 16, 3) and torch.isfinite(acc).all()
    mean, var = r.stats()
    assert 0.1 < mean < 1.0 and var > 0.0
    img = r.display()
    assert img.shape == (12, 16, 3) and img.min() >= 0 and img.max() <= 1
    path = str(tmp_path / "frame.png")
    r.export(path)
    sidecar = open(path + ".txt").read()
    assert "Iteration count: 3" in sidecar
    assert "Spatial reuse: True" in sidecar


def test_display_matches_jax():
    x = np.random.default_rng(0).uniform(0.0, 30.0, (12, 16, 3)) \
        .astype(np.float32)
    for params in (RenderParams(), RenderParams(tonemap=False),
                   RenderParams(gamma_correct=False)):
        np.testing.assert_allclose(
            display_image(torch.from_numpy(x), params).numpy(),
            np.asarray(j_display_image(jnp.asarray(x), params)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(n_devices=2)])
def test_renderer_refuses_what_is_not_ported(scene, kw):
    """n_devices = 2, once refused, is ported: it needs a process group of
    two ranks (tests/test_torch_dist_renderer.py), which this process
    lacks, and says so."""
    cfg = _cfg().replace(**kw)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        Renderer(scene, cfg, device="cpu")


@pytest.mark.parametrize("kw", [dict(profile_passes=True),
                                dict(params=RenderParams(use_skybox=False,
                                                         denoise=True))])
def test_renderer_profiles_and_denoises(scene, kw):
    """profile_passes and denoise, once refused, render: per-pass timers
    for every stage, or a finite denoised display that differs from the
    raw one with about its brightness."""
    r = Renderer(scene, _cfg().replace(**kw), device="cpu")
    r.run(3)
    assert torch.isfinite(r.accumulator).all() and r.acc_ctr == 3
    if r.cfg.profile_passes:
        assert set(r.timers.mean_ms()) == {"gbuffer", "initial", "temporal",
                                          "spatial", "shade"}
    else:
        den = r.display()
        raw = display_image(r.accumulator, r.cfg.params).numpy()
        assert np.isfinite(den).all() and not np.allclose(den, raw)
        assert abs(den.mean() - raw.mean()) < 0.25 * raw.mean()
        assert r._svgf_hist is not None
        assert float(r._svgf_hist.length.max()) == 3.0


def test_profile_passes_matches_fused_step(scene):
    """The step timed by its pass spans gives the plain step's frames
    (JAX tests/test_features.py:77), exactly: the frame runs once, and
    the spans only read the clock (an event pair on a CUDA device)."""
    cfg = _cfg()
    fused = Renderer(scene, cfg, device="cpu")
    fused.run(3)
    timed = Renderer(scene, cfg.replace(profile_passes=True), device="cpu")
    timed.run(3)
    assert torch.equal(timed.accumulator, fused.accumulator)
    assert torch.equal(timed.moment2, fused.moment2)
    ms = timed.timers.mean_ms()
    assert all(ms[k] >= 0.0 for k in ("gbuffer", "initial", "temporal",
                                      "spatial", "shade"))
    assert timed.timers.counts["shade"] == 3 and sum(ms.values()) > 0.0
    assert not fused.timers.mean_ms()


def _fed_renderers(method, acc_ctr, with_history):
    """A JAX Renderer and a port Renderer holding the same accumulator,
    luminance moment, last G-buffer and (optionally) SVGF history, all
    made from numpy with a seed; the G-buffer is a port frame's."""
    from tpu_restir.renderer import Renderer as JRenderer
    from tpu_restir.render.integrators.restir.gbuffer import GBuffer as JGB
    from tpu_restir.denoise import SvgfHistory as JHist
    from tpu_restir.scene import cornell_box as j_cornell_box
    from tpu_restir_torch.denoise import SvgfHistory

    params = RenderParams(use_skybox=False, denoise=True, denoiser=method)
    cfg = _cfg().replace(params=params)
    t = Renderer(cornell_box("cpu"), cfg, device="cpu")
    t.run(1)
    gbn = convert.to_numpy(t._restir_state.gb_prev)
    g = np.random.default_rng(11)
    acc = g.gamma(1.5, 0.3, (12, 16, 3)).astype(np.float32)
    m2 = (acc.mean(-1) ** 2 * g.uniform(1.0, 3.0, (12, 16))).astype(
        np.float32)
    j = JRenderer(j_cornell_box(), cfg)
    j._restir_state = j._restir_state.replace(
        gb_prev=JGB(**{k: jnp.asarray(v) for k, v in gbn.items()}))
    for r, arr in ((j, jnp.asarray), (t, torch.from_numpy)):
        r.accumulator = arr(acc)
        r.moment2 = arr(m2)
        r.acc_ctr = acc_ctr
        r._svgf_hist = None
    if with_history:
        length = g.integers(0, 6, (12, 16)).astype(np.float32)
        color = g.gamma(1.5, 0.3, (12, 16, 3)).astype(np.float32)
        m1 = color.mean(-1).astype(np.float32)
        hist = dict(color=color, m1=m1, m2=(m1 * m1 * 1.5).astype(np.float32),
                    length=length, depth=gbn["depth"], normal=gbn["normal"],
                    view_mat=gbn["view_mat"], focal=gbn["focal"])
        j._svgf_hist = JHist(**{k: jnp.asarray(v) for k, v in hist.items()})
        t._svgf_hist = SvgfHistory(**{k: torch.from_numpy(np.array(v))
                                      for k, v in hist.items()})
    return j, t


@pytest.mark.parametrize("method,acc_ctr,with_history", [
    ("svgf", 5, False), ("svgf", 1, True), ("svgf", 3, True),
    ("bilateral", 5, False)])
def test_denoised_display_matches_jax(method, acc_ctr, with_history):
    """display() with denoise: the moment variance from 2 frames on, the
    spatial estimate before, and the history's color and variance where
    it has integrated more frames than the accumulator."""
    j, t = _fed_renderers(method, acc_ctr, with_history)
    with jax.disable_jit():
        want = j.display()
    got = t.display()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    raw = display_image(t.accumulator, t.cfg.params).numpy()
    assert not np.allclose(got, raw)


def test_sidecar_matches_jax_exporter(scene, tmp_path):
    """Renderer.export's sidecar equals the JAX exporter's text for the
    same values, pass times included, but for the render time; the PNG
    holds the display image's bytes."""
    from PIL import Image

    from tpu_restir.io.export import export_image as j_export_image

    r = Renderer(scene, _cfg().replace(profile_passes=True), device="cpu")
    r.run(2)
    path = str(tmp_path / "port.png")
    r.export(path)
    mean, var = r.stats()
    ref = str(tmp_path / "jax.png")
    j_export_image(ref, r.display(), iterations=r.acc_ctr,
                   restir=r.cfg.restir, render_time_s=123.0,
                   image_mean=mean, image_variance=var,
                   cam_pos=r.cam.pos.numpy(),
                   cam_view_at=r.cam.view_at.numpy(),
                   fov_deg=r.cfg.camera.fov_y_deg,
                   pass_times_ms=r.timers.mean_ms())

    def lines(p, name):
        return [ln.replace(name, "IMG") for ln in open(p + ".txt")
                if not ln.startswith("Render time:")]

    assert lines(path, path) == lines(ref, ref)
    assert "Pass times (ms):\n" in lines(path, path)
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  np.asarray(Image.open(ref)))


def test_jax_checkpoint_resumes_in_port(scene, tmp_path):
    """A checkpoint written by the JAX Renderer resumes in the port with
    equal arrays (the RestirState leaves in the JAX pytree's order), and
    the port's checkpoint resumes in the JAX Renderer; the port then
    renders on from the restored state."""
    from tpu_restir.io import checkpoint as jck
    from tpu_restir.renderer import Renderer as JRenderer
    from tpu_restir.scene import cornell_box as j_cornell_box
    from tpu_restir_torch.io import checkpoint as tck

    cfg = _cfg()
    j = JRenderer(j_cornell_box(), cfg)
    g = np.random.default_rng(5)

    def rand(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return jnp.asarray(g.random(x.shape) < 0.5)
        if x.dtype == np.int32:
            return jnp.asarray(g.integers(0, 4, x.shape, dtype=np.int32))
        return jnp.asarray(g.random(x.shape, dtype=np.float32))

    j._restir_state = jax.tree.map(rand, j._restir_state)
    j.accumulator = rand(j.accumulator)
    j.acc_ctr, j.frame_ctr, j.render_time = 7, 9, 1.5
    jck.save(j, str(tmp_path / "jax_ck"))
    t = Renderer(scene, cfg, device="cpu")
    assert tck.try_restore(t, str(tmp_path / "jax_ck"))
    assert (t.acc_ctr, t.frame_ctr, t.render_time) == (7, 9, 1.5)
    np.testing.assert_array_equal(t.accumulator.numpy(),
                                  np.asarray(j.accumulator))
    want = jax.tree.map(np.asarray, j._restir_state)
    got = convert.to_numpy(t._restir_state)
    for part in ("res_prev", "gb_prev"):
        for name, val in got[part].items():
            w = getattr(getattr(want, part), name)
            if isinstance(val, dict):
                for sub, x in val.items():
                    np.testing.assert_array_equal(x, getattr(w, sub))
                    assert x.dtype == getattr(w, sub).dtype
            else:
                np.testing.assert_array_equal(val, w, err_msg=name)
                assert val.dtype == w.dtype, name
    tck.save(t, str(tmp_path / "port_ck"))
    j2 = JRenderer(j_cornell_box(), cfg)
    assert jck.try_restore(j2, str(tmp_path / "port_ck"))
    for a, b in zip(jax.tree.leaves(j2._restir_state),
                    jax.tree.leaves(j._restir_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not tck.try_restore(t, str(tmp_path / "missing"))
    assert float(t.moment2.abs().max()) == 0.0     # not in a JAX checkpoint
    t.step()
    assert t.acc_ctr == 8 and torch.isfinite(t.accumulator).all()


def test_port_checkpoint_keeps_the_denoiser_guide(scene, tmp_path):
    """The port's checkpoint also holds the luminance second moment, so a
    resumed denoised render keeps its variance guide: the resumed
    renderer's denoised display equals the uninterrupted one's."""
    from tpu_restir_torch.io import checkpoint as tck

    cfg = _cfg().replace(params=RenderParams(use_skybox=False, denoise=True))
    whole = Renderer(scene, cfg, device="cpu")
    whole.run(4)
    first = Renderer(scene, cfg, device="cpu")
    first.run(3)
    tck.save(first, str(tmp_path / "ck"))
    resumed = Renderer(scene, cfg, device="cpu")
    assert tck.try_restore(resumed, str(tmp_path / "ck"))
    assert torch.equal(resumed.moment2, first.moment2)
    resumed._svgf_hist = first._svgf_hist
    resumed.run(1)
    assert torch.equal(resumed.moment2, whole.moment2)
    np.testing.assert_array_equal(resumed.display(), whole.display())
    raw = display_image(resumed.accumulator, cfg.params).numpy()
    assert not np.allclose(resumed.display(), raw)


def test_update_config_camera_and_reset(scene):
    """Live edits keep resolution and integrator; a camera move changes
    the camera only; a reset clears the accumulation."""
    from tpu_restir_torch.view import apply_key

    r = Renderer(scene, _cfg(), device="cpu")
    r.step()
    r.update_config(apply_key(r.cfg, "t"))
    assert not r.cfg.restir.do_temporal_reuse
    r.step()
    assert r.acc_ctr == 2 and torch.isfinite(r.accumulator).all()
    with pytest.raises(ValueError, match="resolution"):
        r.update_config(r.cfg.replace(camera=dataclasses.replace(
            CCFG, width=32)))
    before = r.cam.view_mat.clone()
    r.set_camera(view_from=(0.5, -3.5, 1.2))
    assert not torch.equal(before, r.cam.view_mat)
    r.reset_accumulation()
    assert r.acc_ctr == 0 and float(r.accumulator.abs().max()) == 0.0
    assert float(r.moment2.abs().max()) == 0.0


def test_restir_step_is_single_device(scene):
    """Without a mesh the step renders every row; with one, its state must
    hold this rank's rows of a height that the ranks divide (the sharded
    frames: tests/test_torch_dist.py)."""
    from tpu_restir_torch.dist.mesh import Mesh

    cfg = _cfg()
    cam = tcam.make_camera(CCFG, "cpu")
    frame, _ = tpipe.restir_step(scene, cam, cfg, 1,
                                 tpipe.init_restir_state(12, 16, "cpu"), 0)
    assert frame.shape == (12, 16, 3)
    two = Mesh(None, 0, 2, torch.device("cpu"), "rows", "gloo")
    with pytest.raises(ValueError, match="not 2 shards of 5 rows"):
        tpipe.restir_step(scene, cam, cfg, 1,
                          tpipe.init_restir_state(5, 16, "cpu"), 0,
                          mesh=two)


@pytest.mark.parametrize("restir", [
    BENCH,
    RestirParams(m_area=2, m_brdf=1, do_spatial_reuse=True,
                 spatial_neighbor_count=3, spatial_mis="balance"),
    RestirParams(m_area=1, m_brdf=2, do_visibility_pass=True,
                 do_temporal_reuse=True, do_spatial_reuse=True,
                 spatial_mis="constant"),
])
def test_traced_rays_match_the_analytic_count(scene, restir):
    import bench

    cfg = _cfg(restir)
    assert metrics.rays_per_pixel(cfg) == bench.rays_per_pixel(cfg)
    with tracing.recording() as rec:
        tpipe.render_restir_frames(scene, tcam.make_camera(CCFG, "cpu"),
                                   cfg, 0, 1, "cpu")
    log = intersect.queries(rec)
    assert sum(e["rays"] for e in log) == metrics.rays_per_pixel(cfg) * 192


def test_all_spatial_schemes_render(scene):
    means = {}
    for scheme in ("constant", "constant_debias_z", "constant_debias_contrib",
                   "balance", "pairwise"):
        restir = RestirParams(m_area=2, m_brdf=1, do_spatial_reuse=True,
                              spatial_neighbor_count=3, spatial_mis=scheme)
        img = tpipe.render_restir_frames(
            scene, tcam.make_camera(CCFG, "cpu"), _cfg(restir), 5, 2, "cpu")
        assert torch.isfinite(img).all()
        means[scheme] = float(img.mean())
    ref = means["pairwise"]
    assert all(abs(m - ref) < 0.25 * ref for m in means.values()), means


def test_debug_reprojection_and_stage_cut(scene):
    cam = tcam.make_camera(CCFG, "cpu")
    restir = RestirParams(do_temporal_reuse=True, debug_reprojection=True)
    cfg = _cfg(restir)
    state = tpipe.init_restir_state(12, 16, "cpu")
    frame0, state = tpipe.restir_step(scene, cam, cfg,
                                      rng.make_frame_seed(0, 0), state, 0)
    assert float(frame0.max()) < 100.0           # frame 0 is never painted
    frame1, _ = tpipe.restir_step(scene, cam, cfg, rng.make_frame_seed(0, 1),
                                  state, 1)
    painted = (frame1 == 100.0).any(-1)
    assert painted.any() and not painted.all()
    cut, st = tpipe.restir_step(scene, cam,
                                cfg.replace(profile_stop_after="initial"),
                                rng.make_frame_seed(0, 1), state, 1)
    assert float(cut.abs().max()) == 0.0
    assert st.res_prev.w_sum.shape == (12, 16)


def test_pass_timers_record_and_mean_ms():
    """PassTimers.record accumulates per-name durations and counts;
    mean_ms averages per call, in milliseconds; metrics.sync takes
    tensors, lists and dataclasses (a no-op for CPU tensors)."""
    timers = metrics.PassTimers()
    timers.record("spatial", 0.010)
    timers.record("shade", 0.004)
    timers.record("shade", 0.002)
    ms = timers.mean_ms()
    assert timers.counts == {"spatial": 1, "shade": 2}
    assert abs(ms["spatial"] - 10.0) < 1e-9 and abs(ms["shade"] - 3.0) < 1e-9
    metrics.sync((torch.ones(3), [torch.zeros(2)]))
