"""The port's renderer, pipeline options and ray accounting, on the CPU.

Display transfer against the JAX package's display_image at rtol 1e-6 /
atol 1e-6 (float32 pow); the traced ray count per pixel must equal the
bench's analytic count exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir.config import (CameraConfig, RenderConfig, RenderParams,
                               RestirParams)
from tpu_restir.renderer import display_image as j_display_image
from tpu_restir_torch import metrics, rng
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


@pytest.mark.parametrize("kw", [dict(integrator="nee"),
                                dict(profile_passes=True), dict(n_devices=2),
                                dict(params=RenderParams(denoise=True))])
def test_renderer_refuses_what_is_not_ported(scene, kw):
    cfg = _cfg().replace(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        Renderer(scene, cfg, device="cpu")


def test_restir_step_is_single_device(scene):
    cfg = _cfg()
    state = tpipe.init_restir_state(12, 16, "cpu")
    cam = tcam.make_camera(CCFG, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        tpipe.restir_step(scene, cam, cfg, 1, state, 0, axis_name="rows")


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
    intersect.QUERY_LOG = log = []
    try:
        tpipe.render_restir_frames(scene, tcam.make_camera(CCFG, "cpu"),
                                   cfg, 0, 1, "cpu")
    finally:
        intersect.QUERY_LOG = None
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
