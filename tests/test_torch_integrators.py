"""The port's naive and NEE path tracers against the JAX package's, whole
frames on the CPU at 16x12, and their entry points: Renderer, the CLI and
checkpoints across the two packages.

Both packages draw the same threefry numbers (tests/test_torch_threefry.py),
so the same pixel follows the same path in both, and a frame is held
pixel by pixel: allclose at rtol 1e-4, atol 1e-5 on at least 99% of the
pixels. The rest may differ: the JAX package intersects with its CPU
backend (a matmul form of the same Woop test) and XLA rounds sin, cos and
pow otherwise than PyTorch, so a lobe pick, a Russian-roulette kill or a
hit at an edge can flip on a pixel and send its path elsewhere. The JAX
frames run op by op (jax.disable_jit()), which compiles far less than a
jitted frame.

Cases: the naive tracer and NEE-MIS on the Cornell box, its glossy box
(Phong) and its mirror box, at max_bounce_count 3; NEE with the area, BRDF
and RIS strategies and with show_weights; and the naive and NEE tracers at
max_bounce_count 7 with rr_start_bounce 2, so that Russian roulette runs.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_restir import config as jc
from tpu_restir import rng as jrng
from tpu_restir.render import camera as jcam
from tpu_restir.render.integrators import render_naive as j_naive
from tpu_restir.render.integrators import render_nee as j_nee
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir_torch import config as tc
from tpu_restir_torch import rng, tracing
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.render import intersect
from tpu_restir_torch.render.integrators import render_naive, render_nee
from tpu_restir_torch.renderer import Renderer
from tpu_restir_torch.scene.cornell import cornell_box

W, H = 16, 12
TOL = dict(rtol=1e-4, atol=1e-5)
MIN_SHARE = 0.99


def _cfg(mod, integrator, bounces=3, rr_start=5, **kw):
    return mod.RenderConfig(
        camera=mod.CameraConfig(width=W, height=H, fov_y_deg=45.0,
                                view_from=(0.0, -3.9, 1.0),
                                view_at=(0.0, 0.0, 1.0),
                                pixel_sampler="random"),
        params=mod.RenderParams(use_skybox=False, max_bounce_count=bounces,
                                rr_start_bounce=rr_start),
        integrator=integrator, **kw)


def _boxes(box):
    kw = dict(glossy_box=box == "glossy", mirror_box=box == "mirror")
    return j_cornell_box(**kw), cornell_box("cpu", **kw)


def _close_share(got, want):
    return float(np.isclose(got, want, **TOL).all(-1).mean())


CASES = [
    ("naive", "cornell", {}), ("naive", "glossy", {}),
    ("naive", "mirror", {}),
    ("nee", "cornell", {}), ("nee", "glossy", {}), ("nee", "mirror", {}),
    ("nee", "cornell", dict(direct_strategy="area")),
    ("nee", "glossy", dict(direct_strategy="brdf")),
    ("nee", "glossy", dict(direct_strategy="ris", ris_candidates=4)),
    ("nee", "cornell", dict(show_weights=True)),
    ("naive", "glossy", dict(bounces=7, rr_start=2)),
    ("nee", "cornell", dict(bounces=7, rr_start=2)),
]


@pytest.mark.parametrize("integrator,box,kw", CASES)
def test_frame_matches_jax(integrator, box, kw):
    jcfg, tcfg = _cfg(jc, integrator, **kw), _cfg(tc, integrator, **kw)
    js, ts = _boxes(box)
    jfn, tfn = ((j_naive, render_naive) if integrator == "naive"
                else (j_nee, render_nee))
    with jax.disable_jit():
        want = np.asarray(jfn(js, jcam.make_camera(jcfg.camera), jcfg,
                              jrng.frame_key(0, 5)))
    got = tfn(ts, tcam.make_camera(tcfg.camera, "cpu"), tcfg,
              rng.frame_key(0, 5))
    assert tuple(got.shape) == (H, W, 3) and torch.isfinite(got).all()
    share = _close_share(got.numpy(), want)
    assert share >= MIN_SHARE, share
    assert want.mean() > 0.05


@pytest.mark.parametrize("integrator,kw,want", [
    ("naive", {}, 5), ("nee", dict(direct_strategy="area"), 10),
    ("nee", dict(direct_strategy="brdf"), 10), ("nee", {}, 15),
    ("nee", dict(direct_strategy="ris"), 10),
    ("nee", dict(nee_calc_gi=False), 3),
    ("nee", dict(nee_calc_gi=False, nee_calc_di=False), 1)])
def test_traced_rays_match_the_analytic_count(integrator, kw, want):
    """Every bounce traces the whole wavefront: B + 1 closest queries for
    the naive tracer; NEE adds the strategy's rays per vertex (r = 1 for
    area, BRDF and RIS, 2 for MIS), on B + 1 vertices with GI, else 1
    (B = 4 here)."""
    cfg = _cfg(tc, integrator, bounces=4, **kw)
    fn = render_naive if integrator == "naive" else render_nee
    with tracing.recording() as rec:
        fn(cornell_box("cpu"), tcam.make_camera(cfg.camera, "cpu"), cfg,
           rng.frame_key(0, 0))
    log = intersect.queries(rec)
    assert chip_smoke.path_rays_per_pixel(cfg) == want
    assert sum(e["rays"] for e in log) == want * W * H


# ---------------------------------------------------------------------------
# Renderer, CLI and checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def renderers():
    """The JAX and the port Renderer after run(3), NEE-MIS at 2 bounces."""
    from tpu_restir.renderer import Renderer as JRenderer

    jcfg, tcfg = _cfg(jc, "nee", bounces=2), _cfg(tc, "nee", bounces=2)
    j = JRenderer(j_cornell_box(), jcfg)
    j.run(3)
    t = Renderer(cornell_box("cpu"), tcfg, device="cpu")
    acc = t.run(3)
    assert acc.shape == (H, W, 3) and t._restir_state is None
    return j, t


def test_renderer_run_stats_display_export_match_jax(renderers, tmp_path):
    j, t = renderers
    assert (t.acc_ctr, t.frame_ctr) == (j.acc_ctr, j.frame_ctr) == (3, 3)
    assert _close_share(t.accumulator.numpy(),
                        np.asarray(j.accumulator)) >= MIN_SHARE
    (jm, jv), (tm, tv) = j.stats(), t.stats()
    assert np.isclose(tm, jm, rtol=1e-4) and np.isclose(tv, jv, rtol=1e-3)
    assert _close_share(t.display(), j.display()) >= MIN_SHARE
    tp, jp = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    t.export(tp)
    j.export(jp)

    def lines(p):
        return [ln.replace(p, "IMG") for ln in open(p + ".txt")
                if not ln.startswith("Render time:")]

    assert lines(tp) == lines(jp)
    assert "Iteration count: 3\n" in lines(tp)


def test_renderer_refuses_as_jax(renderers):
    """profile_passes at construction and denoise at display raise
    ValueError without ReSTIR, in both packages; update_config keeps the
    integrator."""
    from tpu_restir.renderer import Renderer as JRenderer

    j, t = renderers
    for mod, make in ((jc, lambda c: JRenderer(j_cornell_box(), c)),
                      (tc, lambda c: Renderer(cornell_box("cpu"), c,
                                              device="cpu"))):
        with pytest.raises(ValueError, match="profile_passes"):
            make(_cfg(mod, "naive", profile_passes=True))
        r = make(dataclasses.replace(
            _cfg(mod, "naive"),
            params=mod.RenderParams(use_skybox=False, denoise=True)))
        with pytest.raises(ValueError, match="denoise"):
            r.display()
        with pytest.raises(ValueError, match="integrator"):
            r.update_config(_cfg(mod, "nee"))
    t.update_config(_cfg(tc, "nee", bounces=2, direct_strategy="area"))
    assert t.cfg.direct_strategy == "area"
    t.update_config(_cfg(tc, "nee", bounces=2))


def test_checkpoint_without_restir_state_crosses_packages(renderers,
                                                          tmp_path):
    """A naive/NEE checkpoint holds no ReSTIR keys; the JAX one resumes in
    the port and the port's in JAX, with equal arrays; a ReSTIR
    checkpoint's state is ignored by a path tracer, as in JAX."""
    from tpu_restir.io import checkpoint as jck
    from tpu_restir.renderer import Renderer as JRenderer
    from tpu_restir_torch.io import checkpoint as tck

    j, t = renderers
    jck.save(j, str(tmp_path / "jax_ck"))
    with np.load(str(tmp_path / "jax_ck.npz")) as data:
        assert not any(k.startswith("restir_") for k in data.files)
    t2 = Renderer(cornell_box("cpu"), t.cfg, device="cpu")
    assert tck.try_restore(t2, str(tmp_path / "jax_ck"))
    assert (t2.acc_ctr, t2.frame_ctr) == (j.acc_ctr, j.frame_ctr)
    np.testing.assert_array_equal(t2.accumulator.numpy(),
                                  np.asarray(j.accumulator))
    assert t2._restir_state is None
    tck.save(t2, str(tmp_path / "port_ck"))
    with np.load(str(tmp_path / "port_ck.npz")) as data:
        assert not any(k.startswith("restir_") for k in data.files)
    j2 = JRenderer(j_cornell_box(), j.cfg)
    assert jck.try_restore(j2, str(tmp_path / "port_ck"))
    np.testing.assert_array_equal(np.asarray(j2.accumulator),
                                  t2.accumulator.numpy())
    # a ReSTIR renderer's checkpoint into a path tracer, and back
    rcfg = _cfg(tc, "restir")
    rr = Renderer(cornell_box("cpu"), rcfg, device="cpu")
    rr.run(1)
    tck.save(rr, str(tmp_path / "restir_ck"))
    assert tck.try_restore(t2, str(tmp_path / "restir_ck"))
    assert t2._restir_state is None and t2.acc_ctr == rr.acc_ctr
    before = [x.clone() for x in (rr._restir_state.res_prev.w_sum,)]
    assert tck.try_restore(rr, str(tmp_path / "port_ck"))
    assert torch.equal(rr._restir_state.res_prev.w_sum, before[0])
    t2.step()
    assert torch.isfinite(t2.accumulator).all()


@pytest.mark.parametrize("argv", [
    ["--integrator", "nee", "--direct", "ris"],
    ["--integrator", "nee", "--direct", "mis", "--show-weights"],
    ["--integrator", "naive"]])
def test_cli_renders_naive_and_nee(tmp_path, argv):
    from PIL import Image

    from tpu_restir_torch import cli as tcli

    out = str(tmp_path / "img" / "x.png")
    assert tcli.main(["--size", "16x12", "--frames", "2", "--bounces", "2",
                      "--device", "cpu", "--out", out] + argv) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (12, 16, 4) and 0 < img[..., :3].mean() < 255
    assert "Iteration count: 2\n" in open(out + ".txt").read()
    assert os.path.exists(out)
