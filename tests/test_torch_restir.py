"""The port's ReSTIR passes against the JAX passes, pass by pass, and two
whole frames, on the CPU at 32x16 with the bench's flags (m_area=1,
m_brdf=1, temporal reuse, one 5-neighbour pairwise spatial pass).

Pass by pass, each port pass gets the JAX pass's own inputs (through
tpu_restir_torch.convert), so drift cannot compound across passes.
The JAX reference runs its CPU intersection backend (a matmul form of the
same Woop test, which rounds otherwise than the port's separate products),
and XLA and PyTorch implement sqrt, sin, pow and friends differently, so:
  * G-buffer, reservoirs and pixels: rtol 1e-4, atol 1e-5 on pixels that
    hold the same sample (a few float32 ulps through the p_hat chain);
  * a pixel may pick another sample where one rounding flips a hit or the
    reservoir test u < w / w_sum: fewer than 1% of pixels may differ;
  * whole frames: image means within one standard error of the mean,
    fewer than 1% of final reservoirs holding another sample, and their
    weights at rtol 1e-3 (two frames of four passes compound the rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import rng as jrng
from tpu_restir.config import (CameraConfig, RenderConfig, RenderParams,
                               RestirParams)
from tpu_restir.render import camera as jcam
from tpu_restir.render.integrators.restir import gbuffer as jgb
from tpu_restir.render.integrators.restir import pipeline as jpipe
from tpu_restir.render.integrators.restir.initial import (
    initial_pass as j_initial)
from tpu_restir.render.integrators.restir.shade import shade_pass as j_shade
from tpu_restir.render.integrators.restir.spatial import (
    spatial_pass as j_spatial)
from tpu_restir.render.integrators.restir.temporal import (
    temporal_pass as j_temporal)
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir_torch import convert
from tpu_restir_torch import rng as trng
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.render.integrators.restir import gbuffer as tgb
from tpu_restir_torch.render.integrators.restir import pipeline as tpipe
from tpu_restir_torch.render.integrators.restir.gbuffer import GBuffer
from tpu_restir_torch.render.integrators.restir.initial import initial_pass
from tpu_restir_torch.render.integrators.restir.pipeline import RestirState
from tpu_restir_torch.render.integrators.restir.reservoir import Reservoir
from tpu_restir_torch.render.integrators.restir.shade import shade_pass
from tpu_restir_torch.render.integrators.restir.spatial import spatial_pass
from tpu_restir_torch.render.integrators.restir.temporal import (
    temporal_pass)
from tpu_restir_torch.scene.cornell import cornell_box as t_cornell_box

W, H = 32, 16
TOL = dict(rtol=1e-4, atol=1e-5)
MAX_DIFF_SHARE = 0.01

CFG = RenderConfig(
    camera=CameraConfig(width=W, height=H, fov_y_deg=45.0,
                        view_from=(0.0, -3.9, 1.0), view_at=(0.0, 0.0, 1.0),
                        pixel_sampler="random"),
    params=RenderParams(use_skybox=False),
    restir=RestirParams(m_area=1, m_brdf=1, do_temporal_reuse=True,
                        do_spatial_reuse=True, spatial_neighbor_count=5,
                        spatial_mis="pairwise"),
    integrator="restir")
CFG_CONSTANT = CFG.replace(restir=CFG.restir.__class__(
    **{**CFG.restir.__dict__, "spatial_mis": "constant"}))


def _np(x):
    return jax.tree.map(np.asarray, x)


def _to_port(cls, x):
    return convert.from_tree(cls, _np(x), "cpu")


@pytest.fixture(scope="module")
def ref():
    """The JAX frames: frame 0 whole, frame 1 pass by pass."""
    js = j_cornell_box()
    jc = jcam.make_camera(CFG.camera)
    ys, xs = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
    step = jax.jit(jpipe.restir_step, static_argnames=("cfg",))
    frame0, state0 = step(js, jc, CFG, jrng.make_frame_seed(0, 0),
                          jpipe.init_restir_state(H, W), jnp.asarray(0))
    s1 = jrng.make_frame_seed(0, 1)
    gb1 = jax.jit(jgb.gbuffer_fill, static_argnames=("cfg",))(
        js, jc, CFG, s1, ys, xs)
    res1 = jax.jit(j_initial, static_argnames=("cfg",))(
        s1, js, gb1, CFG, ys, xs)
    res_t, reasons = jax.jit(
        j_temporal, static_argnames=("cfg", "return_reasons"))(
        s1, js, gb1, state0.gb_prev, res1, state0.res_prev, CFG, ys, xs,
        return_reasons=True)
    spatial = jax.jit(j_spatial, static_argnames=("cfg", "pass_idx"))
    res_s = spatial(s1, 0, js, gb1, res_t, CFG, ys, xs)
    res_c = spatial(s1, 0, js, gb1, res_t, CFG_CONSTANT, ys, xs)
    img1 = jax.jit(j_shade, static_argnames=("cfg",))(js, gb1, res_s, CFG)
    frame1, state1 = step(js, jc, CFG, s1, state0, jnp.asarray(1))
    return dict(scene=t_cornell_box("cpu"),
                cam=tcam.make_camera(CFG.camera, "cpu"),
                ys=torch.from_numpy(np.array(ys, np.int32)),
                xs=torch.from_numpy(np.array(xs, np.int32)),
                seed1=int(np.asarray(s1)), state0=state0, gb1=gb1,
                res1=res1, res_t=res_t, reasons=np.asarray(reasons),
                res_s=res_s, res_c=res_c,
                img1=np.asarray(img1), frames=(np.asarray(frame0),
                                               np.asarray(frame1)),
                state1=state1)


def _assert_reservoirs(port: Reservoir, want, tol=TOL):
    """Same sample on all but < 1% of pixels; weights close on the rest."""
    w = _np(want)
    same = (np.abs(port.sample.point.numpy() - w.sample.point)
            .max(-1) <= 1e-4) \
        & (port.sample.valid.numpy() == w.sample.valid)
    assert 1.0 - same.mean() < MAX_DIFF_SHARE, 1.0 - same.mean()
    for name in ("w_sum", "w", "confidence"):
        np.testing.assert_allclose(getattr(port, name).numpy()[same],
                                   getattr(w, name)[same], **tol,
                                   err_msg=name)
    return same


def test_gbuffer_pass(ref):
    got = tgb.gbuffer_fill(ref["scene"], ref["cam"], CFG, ref["seed1"],
                           ref["ys"], ref["xs"])
    want = _np(ref["gb1"])
    same = got.mat_type.numpy() == want.mat_type
    same &= np.abs(got.depth.numpy() - want.depth) <= 1e-4
    assert 1.0 - same.mean() < MAX_DIFF_SHARE
    assert (want.depth > 0).mean() > 0.2       # the box fills the view
    for name in ("pos", "normal", "diffuse", "emission", "depth", "inv_i_m",
                 "shininess"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   getattr(want, name)[same], **TOL,
                                   err_msg=name)


def test_initial_pass(ref):
    got = initial_pass(ref["seed1"], ref["scene"],
                       _to_port(GBuffer, ref["gb1"]), CFG, ref["ys"],
                       ref["xs"])
    same = _assert_reservoirs(got, ref["res1"])
    assert (got.w.numpy()[same] > 0).mean() > 0.1


def test_temporal_pass(ref):
    st0 = _to_port(RestirState, ref["state0"])
    got, reasons = temporal_pass(
        ref["seed1"], ref["scene"], _to_port(GBuffer, ref["gb1"]),
        st0.gb_prev, _to_port(Reservoir, ref["res1"]), st0.res_prev, CFG,
        ref["ys"], ref["xs"], return_reasons=True)
    _assert_reservoirs(got, ref["res_t"])
    # rejection reasons of the cascade (debug_reprojection's colours)
    assert (reasons.numpy() != ref["reasons"]).mean() < MAX_DIFF_SHARE
    assert (reasons.numpy() == 0).mean() > 0.1


@pytest.mark.parametrize("scheme", ["pairwise", "constant"])
def test_spatial_pass(ref, scheme):
    cfg = CFG if scheme == "pairwise" else CFG_CONSTANT
    got = spatial_pass(ref["seed1"], 0, ref["scene"],
                       _to_port(GBuffer, ref["gb1"]),
                       _to_port(Reservoir, ref["res_t"]), cfg, ref["ys"],
                       ref["xs"])
    _assert_reservoirs(got, ref["res_s" if scheme == "pairwise" else "res_c"])


def test_shade_pass(ref):
    img = shade_pass(ref["scene"], _to_port(GBuffer, ref["gb1"]),
                     _to_port(Reservoir, ref["res_s"]), CFG).numpy()
    close = np.isclose(img, ref["img1"], **TOL).all(-1)
    assert 1.0 - close.mean() < MAX_DIFF_SHARE
    assert np.isfinite(img).all() and img.mean() > 0.1


def test_two_whole_frames(ref):
    state = tpipe.init_restir_state(H, W, "cpu")
    frames = []
    for f in range(2):
        frame, state = tpipe.restir_step(ref["scene"], ref["cam"], CFG,
                                         trng.make_frame_seed(0, f), state, f)
        frames.append(frame.numpy())
    for got, want in zip(frames, ref["frames"]):
        pix = want.mean(-1)
        stderr = pix.std() / np.sqrt(pix.size)
        assert abs(got.mean() - want.mean()) <= stderr
    # two frames of four passes compound the per-pass rounding
    _assert_reservoirs(state.res_prev, ref["state1"].res_prev,
                       dict(rtol=1e-3, atol=1e-5))
