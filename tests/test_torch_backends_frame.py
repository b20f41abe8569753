"""The slice as a whole on the CPU: a ReSTIR frame under fcluster, and the
G-buffer and initial passes under cluster and bvh, on
many_lights_scene(200), against the JAX package's (jitted; its initial
pass takes K1 on the emissive subset in the interpreter, as
tests/test_torch_restir_large.py runs it). Tolerances as that file
states them: rtol 1e-4, atol 1e-5 on pixels that hold the same sample,
fewer than 1% of pixels apart, and image means within a standard error.
The backends query by query: tests/test_torch_backends.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import rng as jrng
from tpu_restir.config import CameraConfig as JCameraConfig
from tpu_restir.config import IntersectorConfig as JConfig
from tpu_restir.config import RenderConfig as JRenderConfig
from tpu_restir.config import RenderParams as JRenderParams
from tpu_restir.config import RestirParams as JRestirParams
from tpu_restir.kernels import ray_tri as jrt
from tpu_restir.render import camera as jcam
from tpu_restir.render.integrators.restir import gbuffer as jgb
from tpu_restir.render.integrators.restir import initial as jinit
from tpu_restir.render.integrators.restir import pipeline as jpipe
from tpu_restir.scene.cornell import many_lights_scene as j_many_lights
from tpu_restir_torch import convert
from tpu_restir_torch import rng as trng
from tpu_restir_torch import tracing
from tpu_restir_torch.config import (CameraConfig, IntersectorConfig,
                                     RenderConfig, RenderParams,
                                     RestirParams)
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.render import intersect as tintersect
from tpu_restir_torch.render.integrators.restir import gbuffer as tgb
from tpu_restir_torch.render.integrators.restir import initial as tinit
from tpu_restir_torch.render.integrators.restir import pipeline as tpipe
from tpu_restir_torch.render.integrators.restir.gbuffer import GBuffer
from tpu_restir_torch.scene.cornell import many_lights_scene as t_many_lights

PASS_TOL = dict(rtol=1e-4, atol=1e-5)
MAX_DIFF_SHARE = 0.01
CORNELL_VIEW = ((0.0, -3.9, 1.0), (0.0, 0.0, 1.0))


@pytest.fixture(scope="module")
def scenes():
    return {"lights200": (j_many_lights(200), t_many_lights("cpu", 200))}


def _frame_cfg(backend, jax_side, w=32, h=16):
    cam, params, restir, rcfg, icfg = (
        (JCameraConfig, JRenderParams, JRestirParams, JRenderConfig, JConfig)
        if jax_side else (CameraConfig, RenderParams, RestirParams,
                          RenderConfig, IntersectorConfig))
    return rcfg(
        camera=cam(width=w, height=h, fov_y_deg=45.0,
                   view_from=CORNELL_VIEW[0], view_at=CORNELL_VIEW[1],
                   pixel_sampler="random"),
        params=params(use_skybox=False),
        restir=restir(m_area=1, m_brdf=1, do_temporal_reuse=True,
                      do_spatial_reuse=True, spatial_neighbor_count=5,
                      spatial_mis="pairwise"),
        intersector=icfg(backend=backend), integrator="restir")


@pytest.fixture
def _interpret_k1():
    """The JAX initial pass takes K1 on the emissive subset; in the
    interpreter, as tests/test_torch_restir_large.py runs it."""
    jrt.INTERPRET = True
    yield
    jrt.INTERPRET = False


@pytest.mark.usefixtures("_interpret_k1")
def test_restir_frame_under_fcluster(scenes):
    """One 32x16 ReSTIR frame (temporal and pairwise spatial reuse) on
    many_lights_scene(200), every scene query under fcluster, against the
    JAX frame: image means within a standard error, reservoirs as
    tests/test_torch_restir_large.py holds them."""
    js, ts = scenes["lights200"]
    jcfg, tcfg = _frame_cfg("fcluster", True), _frame_cfg("fcluster", False)
    h, w = 16, 32
    want, jstate = jax.jit(jpipe.restir_step, static_argnames=("cfg",))(
        js, jcam.make_camera(jcfg.camera), jcfg, jrng.make_frame_seed(0, 0),
        jpipe.init_restir_state(h, w), jnp.asarray(0))
    with tracing.recording() as rec:
        got, tstate = tpipe.restir_step(
            ts, tcam.make_camera(tcfg.camera, "cpu"), tcfg,
            trng.make_frame_seed(0, 0), tpipe.init_restir_state(h, w, "cpu"),
            0)
    log = tintersect.queries(rec)
    assert {e["backend"] for e in log} == {"fcluster"} and len(log) >= 10
    want, got = np.asarray(want), got.numpy()
    pix = want.mean(-1)
    assert np.isfinite(got).all() and want.mean() > 0.05
    assert abs(got.mean() - want.mean()) <= pix.std() / np.sqrt(pix.size)
    want_res = jax.tree.map(np.asarray, jstate.res_prev)
    same = (np.abs(tstate.res_prev.sample.point.numpy()
                   - want_res.sample.point).max(-1) <= 1e-4) \
        & (tstate.res_prev.sample.valid.numpy() == want_res.sample.valid)
    assert 1.0 - same.mean() < MAX_DIFF_SHARE


@pytest.mark.usefixtures("_interpret_k1")
@pytest.mark.parametrize("backend", ["cluster", "bvh"])
def test_gbuffer_and_initial_passes(scenes, backend):
    """The G-buffer and initial passes of a 64x32 frame on
    many_lights_scene(200) under cluster and bvh against the JAX passes,
    pass by pass (the port's initial pass gets the JAX G-buffer)."""
    js, ts = scenes["lights200"]
    jcfg = _frame_cfg(backend, True, 64, 32)
    tcfg = _frame_cfg(backend, False, 64, 32)
    ys, xs = jnp.meshgrid(jnp.arange(32), jnp.arange(64), indexing="ij")
    seed = jrng.make_frame_seed(0, 1)
    jgbuf = jax.jit(jgb.gbuffer_fill, static_argnames=("cfg",))(
        js, jcam.make_camera(jcfg.camera), jcfg, seed, ys, xs)
    jres = jax.tree.map(np.asarray, jax.jit(
        jinit.initial_pass, static_argnames=("cfg",))(seed, js, jgbuf, jcfg,
                                                      ys, xs))
    jgbuf = jax.tree.map(np.asarray, jgbuf)
    tys = torch.from_numpy(np.array(ys, np.int32))
    txs = torch.from_numpy(np.array(xs, np.int32))
    with tracing.recording() as rec:
        got = tgb.gbuffer_fill(ts, tcam.make_camera(tcfg.camera, "cpu"),
                               tcfg, int(np.asarray(seed)), tys, txs)
        res = tinit.initial_pass(int(np.asarray(seed)), ts,
                                 convert.from_tree(GBuffer, jgbuf, "cpu"),
                                 tcfg, tys, txs)
    log = tintersect.queries(rec)
    assert {e["backend"] for e in log} == {backend}
    same = got.mat_type.numpy() == jgbuf.mat_type
    same &= np.abs(got.depth.numpy() - jgbuf.depth) <= 1e-4
    assert 1.0 - same.mean() < MAX_DIFF_SHARE
    for field in ("pos", "normal", "diffuse", "emission", "depth"):
        np.testing.assert_allclose(getattr(got, field).numpy()[same],
                                   getattr(jgbuf, field)[same], **PASS_TOL,
                                   err_msg=field)
    same = (np.abs(res.sample.point.numpy() - jres.sample.point).max(-1)
            <= 1e-4) & (res.sample.valid.numpy() == jres.sample.valid)
    for name in ("w_sum", "w", "confidence"):
        same &= np.isclose(getattr(res, name).numpy(), getattr(jres, name),
                           **PASS_TOL)
    assert 1.0 - same.mean() < MAX_DIFF_SHARE
    assert (res.w.numpy()[same] > 0).mean() > 0.05
