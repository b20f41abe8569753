"""The port's G-buffer and initial passes on clustered scenes against the
JAX passes, on the CPU at 64x32 (8x32-tile packets) with the bench's
flags: every scene query goes through the clustered traversal on both
sides (the JAX package's Pallas kernels in the interpreter). The scenes:
terrain_scene(5_000) under the bench's terrain camera, many_lights_scene
(500) (the BRDF candidate intersects its emissive subset), and the two
cases of the BRDF candidate's full closest hit: many_lights_scene(4100)
(more than 4096 lights) and a scene without lights; and terrain_scene
(5_000) rebuilt at cluster size 128 under `ptrace_mxu`, where every scene
query takes the Woop variant (K7/K8; the JAX package's `_closest_kernel_mxu`
and `_any_kernel_mxu` in the interpreter) and two whole 32x16 frames are
held to the JAX frames (image means within a standard error, as
tests/test_torch_restir.py holds the Cornell frames).

Each port pass gets the JAX pass's own inputs (through convert), so drift
cannot compound. Tolerances as tests/test_torch_restir.py states them:
rtol 1e-4, atol 1e-5 on pixels that hold the same sample, and fewer than
1% of pixels may differ where one rounding flips a hit or a reservoir
choice. Here a pixel also differs where its weights fall outside the
tolerance: many_lights_scene's lights hang 1e-3 below its ceiling, so a
ceiling pixel sees them at grazing angles, where one float32 ulp of a
light point's z (XLA and PyTorch round the point's barycentric chain
apart) is 2e-4 of cos_y and so of the candidate's weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import rng as jrng
from tpu_restir.config import (CameraConfig, IntersectorConfig,
                               RenderConfig, RenderParams, RestirParams)
from tpu_restir.kernels import cluster_trace as jct
from tpu_restir.kernels import ray_tri as jrt
from tpu_restir.render import camera as jcam
from tpu_restir.render.integrators.restir import gbuffer as jgb
from tpu_restir.render.integrators.restir import initial as jinit
from tpu_restir.render.integrators.restir import pipeline as jpipe
from tpu_restir.scene.cornell import many_lights_scene as j_many_lights
from tpu_restir.scene.materials import MaterialSpec as JMaterialSpec
from tpu_restir.scene.materials import MatType as JMatType
from tpu_restir.scene.procedural import terrain_scene as j_terrain
from tpu_restir.scene.scene import build_scene as j_build_scene
from tpu_restir_torch import convert
from tpu_restir_torch import rng as trng
from tpu_restir_torch import tracing
from tpu_restir_torch.kernels import cluster_trace as tct
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.render import intersect as tintersect
from tpu_restir_torch.render.integrators.restir import gbuffer as tgb
from tpu_restir_torch.render.integrators.restir import initial as tinit
from tpu_restir_torch.render.integrators.restir import pipeline as tpipe
from tpu_restir_torch.render.integrators.restir.gbuffer import GBuffer
from tpu_restir_torch.scene.cornell import many_lights_scene as t_many_lights
from tpu_restir_torch.scene.materials import MaterialSpec
from tpu_restir_torch.scene.procedural import TERRAIN_SPECS
from tpu_restir_torch.scene.procedural import terrain_scene as t_terrain
from tpu_restir_torch.scene.scene import build_scene

W, H = 64, 32
TOL = dict(rtol=1e-4, atol=1e-5)
MAX_DIFF_SHARE = 0.01
CORNELL_VIEW = ((0.0, -3.9, 1.0), (0.0, 0.0, 1.0))
TERRAIN_VIEW = ((0.0, -7.0, 4.0), (0.0, 0.0, 0.5))


def _cfg(view, mxu=False, width=W, height=H):
    return RenderConfig(
        camera=CameraConfig(width=width, height=height, fov_y_deg=45.0,
                            view_from=view[0], view_at=view[1],
                            pixel_sampler="random"),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(m_area=1, m_brdf=1, do_temporal_reuse=True,
                            do_spatial_reuse=True, spatial_neighbor_count=5,
                            spatial_mis="pairwise"),
        intersector=IntersectorConfig(ptrace_mxu=mxu),
        integrator="restir")


def _lightless(kind):
    """A clustered scene of 300 grey triangles around the Cornell camera's
    view, without any emissive material."""
    g = np.random.default_rng(9)
    v = (g.uniform([-1, -1, 0], [1, 1, 2], (300, 1, 3))
         + g.uniform(-0.15, 0.15, (300, 3, 3))).astype(np.float32)
    mats = np.zeros(300, np.int32)
    if kind == "jax":
        return j_build_scene(v, mats, [JMaterialSpec()])
    return build_scene(v, mats, [MaterialSpec()], "cpu")


def _woop_terrain(kind):
    """terrain_scene(5_000) rebuilt at cluster size 128 (Woop blocks), as
    tests/test_ptrace.py builds its Woop-variant scene."""
    if kind == "jax":
        t = j_terrain(5_000)
        specs = [JMaterialSpec(m.name, JMatType.LAMBERT, diffuse=m.diffuse,
                               emission=m.emission) for m in TERRAIN_SPECS]
        return j_build_scene(np.asarray(t.tri_v), np.asarray(t.tri_mat),
                             specs, cluster_size=128)
    t = t_terrain("cpu", 5_000)
    return build_scene(t.tri_v.numpy(), t.tri_mat.numpy(), TERRAIN_SPECS,
                       "cpu", cluster_size=128)


SCENES = {
    "terrain5k": (lambda: j_terrain(5_000), lambda: t_terrain("cpu", 5_000),
                  TERRAIN_VIEW),
    "woop5k": (lambda: _woop_terrain("jax"), lambda: _woop_terrain("port"),
               TERRAIN_VIEW),
    "lights500": (lambda: j_many_lights(500),
                  lambda: t_many_lights("cpu", 500), CORNELL_VIEW),
    "lights4100": (lambda: j_many_lights(4100),
                   lambda: t_many_lights("cpu", 4100), CORNELL_VIEW),
    "lightless": (lambda: _lightless("jax"), lambda: _lightless("port"),
                  CORNELL_VIEW),
}


@pytest.fixture(autouse=True)
def _interpret_kernels():
    """The JAX package's kernels in the interpreter: the clustered
    traversal, and the Woop kernel on the emissive subset (off the CPU the
    JAX pass takes it up to 1024 lights, as the port takes K1)."""
    jct.INTERPRET = True
    jrt.INTERPRET = True
    yield
    jct.INTERPRET = False
    jrt.INTERPRET = False


_REFS = {}


def _ref(name):
    """The JAX scene's frame-1 G-buffer and initial reservoirs, and the
    port's scene, camera and pixel grid; once per test process."""
    if name not in _REFS:
        jfn, tfn, view = SCENES[name]
        js = jfn()
        cfg = _cfg(view, mxu=name == "woop5k")
        ys, xs = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
        seed = jrng.make_frame_seed(0, 1)
        gb = jax.jit(jgb.gbuffer_fill, static_argnames=("cfg",))(
            js, jcam.make_camera(cfg.camera), cfg, seed, ys, xs)
        res = jax.jit(jinit.initial_pass, static_argnames=("cfg",))(
            seed, js, gb, cfg, ys, xs)
        _REFS[name] = dict(
            js=js, ts=tfn(), cfg=cfg, seed=int(np.asarray(seed)),
            cam=tcam.make_camera(cfg.camera, "cpu"),
            ys=torch.from_numpy(np.array(ys, np.int32)),
            xs=torch.from_numpy(np.array(xs, np.int32)),
            gb=jax.tree.map(np.asarray, gb),
            res=jax.tree.map(np.asarray, res))
    return _REFS[name]


def _assert_reservoirs(port, want):
    """Same sample and weights within TOL on all but < 1% of pixels."""
    same = (np.abs(port.sample.point.numpy() - want.sample.point)
            .max(-1) <= 1e-4) \
        & (port.sample.valid.numpy() == want.sample.valid)
    for name in ("w_sum", "w", "confidence"):
        same &= np.isclose(getattr(port, name).numpy(), getattr(want, name),
                           **TOL)
    assert 1.0 - same.mean() < MAX_DIFF_SHARE, 1.0 - same.mean()
    return same


def _spy_woop(monkeypatch):
    """Count the plain K7/K8 (and K5/K6) calls of the port's queries."""
    calls = []
    for name in ("closest_packets", "any_packets", "closest_packets_mxu",
                 "any_packets_mxu"):
        fn = getattr(tct, name)

        def rec(*a, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*a)

        monkeypatch.setattr(tct, name, rec)
    return calls


@pytest.mark.parametrize("name", ["terrain5k", "lights500", "woop5k"])
def test_gbuffer_pass_on_clustered_scenes(name, monkeypatch):
    r = _ref(name)
    calls = _spy_woop(monkeypatch)
    with tracing.recording() as rec:
        got = tgb.gbuffer_fill(r["ts"], r["cam"], r["cfg"], r["seed"],
                               r["ys"], r["xs"])
    log = tintersect.queries(rec)
    assert [e["backend"] for e in log] == ["ptrace"]
    assert calls == ["closest_packets_mxu" if name == "woop5k"
                     else "closest_packets"]
    want = r["gb"]
    same = got.mat_type.numpy() == want.mat_type
    same &= np.abs(got.depth.numpy() - want.depth) <= 1e-4
    assert 1.0 - same.mean() < MAX_DIFF_SHARE
    assert (want.depth > 0).mean() > 0.2
    for field in ("pos", "normal", "diffuse", "emission", "depth"):
        np.testing.assert_allclose(getattr(got, field).numpy()[same],
                                   getattr(want, field)[same], **TOL,
                                   err_msg=field)


@pytest.mark.parametrize("name", ["terrain5k", "lights500", "lights4100",
                                  "lightless", "woop5k"])
def test_initial_pass_on_clustered_scenes(name, monkeypatch):
    """The initial pass on the JAX pass's G-buffer. lights4100 takes the
    BRDF candidate's full closest hit (more than 4096 lights); the
    lightless scene returns empty reservoirs, as the JAX pass does; under
    ptrace_mxu every scene query of woop5k takes K8."""
    r = _ref(name)
    gb = convert.from_tree(GBuffer, r["gb"], "cpu")
    calls = _spy_woop(monkeypatch)
    with tracing.recording() as rec:
        got = tinit.initial_pass(r["seed"], r["ts"], gb, r["cfg"], r["ys"],
                                 r["xs"])
    log = tintersect.queries(rec)
    assert {e["backend"] for e in log} <= {"ptrace"}
    if name == "woop5k":
        assert calls and set(calls) == {"any_packets_mxu"}
    same = _assert_reservoirs(got, r["res"])
    if name == "lightless":
        assert not got.sample.valid.any() and not log
    else:
        assert (got.w.numpy()[same] > 0).mean() > 0.05
    if name == "lights4100":
        # the BRDF candidate's full closest hit: a closest query at the
        # pixel grid's shape
        assert [e["kind"] for e in log].count("closest") == 1


@pytest.mark.parametrize("name", ["lights4100", "lightless"])
def test_brdf_candidate_full_closest_hit(name):
    """The BRDF candidate beyond 4096 lights and without lights takes a
    full closest hit and the emissive test (initial.py:148-157), against
    the JAX candidate on the same uniforms and G-buffer."""
    r = _ref(name)
    u5 = np.random.default_rng(4).random((H, W, 5), dtype=np.float32)
    jgbuf = jax.tree.map(jnp.asarray, r["gb"])
    jcand, jw, jmis = jinit._brdf_candidate(jnp.asarray(u5), r["js"], jgbuf,
                                            r["cfg"])
    gb = convert.from_tree(GBuffer, r["gb"], "cpu")
    cand, w_c, mis = tinit._brdf_candidate(torch.from_numpy(u5), r["ts"],
                                           gb, r["cfg"])
    valid = np.asarray(jcand.valid)
    same = cand.valid.numpy() == valid
    assert 1.0 - same.mean() < MAX_DIFF_SHARE
    both = same & valid
    for got, want in ((cand.point, jcand.point), (cand.l_i, jcand.l_i),
                      (w_c, jw), (mis, jmis)):
        np.testing.assert_allclose(got.numpy()[both], np.asarray(want)[both],
                                   **TOL)
    if name == "lightless":
        assert not valid.any()
    else:
        assert both.sum() > 5


def test_woop_whole_frames():
    """Two whole 32x16 frames of the bench config on woop5k under
    ptrace_mxu (28 scene queries a frame, all K7/K8) against the JAX frames
    (jitted restir_step, its Woop kernels in the interpreter): image means
    within a standard error of the JAX image, and the reservoirs as
    tests/test_torch_restir.py holds two Cornell frames."""
    w, h = 32, 16
    js, ts = _woop_terrain("jax"), _woop_terrain("port")
    cfg = _cfg(TERRAIN_VIEW, mxu=True, width=w, height=h)
    step = jax.jit(jpipe.restir_step, static_argnames=("cfg",))
    jc = jcam.make_camera(cfg.camera)
    jstate = jpipe.init_restir_state(h, w)
    tc = tcam.make_camera(cfg.camera, "cpu")
    tstate = tpipe.init_restir_state(h, w, "cpu")
    with tracing.recording() as rec:
        for f in range(2):
            want, jstate = step(js, jc, cfg, jrng.make_frame_seed(0, f),
                                jstate, jnp.asarray(f))
            got, tstate = tpipe.restir_step(ts, tc, cfg,
                                            trng.make_frame_seed(0, f),
                                            tstate, f)
            want, got = np.asarray(want), got.numpy()
            pix = want.mean(-1)
            stderr = pix.std() / np.sqrt(pix.size)
            assert np.isfinite(got).all() and want.mean() > 0.1
            assert abs(got.mean() - want.mean()) <= stderr
    log = tintersect.queries(rec)
    assert {e["backend"] for e in log} == {"ptrace"} and len(log) == 56
    want_res = jax.tree.map(np.asarray, jstate.res_prev)
    same = (np.abs(tstate.res_prev.sample.point.numpy()
                   - want_res.sample.point).max(-1) <= 1e-4) \
        & (tstate.res_prev.sample.valid.numpy() == want_res.sample.valid)
    assert 1.0 - same.mean() < MAX_DIFF_SHARE
