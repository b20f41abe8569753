"""The port's naive and NEE path tracers on clustered scenes, every query
through the clustered traversal (ptrace: phase 1 and the plain versions of
K5/K6), against the JAX package's frames through its own ptrace (the
Pallas kernels in the interpreter, as tests/test_ptrace.py runs them), at
16x12 on the CPU.

Scenes: terrain_scene(2_000) (2,050 triangles in 33 clusters of 64, the
bench's terrain camera) and many_lights_scene(300) (334 triangles in 6
clusters, the Cornell camera); and the terrain at a supercluster factor of
5, SUPER_MAX lowered to 8 in both packages, so that 33 clusters make 7
superclusters whose last one repeats cluster 32 twice (the clamp of the
slot map). Both packages are forced to `IntersectorConfig(backend=
"ptrace")`.

Both packages draw the same threefry numbers, so a frame is held pixel by
pixel as tests/test_torch_integrators.py holds the Cornell frames: allclose
at rtol 1e-4, atol 1e-5 on at least 99% of the pixels. The JAX frame runs
op by op (jax.disable_jit()) but for its intersection queries, which are
jitted: the Pallas interpreter op by op takes minutes a frame, a jitted
whole NEE frame 10-25 s to compile. The port's side also checks its
traced rays per pixel against chip_smoke.path_rays_per_pixel and that
every logged query went to ptrace.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_restir import config as jc
from tpu_restir import rng as jrng
from tpu_restir.kernels import cluster_trace as jct
from tpu_restir.render import camera as jcam
from tpu_restir.render import intersect as jintersect
from tpu_restir.render.integrators import render_naive as j_naive
from tpu_restir.render.integrators import render_nee as j_nee
from tpu_restir.scene.cornell import many_lights_scene as j_lights
from tpu_restir.scene.procedural import terrain_scene as j_terrain
from tpu_restir_torch import config as tc
from tpu_restir_torch import rng, tracing
from tpu_restir_torch.kernels import cluster_trace as tct
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.render import intersect
from tpu_restir_torch.render.integrators import render_naive, render_nee
from tpu_restir_torch.scene.cornell import many_lights_scene as t_lights
from tpu_restir_torch.scene.procedural import terrain_scene as t_terrain

W, H = 16, 12
TOL = dict(rtol=1e-4, atol=1e-5)     # as tests/test_torch_integrators.py
MIN_SHARE = 0.99
SMALL_SUPER_MAX = 8                  # 33 clusters -> factor 5
TERRAIN_VIEW = ((0.0, -7.0, 4.0), (0.0, 0.0, 0.5))
CORNELL_VIEW = ((0.0, -3.9, 1.0), (0.0, 0.0, 1.0))

_SCENE_FNS = {
    "terrain2k": (lambda: j_terrain(2_000), lambda: t_terrain("cpu", 2_000),
                  TERRAIN_VIEW),
    "lights300": (lambda: j_lights(300), lambda: t_lights("cpu", 300),
                  CORNELL_VIEW),
}
_BUILT = {}
_JITTED = {}


def _scenes(name):
    """(JAX scene, port scene, view), built once per test process."""
    if name not in _BUILT:
        j, t, view = _SCENE_FNS[name]
        _BUILT[name] = (j(), t(), view)
    return _BUILT[name]


@pytest.fixture
def jax_queries(monkeypatch):
    """The JAX package's Pallas kernels in the interpreter, and its two
    query functions jitted inside the op-by-op frame: one jitted pair per
    SUPER_MAX, since the factor is read while a query is traced."""
    monkeypatch.setattr(jct, "INTERPRET", True)

    def install():
        key = jct.SUPER_MAX
        if key not in _JITTED:
            closest, occlusion = (jintersect.intersect_closest,
                                  jintersect.test_occlusion)
            _JITTED[key] = (
                jax.jit(lambda *a: closest(*a), static_argnums=(5,)),
                jax.jit(lambda *a: occlusion(*a), static_argnums=(3, 4)))
        jclosest, jocclusion = _JITTED[key]

        def enabled(fn):
            def call(*args):
                with jax.disable_jit(False):
                    return fn(*args)
            return call

        monkeypatch.setattr(jintersect, "intersect_closest",
                            enabled(jclosest))
        monkeypatch.setattr(jintersect, "test_occlusion",
                            enabled(jocclusion))
    return install


def _cfg(mod, integrator, view, **kw):
    return mod.RenderConfig(
        camera=mod.CameraConfig(width=W, height=H, fov_y_deg=45.0,
                                view_from=view[0], view_at=view[1],
                                pixel_sampler="random"),
        params=mod.RenderParams(use_skybox=False, max_bounce_count=3),
        intersector=mod.IntersectorConfig(backend="ptrace"),
        integrator=integrator, **kw)


STRATEGIES = [("naive", {})] + [
    ("nee", dict(direct_strategy=s)) for s in ("area", "brdf", "mis")] + [
    ("nee", dict(direct_strategy="ris", ris_candidates=4))]
CASES = [(scene, integ, kw, None) for scene in ("terrain2k", "lights300")
         for integ, kw in STRATEGIES]
CASES.append(("terrain2k", "nee", dict(direct_strategy="mis"),
              SMALL_SUPER_MAX))


def _id(case):
    scene, integ, kw, super_max = case
    name = f"{scene}-{kw.get('direct_strategy', integ)}"
    return name + (f"-supermax{super_max}" if super_max else "")


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_clustered_frame_matches_jax(case, jax_queries, monkeypatch):
    scene_name, integ, kw, super_max = case
    js, ts, view = _scenes(scene_name)
    c = ts.cluster_tris.shape[0]
    if super_max:
        monkeypatch.setattr(jct, "SUPER_MAX", super_max)
        monkeypatch.setattr(tct, "SUPER_MAX", super_max)
        assert jct.pick_factor(c) == tct.pick_factor(c) == 5
        assert -(-c // 5) * 5 - c == 2   # the last supercluster: 32, 32, 32
    jax_queries()
    factors = set()
    pack = tct.pack

    def recording_pack(*args):
        factors.add(args[-1])
        return pack(*args)

    monkeypatch.setattr(tct, "pack", recording_pack)
    jcfg, tcfg = _cfg(jc, integ, view, **kw), _cfg(tc, integ, view, **kw)
    jfn, tfn = ((j_naive, render_naive) if integ == "naive"
                else (j_nee, render_nee))
    with jax.disable_jit():
        want = np.asarray(jfn(js, jcam.make_camera(jcfg.camera), jcfg,
                              jrng.frame_key(0, 5)))
    with tracing.recording() as rec:
        got = tfn(ts, tcam.make_camera(tcfg.camera, "cpu"), tcfg,
                  rng.frame_key(0, 5))
    log = intersect.queries(rec)
    assert tuple(got.shape) == (H, W, 3) and torch.isfinite(got).all()
    share = float(np.isclose(got.numpy(), want, **TOL).all(-1).mean())
    assert share >= MIN_SHARE, share
    assert want.mean() > 0.05
    assert {e["backend"] for e in log} == {"ptrace"}
    assert sum(e["rays"] for e in log) \
        == chip_smoke.path_rays_per_pixel(tcfg) * W * H
    assert factors == {5 if super_max else 1}
