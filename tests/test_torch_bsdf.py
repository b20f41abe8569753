"""The port's BSDF instance API (sample_bsdf, eval_bsdf, pdf_bsdf), the
mathx functions it calls, and the direct-lighting strategies of the NEE
path tracer, against the JAX package's on the CPU.

The BSDF cases are synthetic: material columns of all eight types
(NORMAL through TS, UNSUPPORTED included, and a TS with roughness 1, the
alpha == 1 quirk), random shading frames, incident directions from both
sides, from_inside both ways, and one key for both packages, so both draw
the same uniforms. The vertex type, and with it every branch a draw picks
(the Phong lobe, reflect or refract), is exact; directions, values and
pdfs agree at rtol 1e-5, atol 1e-6 (XLA and PyTorch round sin, cos and
pow otherwise), except that a value or pdf with a Phong lobe c^s, whose
relative error is s times that of c, takes rtol 5e-7 * s where that is
larger (6e-5 at the glossy box's s = 120).

The direct-lighting strategies take the JAX hit wavefront of a 16x12
Cornell frame (Lambert, and the glossy box's Phong) and trace their own
shadow and BSDF rays: rtol 1e-4, atol 1e-5 (the JAX package intersects
with its CPU backend, a matmul form of the same Woop test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import config as jc
from tpu_restir import mathx as jmathx
from tpu_restir import rng as jrng
from tpu_restir.render import brdf as jbrdf
from tpu_restir.render import camera as jcam
from tpu_restir.render import intersect as jintersect
from tpu_restir.render.integrators import direct as jdirect
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir.scene import materials as jmat
from tpu_restir_torch import config as tc
from tpu_restir_torch import mathx, rng
from tpu_restir_torch.render import brdf
from tpu_restir_torch.render.integrators import direct
from tpu_restir_torch.scene import materials as tmat
from tpu_restir_torch.scene.cornell import cornell_box as t_cornell_box
from tpu_restir_torch.scene.materials import MatType, VertexType

TOL = dict(rtol=1e-5, atol=1e-6)
N_PER_MAT = 96


def _assert_close(got, want, batch, name, lobe_rtol=True):
    """got == want at TOL, the rtol raised to 5e-7 * shininess per ray on
    the materials with a Phong lobe (PHONG, DIELECTRIC)."""
    got, want = got.numpy(), np.asarray(want)
    rtol = np.full(batch["mat_id"].shape, TOL["rtol"], np.float32)
    if lobe_rtol:
        shin = np.array([s.shininess for s in _specs(jmat, 0)],
                        np.float32)[batch["mat_id"]]
        lobe = np.isin(batch["mat_id"], [MatType.PHONG, MatType.DIELECTRIC])
        rtol = np.where(lobe, np.maximum(rtol, 5e-7 * shin), rtol)
    if got.ndim == rtol.ndim + 1:
        rtol = rtol[..., None]
    bad = np.abs(got - want) > TOL["atol"] + rtol * np.abs(want)
    assert not bad.any(), (name, int(bad.sum()), got[bad], want[bad])


def _specs(mod, seed):
    """One material per type, NORMAL..TS, then a TS of roughness 1."""
    g = np.random.default_rng(seed)

    def c3(lo, hi):
        return tuple(float(x) for x in g.uniform(lo, hi, 3))

    out = []
    for t in list(range(8)) + [MatType.TS]:
        out.append(mod.MaterialSpec(
            name=f"m{len(out)}", mat_type=t, diffuse=c3(0.05, 0.7),
            specular=c3(0.05, 0.5), emission=(0.0, 0.0, 0.0),
            shininess=float(g.uniform(1.0, 120.0)),
            ior=float(g.uniform(1.2, 1.8)),
            roughness=1.0 if len(out) == 8 else float(g.uniform(0.1, 0.9)),
            attenuation=c3(0.0, 2.0)))
    return out


def _unit(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _make_batch():
    """Rays over all nine materials: shading normal n, incident d (into
    the surface on ~85%, grazing from behind on the rest), from_inside
    and dst, in numpy."""
    g = np.random.default_rng(3)
    n_mat = len(_specs(jmat, 0))
    mat_id = np.repeat(np.arange(n_mat, dtype=np.int32), N_PER_MAT)
    g.shuffle(mat_id)
    n = _unit(g, mat_id.size)
    d = _unit(g, mat_id.size)
    cos = np.sum(d * n, -1, keepdims=True)
    flip = g.uniform(size=(mat_id.size, 1)) < 0.85
    d = np.where(flip & (cos > 0), d - 2 * cos * n, d).astype(np.float32)
    return dict(mat_id=mat_id, n=n, d=d,
                from_inside=g.uniform(size=mat_id.size) < 0.5,
                dst=g.uniform(0.1, 3.0, mat_id.size).astype(np.float32),
                omega_i=_unit(g, mat_id.size))


@pytest.fixture(scope="module")
def batch():
    return _make_batch()


def _both(batch):
    jm = jmat.gather_materials(jmat.build_material_table(_specs(jmat, 0)),
                               jnp.asarray(batch["mat_id"]))
    tm = tmat.gather_materials(
        tmat.build_material_table(_specs(tmat, 0), "cpu"),
        torch.from_numpy(batch["mat_id"]))
    j = {k: jnp.asarray(v) for k, v in batch.items() if k != "mat_id"}
    t = {k: torch.from_numpy(v) for k, v in batch.items() if k != "mat_id"}
    return jm, j, tm, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_bsdf_matches_jax(batch, seed):
    jm, j, tm, t = _both(batch)
    with jax.disable_jit():
        want = jbrdf.sample_bsdf(jax.random.key(seed), jm, j["n"], j["d"],
                                 j["from_inside"], j["dst"])
    got = brdf.sample_bsdf(rng.key(seed), tm, t["n"], t["d"],
                           t["from_inside"], t["dst"])
    vt = np.asarray(want.vtype)
    np.testing.assert_array_equal(got.vtype.numpy(), vt)
    # every family's vertex type occurs, so every branch was compared
    types = batch["mat_id"]
    assert set(vt[types == MatType.PHONG]) == {VertexType.DIFFUSE,
                                               VertexType.SPECULAR}
    assert set(vt[types == MatType.TRANSPARENT]) == {VertexType.SPECULAR,
                                                     VertexType.REFRACTIVE}
    assert set(vt[types == MatType.NORMAL]) == {VertexType.INVALID}
    assert set(vt[types == MatType.MIRROR]) == {VertexType.MIRROR}
    np.testing.assert_allclose(got.omega_i.numpy(), np.asarray(want.omega_i),
                               **TOL)
    for name in ("f_r", "pdf"):
        _assert_close(getattr(got, name), getattr(want, name), batch, name)


def test_eval_and_pdf_bsdf_match_jax(batch):
    jm, j, tm, t = _both(batch)
    with jax.disable_jit():
        f_want = jbrdf.eval_bsdf(jm, j["n"], j["d"], j["omega_i"])
        p_want = jbrdf.pdf_bsdf(jm, j["n"], j["d"], j["omega_i"])
    f_got = brdf.eval_bsdf(tm, t["n"], t["d"], t["omega_i"])
    p_got = brdf.pdf_bsdf(tm, t["n"], t["d"], t["omega_i"])
    _assert_close(f_got, f_want, batch, "f")
    _assert_close(p_got, p_want, batch, "pdf")
    # delta and base materials evaluate to 0; the others mostly do not
    zero = np.isin(batch["mat_id"], [MatType.NORMAL, MatType.MIRROR,
                                     MatType.TRANSPARENT,
                                     MatType.UNSUPPORTED])
    f, p = f_got.numpy(), p_got.numpy()
    assert (f[zero] == 0).all() and (p[zero] == 0).all()
    assert (f[~zero] > 0).any(axis=-1).mean() > 0.9


def test_mathx_refract_schlick_power_heuristic_match_jax():
    g = np.random.default_rng(5)
    i, n = _unit(g, 512), _unit(g, 512)
    eta = g.uniform(0.5, 1.8, 512).astype(np.float32)   # TIR on some rays
    ior1, ior2 = (g.uniform(1.0, 2.0, 512).astype(np.float32)
                  for _ in range(2))
    f0 = g.uniform(0.0, 0.5, (512, 3)).astype(np.float32)
    p, q = (np.where(g.uniform(size=512) < 0.2, 0.0,
                     g.uniform(0, 5, 512)).astype(np.float32)
            for _ in range(2))
    T = torch.from_numpy
    pairs = [
        (mathx.refract(T(i), T(n), T(eta)), jmathx.refract(i, n, eta)),
        (mathx.schlick(T(i), T(n), T(ior1), T(ior2)),
         jmathx.schlick(i, n, ior1, ior2)),
        (mathx.schlick_f0(T(i), T(n), T(f0)), jmathx.schlick_f0(i, n, f0)),
        (mathx.power_heuristic(T(p), T(q)), jmathx.power_heuristic(p, q))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    refr = pairs[0][0].numpy()
    assert (refr == 0).all(-1).any() and not (refr == 0).all(-1).all()


def test_mathx_ties_split_the_gradient_as_jax():
    """At cos_t == 0 (schlick, schlick_f0) and k == 0 (refract's
    max(k, 0)), the cotangent splits 0.5/0.5 as jnp.maximum's."""
    n = np.array([[0.0, 0.0, 1.0]], np.float32)
    i = np.array([[1.0, 0.0, 0.0]], np.float32)      # grazing: cos_t == 0
    f0 = np.array([[0.04, 0.5, 0.9]], np.float32)

    def jf(i):
        return jnp.sum(jmathx.schlick_f0(i, n, f0)) \
            + jnp.sum(jmathx.schlick(i, n, 1.0, 1.5))

    want = np.asarray(jax.grad(jf)(jnp.asarray(i)))
    ti = torch.from_numpy(i).requires_grad_(True)
    (torch.sum(mathx.schlick_f0(ti, torch.from_numpy(n), torch.from_numpy(f0)))
     + torch.sum(mathx.schlick(ti, torch.from_numpy(n), 1.0, 1.5))).backward()
    np.testing.assert_allclose(ti.grad.numpy(), want, rtol=1e-6)
    assert want[0, 2] != 0.0

    # eta = 1 / sin: k == 1 - eta^2 (1 - ndi^2) == 0 exactly at ndi == 0.6
    i2 = np.array([[0.8, 0.0, -0.6]], np.float32)
    eta = np.float32(1.25)

    def jr(eta):
        return jnp.sum(jmathx.refract(i2, n, eta))

    want = float(jax.grad(jr)(jnp.asarray(eta)))
    te = torch.tensor(eta, requires_grad=True)
    torch.sum(mathx.refract(torch.from_numpy(i2), torch.from_numpy(n),
                            te)).backward()
    assert np.isclose(float(te.grad), want, rtol=1e-5) or (
        np.isnan(want) and np.isnan(float(te.grad)))


# ---------------------------------------------------------------------------
# direct lighting on the JAX hit wavefront of a Cornell frame
# ---------------------------------------------------------------------------

W, H = 16, 12
STRATEGIES = [("area", False), ("brdf", False), ("mis", False),
              ("ris", False), ("mis", True)]


def _cfg(mod, strategy, show):
    return mod.RenderConfig(
        camera=mod.CameraConfig(width=W, height=H, fov_y_deg=45.0,
                                view_from=(0.0, -3.9, 1.0),
                                view_at=(0.0, 0.0, 1.0),
                                pixel_sampler="random"),
        params=mod.RenderParams(use_skybox=False), integrator="nee",
        direct_strategy=strategy, show_weights=show, ris_candidates=4)


@pytest.fixture(scope="module", params=["cornell", "glossy"])
def wavefront(request):
    glossy = request.param == "glossy"
    js = j_cornell_box(glossy_box=glossy)
    cfg = _cfg(jc, "mis", False)
    p = cfg.params
    with jax.disable_jit():
        o, d = jcam.generate_rays(jcam.make_camera(cfg.camera), cfg.camera,
                                  jrng.frame_key(0, 2))
        hit = jintersect.intersect_closest(js, o, d, p.tnear_offset, jnp.inf,
                                           cfg.intersector)
        hi = jintersect.hit_attributes(js, o, d, hit)
    assert np.asarray(hi.did_hit).mean() > 0.4
    return dict(js=js, ts=t_cornell_box("cpu", glossy_box=glossy),
                point=np.asarray(hi.point), normal=np.asarray(hi.normal),
                d=np.asarray(d), from_inside=np.asarray(hi.from_inside),
                dst=np.asarray(hi.dst), mat_id=np.asarray(hi.mat_id))


@pytest.mark.parametrize("strategy,show", STRATEGIES)
def test_direct_strategies_match_jax(wavefront, strategy, show):
    wf = wavefront
    jcfg, tcfg = _cfg(jc, strategy, show), _cfg(tc, strategy, show)
    jk = jrng.draw_key(jrng.pass_key(jrng.frame_key(0, 2),
                                     jrng.PASS_NEE_DIRECT), 0)
    k = rng.draw_key(rng.pass_key(rng.frame_key(0, 2), rng.PASS_NEE_DIRECT),
                     0)
    js, ts = wf["js"], wf["ts"]
    names = ("point", "normal", "d", "from_inside", "dst")
    with jax.disable_jit():
        jm = jmat.gather_materials(js.materials, jnp.asarray(wf["mat_id"]))
        want = jdirect.calculate_direct(
            strategy, jk, js, jcfg.params, jcfg, *(jnp.asarray(wf[x]) for x
                                                   in names[:2]),
            jm, *(jnp.asarray(wf[x]) for x in names[2:]))
    tm = tmat.gather_materials(ts.materials, torch.from_numpy(wf["mat_id"]))
    got = direct.calculate_direct(
        strategy, k, ts, tcfg.params, tcfg,
        *(torch.from_numpy(wf[x]) for x in names[:2]), tm,
        *(torch.from_numpy(wf[x]) for x in names[2:]))
    want = np.asarray(want)
    assert got.shape == (H, W, 3) and (want > 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    if show:
        assert (want[..., 2] == 0).all() and want[..., :2].max() <= 1.0
