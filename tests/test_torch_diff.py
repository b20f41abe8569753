"""The port's differentiable ReSTIR frame (tpu_restir_torch.diff) against
the JAX package's (tpu_restir.diff), on the CPU, plus the JAX package's
own gradient oracles run on the port.

Each JAX reference is computed once per module. Tolerances:
  * smooth config (16x16, m_area=1, m_brdf=0, seeds (0, 1); one candidate,
    no reservoir decision depends on the parameters): loss at rtol 1e-5,
    gradients at rtol 1e-4 plus 1e-6 of each field's largest entry (the
    two packages round sin, pow and the float32 sums otherwise);
  * bench config (32x16, m_area=1, m_brdf=1, temporal, 5-neighbour
    pairwise spatial, seed 1 from a fresh state): rtol 1e-3 plus 1e-3 of
    each field's largest entry, looser because one rounding can flip a
    pixel's reservoir decision, which moves that pixel's whole term;
  * apply_params: exact (ties split the cotangent 0.5/0.5 in both);
  * glossy box (16x16, m_area=1, m_brdf=1): as the smooth config, on the
    entries where the JAX gradient is finite. The JAX reference is NaN on
    the glossy material's row: its BRDF candidate weight
    1/max(pdf, 1e-30) has an infinite derivative on the pixels where the
    pdf is 0, which jnp.maximum's backward multiplies by 0 (NaN), where
    torch.maximum's masks it.
The JAX reference runs its CPU intersection backend (a matmul form of the
same Woop test); the port's closest hit takes the analytic derivative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import config as jc
from tpu_restir.diff.params import apply_params as j_apply
from tpu_restir.diff.params import extract_params as j_extract
from tpu_restir.diff.render import loss_fn as j_loss
from tpu_restir.render import camera as jcam
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir_torch import config as tc
from tpu_restir_torch import convert
from tpu_restir_torch.diff.optimize import optimize_materials
from tpu_restir_torch.diff.params import (ALL_FIELDS, DEFAULT_FIELDS,
                                          apply_params, extract_params)
from tpu_restir_torch.diff.render import (make_value_and_grad,
                                          render_with_params)
from tpu_restir_torch.kernels import ray_tri as trt
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.scene.cornell import cornell_box as t_cornell_box
from tpu_restir_torch.scene.textures import build_texture_stack

GLOSSY_VIEW = ((-0.2, -2.0, 1.9), (-0.35, 0.3, 1.0))


def _cfg(mod, w, h, restir, sampler="center", view=((0, -3.9, 1.0),
                                                    (0, 0, 1.0))):
    return mod.RenderConfig(
        camera=mod.CameraConfig(width=w, height=h, fov_y_deg=45.0,
                                view_from=view[0], view_at=view[1],
                                pixel_sampler=sampler),
        params=mod.RenderParams(use_skybox=False),
        restir=mod.RestirParams(**restir), integrator="restir")


SMOOTH = dict(m_area=1, m_brdf=0)
BENCH = dict(m_area=1, m_brdf=1, do_temporal_reuse=True,
             do_spatial_reuse=True, spatial_neighbor_count=5,
             spatial_mis="pairwise")
GLOSSY = dict(m_area=1, m_brdf=1)


def _case(w, h, restir, seeds, sampler="center", glossy=False,
          view=((0, -3.9, 1.0), (0, 0, 1.0)), shininess=None):
    """JAX and port value_and_grad of the loss against a constant target,
    w.r.t. all four default fields."""
    jcfg = _cfg(jc, w, h, restir, sampler, view)
    tcfg = _cfg(tc, w, h, restir, sampler, view)
    js, ts = j_cornell_box(glossy_box=glossy), t_cornell_box(
        "cpu", glossy_box=glossy)
    target = np.full((h, w, 3), 0.1, np.float32)
    jp = j_extract(js)
    if shininess is not None:
        jp["shininess"] = jnp.asarray(shininess, jnp.float32)
    jv, jg = jax.value_and_grad(j_loss)(jp, js, jcam.make_camera(jcfg.camera),
                                        jcfg, seeds, jnp.asarray(target))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    vg = make_value_and_grad(ts, tcam.make_camera(tcfg.camera, "cpu"), tcfg,
                             seeds, torch.from_numpy(target))
    tv, tg = vg(tp)
    return (float(jv), jax.tree.map(np.asarray, jg), float(tv),
            convert.params_to_numpy(tg))


def _assert_grads_close(want, got, rtol, scale_tol, only_finite=False):
    assert sorted(want) == sorted(got) == sorted(DEFAULT_FIELDS)
    for k in want:
        w, g = want[k], got[k]
        assert np.isfinite(g).all(), k
        keep = np.isfinite(w) if only_finite else np.ones(w.shape, bool)
        assert only_finite or keep.all(), k
        scale = float(np.abs(w[keep]).max()) if keep.any() else 0.0
        np.testing.assert_allclose(g[keep], w[keep], rtol=rtol,
                                   atol=scale_tol * scale + 1e-12,
                                   err_msg=k)


@pytest.fixture(scope="module")
def smooth():
    return _case(16, 16, SMOOTH, (0, 1))


@pytest.fixture(scope="module")
def bench():
    return _case(32, 16, BENCH, (1,), sampler="random")


def test_smooth_value_and_grad_match_jax(smooth):
    jv, jg, tv, tg = smooth
    assert np.isclose(tv, jv, rtol=1e-5)
    _assert_grads_close(jg, tg, 1e-4, 1e-6)
    assert np.abs(tg["diffuse"]).max() > 0 and np.abs(tg["emission"]).max() > 0


def test_bench_value_and_grad_match_jax(bench):
    jv, jg, tv, tg = bench
    assert np.isclose(tv, jv, rtol=1e-4)
    _assert_grads_close(jg, tg, 1e-3, 1e-3)
    # the Cornell box has no specular lobe: only the clip's tie at 0
    # (specular = 0 on every material) carries a cotangent there
    assert np.abs(tg["diffuse"]).max() > 0


def test_glossy_value_and_grad_match_jax_and_cross_k1_backward(monkeypatch):
    """The glossy box seen from above, its shininess lowered to 2 so that
    lobe samples reach the light: the shininess gradient crosses K1's
    backward (the BRDF candidate's hit point moves with the sampled
    direction)."""
    shin = np.array([1, 1, 1, 1, 2, 1], np.float32)
    jv, jg, tv, tg = _case(16, 16, GLOSSY, (0, 1), glossy=True,
                           view=GLOSSY_VIEW, shininess=shin)
    assert np.isclose(tv, jv, rtol=1e-5)
    _assert_grads_close(jg, tg, 1e-4, 1e-6, only_finite=True)
    assert np.isfinite(jg["diffuse"][[0, 1, 2, 3, 5]]).all()

    assert tg["shininess"][4] != 0.0

    # over 8 frames, the shininess gradient with K1's backward zeroed
    # differs from the full one
    ts = t_cornell_box("cpu", glossy_box=True)
    cfg = _cfg(tc, 16, 16, GLOSSY, view=GLOSSY_VIEW)
    vg = make_value_and_grad(ts, tcam.make_camera(cfg.camera, "cpu"), cfg,
                             tuple(range(8)), torch.full((16, 16, 3), 0.1))
    p = extract_params(ts, ("shininess",))
    with torch.no_grad():
        p["shininess"].copy_(torch.from_numpy(shin))
    g_full = float(vg(p)[1]["shininess"][4])
    bwd = trt.closest_hit_bwd
    monkeypatch.setattr(trt, "closest_hit_bwd", lambda *a: tuple(
        torch.zeros_like(x) for x in bwd(*a)))
    g_no_k1 = float(vg(p)[1]["shininess"][4])
    assert g_full != 0.0 and abs(g_no_k1 - g_full) > 1e-4 * abs(g_full)


def test_apply_params_tie_gradients_match_jax():
    """Bounds hit exactly (diffuse 0 and 1, specular 0, emission 0,
    shininess 0) split the cotangent 0.5/0.5, as jnp.clip/jnp.maximum."""
    js, ts = j_cornell_box(), t_cornell_box("cpu")
    g = np.random.default_rng(0)
    vals = {k: np.array(v) for k, v in j_extract(js).items()}
    vals["diffuse"][0] = [0.0, 1.0, 0.5]
    vals["shininess"][2] = 0.0
    wts = {k: g.standard_normal(v.shape).astype(np.float32)
           for k, v in vals.items()}

    def jf(p):
        m = j_apply(js, p).materials
        return sum(jnp.sum(getattr(m, k) * wts[k]) for k in p)

    want = jax.grad(jf)({k: jnp.asarray(v) for k, v in vals.items()})
    p = convert.params_from_numpy(vals, "cpu")
    m = apply_params(ts, p).materials
    got = torch.autograd.grad(
        sum((getattr(m, k) * torch.from_numpy(wts[k])).sum() for k in p),
        list(p.values()))
    for k, gk in zip(p, got):
        np.testing.assert_array_equal(gk.numpy(), np.asarray(want[k]))
    assert float(got[list(p).index("emission")][0, 0]) \
        == 0.5 * float(wts["emission"][0, 0])


def test_params_fields_and_integrators_not_ported_raise():
    ts = t_cornell_box("cpu")
    assert set(DEFAULT_FIELDS) < set(ALL_FIELDS)
    # roughness and the texels, once refused, extract and render; the
    # texels need a texture stack
    with pytest.raises(ValueError, match="no texture stack"):
        extract_params(ts, ("tex_data",))
    with pytest.raises(ValueError, match="unknown parameter field"):
        extract_params(ts, ("albedo",))
    textured = dataclasses.replace(ts, textures=build_texture_stack(
        [np.full((4, 4, 3), 0.5, np.float32)], "cpu"))
    p = extract_params(textured, ("roughness", "tex_data"))
    assert p["tex_data"].shape == (1, 4, 4, 3)
    assert p["roughness"].shape == (ts.materials.count,)
    cfg = _cfg(tc, 8, 8, SMOOTH)
    img = render_with_params(p, textured, tcam.make_camera(cfg.camera, "cpu"),
                             cfg, (0,))
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    # the naive and NEE path tracers, once refused, render
    cfg = _cfg(tc, 8, 8, SMOOTH).replace(integrator="nee")
    img = render_with_params(extract_params(ts), ts,
                             tcam.make_camera(cfg.camera, "cpu"), cfg, (0,))
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    p = extract_params(ts)
    assert all(v.requires_grad and v.is_leaf for v in p.values())
    assert p["diffuse"].data_ptr() != ts.materials.diffuse.data_ptr()


def _port_smooth():
    ts = t_cornell_box("cpu")
    cfg = _cfg(tc, 16, 16, SMOOTH)
    return ts, cfg, tcam.make_camera(cfg.camera, "cpu")


def test_grad_matches_finite_differences():
    """The port of tests/test_diff.py's oracle: d(loss)/d(albedo) by
    autograd vs central differences with common random numbers (one
    candidate per pixel, so no reservoir decision flips between them)."""
    ts, cfg, cam = _port_smooth()
    seeds = (0, 1)
    target = torch.zeros((16, 16, 3))
    params = extract_params(ts, ("diffuse",))
    loss, grads = make_value_and_grad(ts, cam, cfg, seeds, target)(params)
    g = grads["diffuse"].numpy()
    assert np.isfinite(float(loss)) and np.isfinite(g).all()
    checked = 0
    eps = 3e-3
    for mat in (0, 1, 3):
        for ch in range(3):
            if abs(g[mat, ch]) < 1e-7:
                continue
            vals = []
            for sign in (1.0, -1.0):
                d = params["diffuse"].detach().clone()
                d[mat, ch] += sign * eps
                with torch.no_grad():
                    img = render_with_params({"diffuse": d}, ts, cam, cfg,
                                             seeds).double()
                vals.append(float(torch.mean(img ** 2)))
            fd = (vals[0] - vals[1]) / (2 * eps)
            assert np.isclose(fd, g[mat, ch], rtol=0.08, atol=1e-5), \
                (mat, ch, fd, g[mat, ch])
            checked += 1
    assert checked >= 3


def test_emission_gradient_direction():
    """Brightening the light raises the mean image (tests/test_diff.py)."""
    ts = t_cornell_box("cpu")
    cfg = _cfg(tc, 16, 16, dict(m_area=4, m_brdf=0))
    cam = tcam.make_camera(cfg.camera, "cpu")
    p = extract_params(ts, ("emission",))
    (g,) = torch.autograd.grad(
        render_with_params(p, ts, cam, cfg, (0,)).mean(), [p["emission"]])
    g = g.numpy()
    assert float(g[3].sum()) > 0.0
    assert (g >= -1e-8).all()


def test_optimize_recovers_albedo():
    """Inverse rendering (tests/test_diff.py): recover the white albedo
    from a perturbed start by Adam against the original render."""
    ts = t_cornell_box("cpu")
    cfg = _cfg(tc, 16, 16, dict(m_area=4, m_brdf=0))
    cam = tcam.make_camera(cfg.camera, "cpu")
    with torch.no_grad():
        target = render_with_params(extract_params(ts, ("diffuse",)), ts,
                                    cam, cfg, (5, 6))
        wrong = ts.materials.diffuse.clone()
        wrong[0] = torch.tensor([0.3, 0.5, 0.4])
        ts_wrong = dataclasses.replace(ts, materials=dataclasses.replace(
            ts.materials, diffuse=wrong))
    params, hist = optimize_materials(ts_wrong, cam, cfg, target,
                                      fields=("diffuse",), n_steps=60,
                                      lr=0.06, frames_per_step=1, seed0=5)
    assert hist[-1] < hist[0] * 0.25, hist[::10]
    got = params["diffuse"][0].numpy()
    assert np.allclose(got, [0.73, 0.73, 0.73], atol=0.12), got


def test_params_round_trip_through_convert():
    vals = {k: np.asarray(v) for k, v in j_extract(j_cornell_box()).items()}
    p = convert.params_from_numpy(vals, "cpu")
    assert all(v.requires_grad and v.dtype == torch.float32
               for v in p.values())
    back = convert.params_to_numpy(p)
    for k in vals:
        np.testing.assert_array_equal(back[k], vals[k])
