"""Gradients of the port's naive and NEE path tracers w.r.t. the material
table (diffuse, specular, shininess, emission) against the JAX package's
value_and_grad, on the CPU at 16x12 on the glossy-box Cornell scene (its
Phong box makes specular and shininess live), max_bounce_count 2, frame
seeds (0, 1).

The JAX side runs op by op (jax.disable_jit()). Loss at rtol 1e-5;
gradients at rtol 1e-3 plus 1e-3 of each field's largest entry, on the
entries where the JAX gradient is finite: the two packages round sin, pow
and the float32 sums otherwise, and a pixel whose path flips (a lobe pick
on a last-bit difference) moves its whole term. Where a pdf is 0, a
derivative of 1/max(pdf, 1e-30) is infinite; jnp.maximum's backward
multiplies it by 0 (NaN), torch.maximum's masks it, so the port's
gradients must be finite everywhere. NEE's gradient w.r.t. the glossy
box's shininess is such a NaN in JAX; there the port's entry is held to a
central finite difference of its own loss (step 2% of the value,
rtol 2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import config as jc
from tpu_restir.diff.params import extract_params as j_extract
from tpu_restir.diff.render import loss_fn as j_loss
from tpu_restir.render import camera as jcam
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir_torch import config as tc
from tpu_restir_torch import convert
from tpu_restir_torch.diff.params import DEFAULT_FIELDS
from tpu_restir_torch.diff.render import loss_fn, make_value_and_grad
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.scene.cornell import cornell_box

W, H = 16, 12
SEEDS = (0, 1)


def _cfg(mod, integrator):
    return mod.RenderConfig(
        camera=mod.CameraConfig(width=W, height=H, fov_y_deg=45.0,
                                view_from=(0.0, -3.9, 1.0),
                                view_at=(0.0, 0.0, 1.0),
                                pixel_sampler="random"),
        params=mod.RenderParams(use_skybox=False, max_bounce_count=2),
        integrator=integrator)


@pytest.mark.parametrize("integrator", ["naive", "nee"])
def test_value_and_grad_match_jax(integrator):
    jcfg, tcfg = _cfg(jc, integrator), _cfg(tc, integrator)
    js, ts = j_cornell_box(glossy_box=True), cornell_box("cpu",
                                                        glossy_box=True)
    target = np.full((H, W, 3), 0.1, np.float32)
    jp = j_extract(js)
    with jax.disable_jit():
        jv, jg = jax.value_and_grad(j_loss)(
            jp, js, jcam.make_camera(jcfg.camera), jcfg, SEEDS,
            jnp.asarray(target))
    want = jax.tree.map(np.asarray, jg)
    cam = tcam.make_camera(tcfg.camera, "cpu")
    tt = torch.from_numpy(target)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tv, tg = make_value_and_grad(ts, cam, tcfg, SEEDS, tt)(params)
    got = convert.params_to_numpy(tg)
    assert np.isclose(float(tv), float(jv), rtol=1e-5)
    assert sorted(got) == sorted(want) == sorted(DEFAULT_FIELDS)
    for k in DEFAULT_FIELDS:
        g, w = got[k], want[k]
        assert np.isfinite(g).all(), k
        keep = np.isfinite(w)
        assert keep.mean() > 0.5, k
        scale = float(np.abs(np.where(keep, w, g)).max())
        assert scale > 0, k
        np.testing.assert_allclose(g[keep], w[keep], rtol=1e-3,
                                   atol=1e-3 * scale + 1e-12, err_msg=k)
        for idx in zip(*np.nonzero(~keep)):
            fd = _central_difference(params, k, idx, ts, cam, tcfg, tt)
            assert np.isclose(g[idx], fd, rtol=2e-2), (k, idx, g[idx], fd)


def _central_difference(params, field, idx, scene, cam, cfg, target):
    """d loss / d params[field][idx] by a central difference of the port's
    loss, with a step of 2% of the entry."""
    p = {k: v.detach() for k, v in params.items()}
    h = 0.02 * abs(float(p[field][idx]))
    vals = []
    for sign in (1.0, -1.0):
        x = p[field].clone()
        x[idx] += sign * h
        vals.append(float(loss_fn({**p, field: x}, scene, cam, cfg, SEEDS,
                                  target)))
    return (vals[0] - vals[1]) / (2.0 * h)
