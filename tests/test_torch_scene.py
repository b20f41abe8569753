"""Parity of the port's scene, camera, lights and G-buffer BRDF with the
JAX package, on the CPU.

Tolerances: scene arrays built on the host (Woop rows, CDF, material
table, vertices) are exact, since both packages build them with the same
numpy code; camera rays and light points are float32 chains with
transcendental functions, compared at rtol 1e-5 / atol 1e-6; BRDF values
and samples at rtol 1e-4, since the Phong lobe cos^120 multiplies a
one-ulp difference of the cosine by 120; pixel coordinates of
reprojection, light picks and vertex types are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import rng as jrng
from tpu_restir.config import CameraConfig
from tpu_restir.render import brdf as jbrdf
from tpu_restir.render import camera as jcam
from tpu_restir.render.integrators.restir.gbuffer import GBuffer as JGBuffer
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir.scene import lights as jlights
from tpu_restir_torch import convert
from tpu_restir_torch.render import brdf as tbrdf
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.render.integrators.restir.gbuffer import GBuffer
from tpu_restir_torch.scene import cornell as tcornell
from tpu_restir_torch.scene import lights as tlights
from tpu_restir_torch.scene.materials import MaterialSpec
from tpu_restir_torch.scene.scene import SceneArrays, build_scene

TOL = dict(rtol=1e-5, atol=1e-6)
CCFG = CameraConfig(width=40, height=24, fov_y_deg=45.0,
                    view_from=(0.0, -3.9, 1.0), view_at=(0.0, 0.0, 1.0),
                    pixel_sampler="random")


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _assert_tree_equal(port, ref, path=""):
    """Port dict (convert.to_numpy) against the JAX object, field by field."""
    for name, val in port.items():
        want = getattr(ref, name)
        if isinstance(val, dict):
            _assert_tree_equal(val, want, f"{path}{name}.")
        elif isinstance(val, np.ndarray):
            np.testing.assert_array_equal(val, np.asarray(want),
                                          err_msg=path + name)
        else:
            assert val == want, path + name


@pytest.mark.parametrize("glossy", [False, True])
def test_cornell_box_field_by_field(glossy):
    js = j_cornell_box(glossy_box=glossy)
    ts = tcornell.cornell_box("cpu", glossy_box=glossy)
    assert ts.num_tris == js.num_tris == 36
    _assert_tree_equal(convert.to_numpy(ts), js)
    assert ts.materials.types_present == js.materials.types_present


def test_convert_scene_round_trip():
    js = j_cornell_box()
    ts = convert.from_tree(SceneArrays, _np_tree(js), "cpu")
    _assert_tree_equal(convert.to_numpy(ts), js)
    assert ts.tri_mat.dtype == torch.int32
    assert ts.lights.tri_idx.dtype == torch.int32


def test_build_scene_refuses_large_scenes():
    v = np.random.default_rng(0).random((65, 3, 3)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        build_scene(v, np.zeros(65, np.int32), [MaterialSpec()], "cpu")


def test_camera_and_rays():
    jc = jcam.make_camera(CCFG)
    tc = tcam.make_camera(CCFG, "cpu")
    for f in ("pos", "view_at", "view_mat", "inv_view_dir", "focal"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    tc2 = convert.from_tree(tcam.Camera, _np_tree(jc), "cpu")
    np.testing.assert_array_equal(tc2.view_mat.numpy(), tc.view_mat.numpy())
    ys, xs = np.meshgrid(np.arange(24), np.arange(40), indexing="ij")
    seed = jrng.make_frame_seed(5, 2)
    jo, jd = jcam.generate_rays_at(jc, CCFG, seed, jnp.asarray(ys),
                                   jnp.asarray(xs))
    to, td = tcam.generate_rays_at(tc, CCFG, int(np.asarray(seed)),
                                   torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)

    # reprojection of points inside the box: integer pixels exact
    p = np.random.default_rng(1).uniform([-1, -1, 0], [1, 1, 2], (512, 3)) \
        .astype(np.float32)
    want = jcam.project_to_screen(jc.view_mat, jc.focal, 40, 24,
                                  jnp.asarray(p))
    got = tcam.project_to_screen(tc.view_mat, tc.focal, 40, 24,
                                 torch.from_numpy(p))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_light_sampling():
    js = j_cornell_box()
    ts = tcornell.cornell_box("cpu")
    u3 = np.random.default_rng(2).random((30, 20, 3), dtype=np.float32)
    u3[0, 0, 0] = 0.0
    u3[0, 1, 0] = 1.0
    want = jlights.light_point_from_uniforms(jnp.asarray(u3), js)
    got = tlights.light_point_from_uniforms(torch.from_numpy(u3), ts)
    np.testing.assert_array_equal(got["tri"].numpy(), np.asarray(want["tri"]))
    for k in ("point", "normal", "l_i", "pdf_area"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    np.testing.assert_array_equal(
        tlights.pick_light_index(torch.from_numpy(u3[..., 0]),
                                 ts.lights).numpy(),
        np.asarray(jlights.pick_light_index(jnp.asarray(u3[..., 0]),
                                            js.lights)))


def _random_gbuffer(g, shape, mat_types):
    """A G-buffer of random surfaces seen from a camera, as numpy fields."""
    n = int(np.prod(shape))
    normal = g.standard_normal((n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    cam_pos = np.array([0.0, -3.9, 1.0], np.float32)
    pos = g.uniform([-1, -1, 0], [1, 1, 2], (n, 3)).astype(np.float32)
    # flip normals toward the camera, as the G-buffer fill does
    normal *= np.sign(np.sum((cam_pos - pos) * normal, -1, keepdims=True))
    fields = dict(
        pos=pos, normal=normal,
        diffuse=g.uniform(0, 0.8, (n, 3)).astype(np.float32),
        specular=g.uniform(0, 0.5, (n, 3)).astype(np.float32),
        emission=np.zeros((n, 3), np.float32),
        shininess=g.choice([1.0, 10.0, 120.0], n).astype(np.float32),
        depth=np.ones(n, np.float32),
        mat_type=g.choice(mat_types, n).astype(np.int32),
        inv_i_m=None)
    out = {k: (v.reshape(shape + v.shape[1:]) if v is not None else None)
           for k, v in fields.items()}
    out.update(cam_pos=cam_pos, view_mat=np.eye(4, dtype=np.float32),
               focal=np.float32(30.0))
    return out


def test_gbuffer_brdf_api():
    from tpu_restir.mathx.special import calc_i_m

    g = np.random.default_rng(3)
    shape = (16, 32)
    f = _random_gbuffer(g, shape, [1, 2])       # LAMBERT and PHONG
    v = f["cam_pos"] - f["pos"]
    n_dot_v = np.sum(v / np.linalg.norm(v, axis=-1, keepdims=True)
                     * f["normal"], -1)
    f["inv_i_m"] = np.asarray(1.0 / calc_i_m(jnp.asarray(n_dot_v),
                                             jnp.asarray(f["shininess"])))
    jgb = JGBuffer(**{k: jnp.asarray(x) for k, x in f.items()})
    tgb = GBuffer(**{k: torch.from_numpy(np.array(x))
                     for k, x in f.items()})
    wi = g.standard_normal(shape + (3,)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    u5 = g.random(shape + (5,), dtype=np.float32)
    np.testing.assert_allclose(
        tbrdf.gbuf_eval_brdf(tgb, torch.from_numpy(wi)).numpy(),
        np.asarray(jbrdf.gbuf_eval_brdf(jgb, jnp.asarray(wi))),
        rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        tbrdf.gbuf_eval_pdf(tgb, torch.from_numpy(wi)).numpy(),
        np.asarray(jbrdf.gbuf_eval_pdf(jgb, jnp.asarray(wi))),
        rtol=1e-4, atol=1e-6)
    want = jbrdf.gbuf_sample_brdf_u(jnp.asarray(u5), jgb)
    got = tbrdf.gbuf_sample_brdf_u(torch.from_numpy(u5), tgb)
    for k in ("omega_i", "f_r", "pdf"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got.vtype.numpy(), np.asarray(want.vtype))
    assert dataclasses.is_dataclass(got)
