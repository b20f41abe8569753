"""The port's denoiser (`tpu_restir_torch.denoise`) against the JAX
package's (`tpu_restir.denoise`), function by function, on the same numpy
inputs at 32x48 to 64x64, on the CPU.

The JAX functions run op by op (`jax.disable_jit()`), so that both sides
round each float32 operation on its own; XLA's exp, pow and sqrt still
round an ulp apart from PyTorch's on ~10% of values, and the filters sum
25 to 49 such weights per pixel: rtol 1e-5, atol 1e-6 (measured: 6e-7).
Jitted, XLA fuses the JAX filter and rewrites it (a division by a
constant becomes a multiplication by its reciprocal, products and sums
are contracted), which moves the reference itself by up to 2.4e-5 of a
value against its eager run; the port is held to the jitted SVGF filter
at rtol 5e-5 for that reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import denoise as jdn
from tpu_restir.config import CameraConfig
from tpu_restir.render import camera as jcam
from tpu_restir.render.integrators.restir.gbuffer import GBuffer as JGBuffer
from tpu_restir_torch import convert
from tpu_restir_torch import denoise as tdn
from tpu_restir_torch.render.integrators.restir.gbuffer import GBuffer

TOL = dict(rtol=1e-5, atol=1e-6)


def _images(seed, h, w):
    """HDR color with fireflies, albedo, unit normals in two regions and
    depth, as float32 numpy arrays."""
    g = np.random.default_rng(seed)
    color = g.gamma(1.5, 0.4, (h, w, 3)).astype(np.float32)
    color[g.random((h, w)) < 0.01] *= 40.0
    albedo = g.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32)
    albedo[:, w // 2:] = (0.7, 0.2, 0.2)
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    normal[h // 2:] = (0.0, 0.6, 0.8)
    normal += g.normal(0.0, 0.02, normal.shape).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = (2.0 + g.uniform(0.0, 0.1, (h, w))).astype(np.float32)
    depth[:, : w // 3] += 1.5
    return color, albedo, normal, depth


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def test_joint_bilateral_matches_jax():
    color, albedo, normal, depth = _images(1, 32, 48)
    with jax.disable_jit():
        want = jdn.joint_bilateral(*map(jnp.asarray, (color, albedo, normal,
                                                     depth)))
    got = tdn.joint_bilateral(*_t(color, albedo, normal, depth))
    _close(got, want)


@pytest.mark.parametrize("size,exclude", [((64, 64), True),
                                          ((40, 56), False)])
def test_svgf_denoise_matches_jax(size, exclude):
    """Variance-guided a-trous filter (3 levels at 64x64, 2 at 40x56), with
    and without the excluded (emissive) pixels."""
    h, w = size
    color, albedo, normal, depth = _images(2, h, w)
    var = np.random.default_rng(3).gamma(1.0, 0.05, (h, w)).astype(
        np.float32)
    excl = np.zeros((h, w), bool)
    excl[5:9, 10:20] = True
    ex_j = jnp.asarray(excl) if exclude else None
    ex_t = torch.from_numpy(excl) if exclude else None
    args = [jnp.asarray(x) for x in (color, albedo, normal, depth, var)]
    with jax.disable_jit():
        want = jdn.svgf_denoise(*args, ex_j)
    got = tdn.svgf_denoise(*_t(color, albedo, normal, depth, var), ex_t)
    _close(got, want)
    _close(got, jdn.svgf_denoise(*args, ex_j), dict(rtol=5e-5, atol=1e-6))
    assert not np.allclose(got.numpy(), color)
    if exclude:
        # excluded pixels pass through the compression round trip c s / s
        np.testing.assert_allclose(got.numpy()[excl], color[excl],
                                   rtol=3e-7)


def test_spatial_variance_matches_jax():
    color = _images(4, 32, 32)[0]
    with jax.disable_jit():
        want = jdn.spatial_variance(jnp.asarray(color))
    _close(tdn.spatial_variance(torch.from_numpy(color)), want)


def _gbuffer(seed, h, w, view_from):
    """A G-buffer of the plane z = 0 under a camera at view_from (looking
    at the origin): world positions, depth and camera snapshot from the
    JAX camera, as a numpy tree of the JAX GBuffer."""
    cfg = CameraConfig(width=w, height=h, fov_y_deg=50.0,
                       view_from=view_from, view_at=(0.0, 0.0, 0.0))
    cam = jcam.make_camera(cfg)
    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    o, d = jcam.generate_rays_at(cam, cfg, jnp.uint32(seed), ys, xs)
    t = -o[..., 2] / d[..., 2]
    pos = o + d * t[..., None]
    g = np.random.default_rng(seed)
    z3 = np.zeros((h, w, 3), np.float32)
    normal = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (h, w, 3))
    emission = z3.copy()
    emission[:3, :4] = 5.0
    gb = JGBuffer(pos=pos, normal=jnp.asarray(normal),
                  diffuse=jnp.asarray(g.uniform(0.2, 0.8, (h, w, 3))
                                      .astype(np.float32)),
                  specular=jnp.asarray(z3), emission=jnp.asarray(emission),
                  shininess=jnp.zeros((h, w)), depth=t,
                  mat_type=jnp.ones((h, w), jnp.int32),
                  inv_i_m=jnp.ones((h, w)), cam_pos=cam.pos,
                  view_mat=cam.view_mat, focal=cam.focal)
    return jax.tree.map(np.asarray, gb)


def test_svgf_temporal_update_three_frames_with_camera_move():
    """Three frames of SVGF temporal accumulation, the camera moving
    between them (reprojection through the previous view matrix, the
    depth/normal acceptance, the neighbourhood clamp): history, color and
    variance equal frame by frame."""
    h, w = 32, 48
    views = [(0.0, -4.0, 3.0), (0.15, -4.0, 3.05), (0.3, -3.9, 3.1)]
    jh = jdn.empty_svgf_history(h, w)
    th = tdn.empty_svgf_history(h, w, "cpu")
    g = np.random.default_rng(6)
    accepted = []
    for k, view in enumerate(views):
        gbn = _gbuffer(10 + k, h, w, view)
        frame = g.gamma(2.0, 0.3, (h, w, 3)).astype(np.float32)
        with jax.disable_jit():
            jh, jc, jv = jdn.svgf_temporal_update(
                jh, jnp.asarray(frame), jax.tree.map(jnp.asarray, gbn))
        th, tc, tv = tdn.svgf_temporal_update(
            th, torch.from_numpy(frame),
            convert.from_tree(GBuffer, gbn, "cpu"))
        _close(tc, jc)
        _close(tv, jv)
        for name in ("color", "m1", "m2", "length", "depth", "normal",
                     "view_mat", "focal"):
            _close(getattr(th, name), getattr(jh, name))
        accepted.append(float((th.length > 1.0).float().mean()))
    # the moved camera still reprojects most of the plane
    assert accepted[0] == 0.0 and min(accepted[1:]) > 0.5
    assert float(th.length.max()) == 3.0


@pytest.mark.parametrize("method", ["svgf", "bilateral"])
def test_denoise_accumulator_matches_jax(method):
    """The OIDN-style call on a G-buffer: both methods; svgf without a
    variance image takes the spatial estimate and excludes the emissive
    pixels."""
    h, w = 32, 48
    gbn = _gbuffer(20, h, w, (0.0, -4.0, 3.0))
    acc = _images(7, h, w)[0]
    with jax.disable_jit():
        want = jdn.denoise_accumulator(jnp.asarray(acc),
                                       jax.tree.map(jnp.asarray, gbn),
                                       method=method)
    got = tdn.denoise_accumulator(torch.from_numpy(acc),
                                  convert.from_tree(GBuffer, gbn, "cpu"),
                                  method=method)
    _close(got, want)
