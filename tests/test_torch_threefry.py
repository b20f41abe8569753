"""The port's threefry keys and draws (tpu_restir_torch.rng) against
jax.random, bit for bit, and the key-based samplers and camera rays of the
path tracers against the JAX package's, on the CPU.

Tolerances: keys, 32-bit draws, uniforms (compared as bits) and randint
are exact; the samplers and the camera directions go through sin, cos,
pow and rsqrt, which XLA and PyTorch round otherwise, so rtol 1e-6 (rays)
and rtol 1e-5, atol 1e-6 (samplers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import rng as jrng
from tpu_restir.config import CameraConfig as JCameraConfig
from tpu_restir.render import camera as jcam
from tpu_restir.render import sampling as jsampling
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir.scene import lights as jlights
from tpu_restir_torch import rng
from tpu_restir_torch.config import CameraConfig
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.render import sampling
from tpu_restir_torch.scene import lights
from tpu_restir_torch.scene.cornell import cornell_box

SEEDS = [0, 1, 123, 2 ** 31 - 1, 987_654_321]


def _words(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_match_jax(seed):
    jk = jax.random.key(seed)
    k = rng.key(seed)
    assert _words(jk) == k
    for data in (0, 7, 1000, 2 ** 32 - 1):
        assert _words(jax.random.fold_in(jk, data)) == rng.fold_in(k, data)
    for n in (2, 3, 5):
        want = [_words(x) for x in jax.random.split(jk, n)]
        assert want == rng.split(k, n)


@pytest.mark.parametrize("seed", SEEDS)
def test_frame_pass_draw_keys_match_jax(seed):
    jf = jrng.frame_key(seed, 11)
    f = rng.frame_key(seed, 11)
    assert _words(jf) == f
    for pass_id in (rng.PASS_PIXEL_JITTER, rng.PASS_NAIVE,
                    rng.PASS_NEE_DIRECT, rng.PASS_NEE_GI):
        jp, p = jrng.pass_key(jf, pass_id), rng.pass_key(f, pass_id)
        assert _words(jp) == p
        assert _words(jrng.draw_key(jp, 100 + seed % 7)) \
            == rng.draw_key(p, 100 + seed % 7)
    assert (rng.PASS_NAIVE, rng.PASS_NEE_DIRECT, rng.PASS_NEE_GI) \
        == (jrng.PASS_NAIVE, jrng.PASS_NEE_DIRECT, jrng.PASS_NEE_GI)


@pytest.mark.parametrize("shape", [(), (7,), (12, 16, 5), (300, 257)])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_matches_jax_bit_for_bit(seed, shape):
    """(300, 257) holds more than 2^16 draws."""
    jk = jax.random.fold_in(jax.random.key(seed), 3)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = rng.uniform(rng.fold_in(rng.key(seed), 3), shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


@pytest.mark.parametrize("lo,hi", [(0, 2 ** 31 - 1), (3, 17), (-5, 1000),
                                   (0, 1 << 16), (7, 8)])
def test_randint_matches_jax(lo, hi):
    for seed in range(40):
        jk = jax.random.fold_in(jax.random.key(seed), 5)
        want = int(jax.random.randint(jk, (), lo, hi, dtype=jnp.int32))
        got = rng.randint_scalar(rng.fold_in(rng.key(seed), 5), lo, hi)
        assert got == want, (seed, got, want)


@pytest.mark.parametrize("sampler", ["center", "random", "stratified"])
def test_generate_rays_match_jax(sampler):
    kw = dict(width=16, height=12, fov_y_deg=45.0,
              view_from=(0.0, -3.9, 1.0), view_at=(0.0, 0.0, 1.0),
              pixel_sampler=sampler)
    jc, tc = JCameraConfig(**kw), CameraConfig(**kw)
    jo, jd = jcam.generate_rays(jcam.make_camera(jc), jc,
                                jrng.frame_key(0, 4))
    o, d = tcam.generate_rays(tcam.make_camera(tc, "cpu"), tc,
                              rng.frame_key(0, 4))
    assert tuple(d.shape) == (12, 16, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)


def _normals(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_key_samplers_match_jax():
    """sample_cosine_hemisphere, sample_cosine_lobe and sample_light_point
    draw what the JAX wrappers draw."""
    nrm = _normals(257, 0)
    gamma = np.random.default_rng(1).uniform(1.0, 80.0, 257) \
        .astype(np.float32)
    jk, k = jax.random.key(9), rng.key(9)
    np.testing.assert_allclose(
        sampling.sample_cosine_hemisphere(k, torch.from_numpy(nrm)).numpy(),
        np.asarray(jsampling.sample_cosine_hemisphere(jk, jnp.asarray(nrm))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        sampling.sample_cosine_lobe(k, torch.from_numpy(nrm),
                                    torch.from_numpy(gamma)).numpy(),
        np.asarray(jsampling.sample_cosine_lobe(jk, jnp.asarray(nrm),
                                                jnp.asarray(gamma))),
        rtol=1e-5, atol=1e-6)
    want = jlights.sample_light_point(jk, j_cornell_box(), (12, 16))
    got = lights.sample_light_point(k, cornell_box("cpu"), (12, 16))
    for name in ("point", "normal", "l_i", "pdf_area"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got["tri"].numpy(), np.asarray(want["tri"]))
