"""Parity of the port's core math with the JAX package, on the CPU.

Inputs come from numpy.random.default_rng and go to both packages.
Tolerances:
  * PCG4D draws, frame seeds and integer disk offsets: exact (integer
    hashing and an integer compare-sum, the same on any device).
  * calc_i_m: rtol 1e-5 with atol 4e-6. I_M cancels between terms of
    size ~2*pi near cos(theta) < 0, where the JAX float32 betainc alone is
    off by up to 2.2e-6 absolute from a float64 reference; the port's
    float64 continued fraction is held to 5e-7 of that reference.
  * colour and sampling: rtol 1e-6, atol 1e-6 (one or two float32 ulps
    from transcendental functions implemented differently).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import rng as jrng
from tpu_restir.mathx import color as jcolor
from tpu_restir.mathx.special import calc_i_m as j_calc_i_m
from tpu_restir.render import sampling as jsampling
from tpu_restir_torch import mathx as tmathx
from tpu_restir_torch import rng as trng
from tpu_restir_torch.mathx import color as tcolor
from tpu_restir_torch.mathx.special import calc_i_m as t_calc_i_m
from tpu_restir_torch.render import sampling as tsampling

F32 = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,frame", [(0, 0), (123, 7), (2**31 + 5, 99),
                                        (4294967295, 123456)])
def test_make_frame_seed_exact(seed, frame):
    want = int(np.asarray(jrng.make_frame_seed(seed, frame)))
    assert trng.make_frame_seed(seed, frame) == want


def test_pcg4d_bit_exact():
    g = np.random.default_rng(1)
    a, b, c, d = (g.integers(0, 2**32, 4096, dtype=np.uint64)
                  .astype(np.uint32) for _ in range(4))
    want = jrng.pcg4d(*(jnp.asarray(x) for x in (a, b, c, d)))
    got = trng.pcg4d(*(_t(x.astype(np.int64)) for x in (a, b, c, d)))
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy().astype(np.uint32),
                                      np.asarray(w))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_pixel_uniforms_bit_exact(n):
    g = np.random.default_rng(2)
    ys = g.integers(0, 4096, (24, 40)).astype(np.int32)
    xs = g.integers(0, 4096, (24, 40)).astype(np.int32)
    seed = trng.make_frame_seed(77, 3)
    stream = jrng.stream_id(jrng.PASS_SPATIAL, 5 * 64 + 3, 2)
    want = jrng.pixel_uniforms(jnp.uint32(seed), stream, jnp.asarray(ys),
                               jnp.asarray(xs), n)
    got = trng.pixel_uniforms(seed, stream, _t(ys), _t(xs), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert trng.stream_id(jrng.PASS_SPATIAL, 5 * 64 + 3, 2) == stream


@pytest.mark.parametrize("radius", [30.0, 10.0, 4.0])
def test_disk_int_offsets_exact(radius):
    js, jd, jn = jsampling.disk_int_offset_table(radius)
    ts, td, tn = tsampling.disk_int_offset_table(radius)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)
    assert tn == jn
    g = np.random.default_rng(3)
    u = g.random((64, 64), dtype=np.float32)
    u[0, :4] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5, 1e-9]
    want = np.asarray(jsampling.disk_int_from_uniform(jnp.asarray(u), radius))
    got = tsampling.disk_int_from_uniform(_t(u), radius)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0.0, 1.0, 10.0, 120.0])
def test_calc_i_m_matches_jax(n):
    c = np.linspace(-1.0, 1.0, 2001, dtype=np.float32)
    nn = np.full_like(c, n)
    want = np.asarray(j_calc_i_m(jnp.asarray(c), jnp.asarray(nn)))
    got = t_calc_i_m(_t(c), _t(nn)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=4e-6)


@pytest.mark.parametrize("n", [0.0, 1.0, 10.0, 120.0])
def test_calc_i_m_matches_float64_reference(n):
    """The continued fraction against scipy's incomplete beta in float64."""
    from scipy.special import betainc, gammaln

    c = np.linspace(-1.0, 1.0, 2001, dtype=np.float32)
    got = t_calc_i_m(_t(c), _t(np.full_like(c, n))).numpy()
    c64 = c.astype(np.float64)
    s = np.clip(1.0 - c64 * c64, 0.0, 1.0)
    h = 0.5 * n
    if n >= 1e-18:
        neg = c64 * h * betainc(h, 0.5, s) \
            * np.exp(gammaln(h) + gammaln(0.5) - gammaln(h + 0.5))
    else:
        neg = c64
    pw = np.where(s > 0, s ** h, 1.0 if h == 0 else 0.0)
    gq = np.exp(gammaln(h + 0.5) - gammaln(h + 1.0))
    want = (2 * math.pi * c64 + math.sqrt(math.pi) * gq * (pw - neg)) \
        / (n + 2.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


def test_color_transfer():
    x = np.random.default_rng(4).uniform(-0.5, 20.0, (512, 3)) \
        .astype(np.float32)
    x[:4, 0] = [0.0, 0.0031308, 0.04045, 1.0]
    for jf, tf in ((jcolor.aces, tcolor.aces),
                   (jcolor.srgb_compress, tcolor.srgb_compress)):
        np.testing.assert_allclose(tf(_t(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))), **F32)


def _unit(g, n):
    v = g.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_sampling_functions():
    g = np.random.default_rng(5)
    n = 2048
    u2 = g.random((n, 2), dtype=np.float32)
    u4 = g.random((n, 4), dtype=np.float32)
    normal = _unit(g, n)
    omega = _unit(g, n)
    gamma = g.uniform(1.0, 120.0, n).astype(np.float32)
    pairs = [
        (jsampling.triangle_barycentrics_from_uniforms(jnp.asarray(u2)),
         tsampling.triangle_barycentrics_from_uniforms(_t(u2))),
        (jsampling.cosine_hemisphere_from_uniforms(jnp.asarray(u2),
                                                   jnp.asarray(normal)),
         tsampling.cosine_hemisphere_from_uniforms(_t(u2), _t(normal))),
        (jsampling.cosine_lobe_from_uniforms(jnp.asarray(u2),
                                             jnp.asarray(normal),
                                             jnp.asarray(gamma)),
         tsampling.cosine_lobe_from_uniforms(_t(u2), _t(normal), _t(gamma))),
        (jsampling.pdf_cosine_hemisphere(jnp.asarray(normal),
                                         jnp.asarray(omega)),
         tsampling.pdf_cosine_hemisphere(_t(normal), _t(omega))),
        (jsampling.pdf_cosine_lobe(jnp.asarray(omega), jnp.asarray(normal),
                                   jnp.asarray(gamma)),
         tsampling.pdf_cosine_lobe(_t(omega), _t(normal), _t(gamma))),
    ]
    for kind in ("center", "random", "stratified"):
        pairs.append((jsampling.pixel_offsets_u(jnp.asarray(u4), kind),
                      tsampling.pixel_offsets_u(_t(u4), kind)))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_vector_math():
    from tpu_restir import mathx as jmathx

    g = np.random.default_rng(6)
    v = g.standard_normal((1024, 3)).astype(np.float32)
    v[:8] = 0.0
    base = g.uniform(0.0, 1.0, 1024).astype(np.float32)
    base[:8] = 0.0
    ex = g.uniform(0.0, 3.0, 1024).astype(np.float32)
    ex[:4] = 0.0
    np.testing.assert_allclose(tmathx.normalize(_t(v)).numpy(),
                               np.asarray(jmathx.normalize(jnp.asarray(v))),
                               **F32)
    np.testing.assert_allclose(tmathx.length(_t(v)).numpy(),
                               np.asarray(jmathx.length(jnp.asarray(v))),
                               **F32)
    np.testing.assert_allclose(
        tmathx.safe_pow(_t(base), _t(ex)).numpy(),
        np.asarray(jmathx.safe_pow(jnp.asarray(base), jnp.asarray(ex))),
        **F32)
    n = _unit(g, 1024)
    for a, b in zip(tmathx.onb(_t(n)), jmathx.onb(jnp.asarray(n))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    bad = np.array([[np.nan, -1.0, 2.0]], np.float32)
    np.testing.assert_array_equal(tmathx.sanitize(_t(bad)).numpy(),
                                  [[0.0, 0.0, 2.0]])
