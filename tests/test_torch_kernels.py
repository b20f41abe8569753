"""The plain versions of the port's kernels against the JAX Pallas kernels
run in the Pallas interpreter (as tests/test_kernels_pallas.py runs them),
on the CPU; and the wrappers' CPU dispatch.

  K1 closest_hit, K2 any_hit (kernels/ray_tri.py): hit ids and occlusion
     must be exact, except on rays whose barycentric, t-range or tie margin
     is under 1e-6 (there one float32 rounding decides); those are counted
     and must stay under 0.1% of the rays. t, u, v: allclose at 1e-5.
  K3 gather_local (kernels/local_gather.py): bit-exact (a copy), also with
     a halo-extended payload (top != 0). The JAX interpreter path needs
     H % 8 == 0 and W % 128 == 0, hence 16 x 128 images. Its backward (K4)
     is held to the JAX one in tests/test_torch_diff_ops.py.

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir.config import CameraConfig
from tpu_restir.kernels import local_gather as jlg
from tpu_restir.kernels import ray_tri as jrt
from tpu_restir.render import camera as jcam
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir_torch import tracing
from tpu_restir_torch.kernels import local_gather as tlg
from tpu_restir_torch.kernels import ray_tri as trt
from tpu_restir_torch.scene.cornell import cornell_box as t_cornell_box

MARGIN = 1e-6
MAX_MARGIN_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jlg.INTERPRET = True
    jrt.INTERPRET = True
    yield
    jlg.INTERPRET = False
    jrt.INTERPRET = False


@pytest.fixture(scope="module")
def scenes():
    return j_cornell_box(), t_cornell_box("cpu")


def _rays(kind, n=4096, seed=0):
    """(o, d, tnear, tfar) float32 numpy rays: camera rays of a 64x64 view,
    or random rays in and around the box."""
    g = np.random.default_rng(seed)
    if kind == "camera":
        ccfg = CameraConfig(width=64, height=n // 64, fov_y_deg=45.0,
                            view_from=(0.0, -3.9, 1.0),
                            view_at=(0.0, 0.0, 1.0))
        cam = jcam.make_camera(ccfg)
        ys, xs = np.meshgrid(np.arange(n // 64), np.arange(64), indexing="ij")
        o, d = jcam.generate_rays_at(cam, ccfg, jnp.uint32(9),
                                     jnp.asarray(ys), jnp.asarray(xs))
        o = np.array(o).reshape(-1, 3)
        d = np.array(d).reshape(-1, 3)
    else:
        o = g.uniform([-1.5, -1.5, -0.5], [1.5, 1.5, 2.5], (n, 3))
        d = g.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = np.full(n, 1e-2)
    tf = np.full(n, np.inf) if kind != "segments" else g.uniform(0, 3, n)
    if kind == "segments":
        # dead rays (tfar < tnear) with zero-length directions, as
        # evaluate_f makes for pixels whose f is already 0
        dead = g.random(n) < 0.1
        d[dead] = 0.0
        tf[dead] = -1e-3
    return tuple(np.ascontiguousarray(x, np.float32) for x in (o, d, tn, tf))


def _margin(w, o, d, tn, tf):
    """Per ray: the least distance of any triangle's test to a decision
    boundary (barycentric edges, t range, t ties), from the plain test."""
    t, u, v, ok = (x.numpy().astype(np.float64) for x in trt._woop_tuvok(
        *(torch.from_numpy(x) for x in (o, d, tn, tf)), w))
    with np.errstate(invalid="ignore"):
        return _margin_of(t, u, v, ok, tn, tf)


def _margin_of(t, u, v, ok, tn, tf):
    eps = 1e-5
    fin = np.isfinite(t)
    tt = np.where(fin, t, 0.0)
    m = np.minimum.reduce([np.abs(u + eps), np.abs(v + eps),
                           np.abs(1.0 + eps - u - v),
                           np.abs(tt - tn[:, None]),
                           np.where(np.isfinite(tf[:, None]),
                                    np.abs(tt - np.nan_to_num(tf)[:, None]),
                                    np.inf)])
    m = np.where(fin, m, np.inf).min(axis=1)
    ts = np.sort(np.where(ok > 0, t, np.inf), axis=1)
    tie = np.abs(ts[:, 1] - ts[:, 0]) / np.maximum(np.abs(ts[:, 0]), 1.0)
    return np.minimum(m, np.where(np.isfinite(tie), tie, np.inf))


def _check_ids(got, want, margin, what):
    bad = got != want
    assert np.all(margin[bad] < MARGIN), \
        f"{what}: {int(bad.sum())} mismatches, some away from any margin"
    assert bad.sum() <= MAX_MARGIN_SHARE * len(got), what


@pytest.mark.parametrize("kind,subset", [("camera", False), ("random", False),
                                         ("random", True)])
def test_closest_hit_plain_matches_pallas(scenes, kind, subset):
    js, ts = scenes
    if subset:   # the emissive-subset view of the BRDF candidate
        idx = np.asarray(js.lights.tri_idx)
        js = js.replace(tri_v=js.tri_v[idx], woop=js.woop[idx])
        ts = dataclasses.replace(ts, tri_v=ts.tri_v[idx], woop=ts.woop[idx])
    o, d, tn, tf = _rays(kind, seed=1)
    jt, ju, jv, jtri = (np.asarray(x) for x in jrt.closest_hit(
        js, *(jnp.asarray(x) for x in (o, d, tn, tf))))
    tt, tu, tv, ttri = (x.numpy() for x in trt.closest_hit(
        ts, *(torch.from_numpy(x) for x in (o, d, tn, tf))))
    assert ttri.dtype == np.int32
    _check_ids(ttri, jtri, _margin(trt.woop_rows(ts), o, d, tn, tf),
               "closest tri")
    same = (ttri == jtri) & (jtri >= 0)
    assert same.sum() > 0
    for g, w in ((tt, jt), (tu, ju), (tv, jv)):
        np.testing.assert_allclose(g[same], w[same], rtol=1e-5, atol=1e-5)
    assert np.all(np.isinf(tt[ttri < 0])) and np.all(tu[ttri < 0] == 0.0)


@pytest.mark.parametrize("kind", ["segments", "random"])
def test_any_hit_plain_matches_pallas(scenes, kind):
    js, ts = scenes
    o, d, tn, tf = _rays(kind, seed=2)
    if kind == "random":
        tf = np.full_like(tf, 2.0)
    want = np.asarray(jrt.any_hit(js, *(jnp.asarray(x)
                                        for x in (o, d, tn, tf))))
    got = trt.any_hit(ts, *(torch.from_numpy(x)
                            for x in (o, d, tn, tf))).numpy()
    assert got.dtype == np.bool_
    assert 0 < got.sum() < len(got)
    _check_ids(got, want, _margin(trt.woop_rows(ts), o, d, tn, tf),
               "occlusion")


def _taps(g, h, w, k, r, top=0, eh=None):
    eh = h if eh is None else eh
    ys = np.arange(h)[None, :, None] + top + g.integers(-r, r + 1, (k, h, w))
    xs = np.arange(w)[None, None, :] + g.integers(-r, r + 1, (k, h, w))
    return (np.clip(ys, 0, eh - 1).astype(np.int32),
            np.clip(xs, 0, w - 1).astype(np.int32))


@pytest.mark.parametrize("k,r,c,halo", [(5, 5, 24, 0), (5, 5, 32, 0),
                                        (1, 8, 24, 0), (4, 4, 5, 6)])
def test_gather_local_plain_matches_pallas(k, r, c, halo):
    g = np.random.default_rng(3)
    h, w = 16, 128
    eh = h + 2 * halo
    payload = g.standard_normal((eh, w, c)).astype(np.float32)
    tys, txs = _taps(g, h, w, k, r, top=halo, eh=eh)
    want = np.asarray(jlg.gather_local(jnp.asarray(payload),
                                       jnp.asarray(tys), jnp.asarray(txs),
                                       r, top=halo))
    got = tlg.gather_local(torch.from_numpy(payload), torch.from_numpy(tys),
                           torch.from_numpy(txs), r, top=halo)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_versions(scenes):
    _js, ts = scenes
    before = tracing.counted("launch.")
    o, d, tn, tf = (torch.from_numpy(x) for x in _rays("random", 64))
    trt.closest_hit(ts, o, d, tn, tf)
    trt.any_hit(ts, o, d, tn, tf)
    p = torch.zeros((8, 8, 4))
    i = torch.zeros((1, 8, 8), dtype=torch.int32)
    tlg.gather_local(p, i, i, 1)
    assert tracing.counted("launch.") == before


def test_gather_local_refuses_gradients_and_bad_shapes():
    """Gradients reach the payload only (through the plain K4 on the CPU);
    the tap coordinates are integers and take none."""
    p = torch.zeros((8, 8, 4), requires_grad=True)
    i = torch.zeros((2, 8, 8), dtype=torch.int32)
    out = tlg.gather_local(p, i, i, 1)
    out.sum().backward()
    assert float(p.grad[0, 0, 0]) == 2 * 8 * 8 and float(p.grad.sum()) \
        == out.numel()
    with pytest.raises(ValueError):
        tlg.gather_local(p.detach(), i, i[:, :4], 1)
    with pytest.raises(ValueError):
        tlg.gather_local(p.detach(), i, i, 1, top=1)
