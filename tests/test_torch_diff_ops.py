"""The port's differentiable building blocks against the JAX package's, on
the CPU: the row select's custom VJP, the Phong normalization's gradient,
the closest-hit derivative (K1's backward) and the plain K4 (the transpose
of the tap gather), each held to `jax.vjp` / `jax.grad` of the JAX
function. The Pallas kernels run in the Pallas interpreter, as
tests/test_kernels_pallas.py runs them.

Tolerances:
  * take_rows: the table cotangent at rtol 1e-5, atol 1e-5 (float32 sums
    of ~1000 rows, reduced in another order than XLA's);
  * calc_i_m: d/d n_dot_v and d/d n at rtol 1e-4 (the port evaluates the
    incomplete beta in float64, JAX's betainc in float32: ~1e-5 apart);
  * closest_hit: (go, gd) at rtol 1e-5, atol 1e-5 on rays whose winning
    triangle is the same in both packages (ids may differ only where one
    rounding decides, as tests/test_torch_kernels.py counts);
  * K4: exact on integer cotangents (exact in any summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import mathx as jmathx
from tpu_restir.config import CameraConfig
from tpu_restir.kernels import local_gather as jlg
from tpu_restir.kernels import ray_tri as jrt
from tpu_restir.mathx.special import calc_i_m as j_calc_i_m
from tpu_restir.render import camera as jcam
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir_torch import mathx as tmathx
from tpu_restir_torch import tracing
from tpu_restir_torch.kernels import local_gather as tlg
from tpu_restir_torch.kernels import ray_tri as trt
from tpu_restir_torch.mathx.special import calc_i_m as t_calc_i_m
from tpu_restir_torch.render.sampling import disk_int_from_uniform
from tpu_restir_torch.scene.cornell import cornell_box as t_cornell_box


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jlg.INTERPRET = True
    jrt.INTERPRET = True
    yield
    jlg.INTERPRET = False
    jrt.INTERPRET = False


@pytest.mark.parametrize("rows", [4, 36, 300])
def test_take_rows_cotangent_matches_jax(rows):
    g = np.random.default_rng(rows)
    table = g.standard_normal((rows, 5)).astype(np.float32)
    idx = g.integers(0, rows, (40, 25)).astype(np.int32)
    ct = g.standard_normal((40, 25, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jmathx.take_rows(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tt = torch.from_numpy(table).requires_grad_(True)
    out = tmathx.take_rows(tt, torch.from_numpy(idx).long())
    # the custom backward (masked row sums, or index_add_ above 128 rows),
    # not autograd's index_select backward
    assert "TakeRows" in out.grad_fn.name()
    np.testing.assert_array_equal(out.detach().numpy(), table[idx])
    (got,) = torch.autograd.grad(out, tt, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_calc_i_m_gradients_match_jax():
    """d I_M / d n_dot_v and d I_M / d n at shininess 1-128: the incomplete
    beta's shape parameters are detached in both packages."""
    g = np.random.default_rng(7)
    c = g.uniform(0.02, 0.999, 256).astype(np.float32)
    n = np.exp(g.uniform(0.0, np.log(128.0), 256)).astype(np.float32)
    n[:4] = [1.0, 2.0, 64.0, 128.0]
    want = jax.grad(lambda c, n: jnp.sum(j_calc_i_m(c, n)), argnums=(0, 1))(
        jnp.asarray(c), jnp.asarray(n))
    ct = torch.from_numpy(c).requires_grad_(True)
    nt = torch.from_numpy(n).requires_grad_(True)
    got = torch.autograd.grad(t_calc_i_m(ct, nt).sum(), (ct, nt))
    for gt, gw in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gw), rtol=1e-4,
                                   atol=1e-6)


def _rays(kind, n=2048, seed=0):
    """Camera rays of a 64-wide view, or random rays in and around the box
    of which a tenth run parallel to the floor (d_z = 0: a zero Woop
    denominator for the floor and ceiling triangles)."""
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
        o = g.uniform([-0.9, -0.9, 0.1], [0.9, 0.9, 1.9], (n, 3))
        d = g.standard_normal((n, 3))
        d[g.random(n) < 0.1, 2] = 0.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = np.full(n, 1e-2)
    tf = np.full(n, np.inf)
    return tuple(np.ascontiguousarray(x, np.float32) for x in (o, d, tn, tf))


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_closest_hit_vjp_matches_jax(kind):
    js, ts = j_cornell_box(), t_cornell_box("cpu")
    o, d, tn, tf = _rays(kind, seed=4)
    g = np.random.default_rng(5)
    cts = [g.standard_normal(len(o)).astype(np.float32) for _ in range(3)]
    jout, vjp = jax.vjp(lambda o, d: jrt.closest_hit(
        js, o, d, jnp.asarray(tn), jnp.asarray(tf))[:3],
        jnp.asarray(o), jnp.asarray(d))
    jtri = np.asarray(jrt.closest_hit(js, *(jnp.asarray(x)
                                            for x in (o, d, tn, tf)))[3])
    # t is inf on a miss: its cotangent there is 0 in both packages' use
    ct_t = np.where(jtri >= 0, cts[0], 0.0).astype(np.float32)
    jgo, jgd = (np.asarray(x) for x in vjp((jnp.asarray(ct_t),
                                            jnp.asarray(cts[1]),
                                            jnp.asarray(cts[2]))))
    ot = torch.from_numpy(o).requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    t, u, v, tri = trt.closest_hit(ts, ot, dt, torch.from_numpy(tn),
                                   torch.from_numpy(tf))
    assert "ClosestHit" in t.grad_fn.name() and not tri.requires_grad
    go, gd = (x.numpy() for x in torch.autograd.grad(
        (t, u, v), (ot, dt), [torch.from_numpy(ct_t)]
        + [torch.from_numpy(x) for x in cts[1:]]))
    assert np.isfinite(go).all() and np.isfinite(gd).all()
    same = tri.numpy() == jtri
    assert same.mean() > 0.99 and (jtri[same] >= 0).sum() > len(o) // 4
    np.testing.assert_allclose(go[same], jgo[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gd[same], jgd[same], rtol=1e-5, atol=1e-5)


def test_any_hit_is_detached_and_saves_nothing():
    ts = t_cornell_box("cpu")
    o, d, tn, tf = (torch.from_numpy(x) for x in _rays("random", 256))
    o.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(x) or x, lambda x: x):
        occ = trt.any_hit(ts, o, d, tn, torch.full_like(tn, 2.0))
    assert occ.dtype == torch.bool and not occ.requires_grad
    assert saved == []


def _disk_taps(g, k, h, w, top=0, eh=None):
    """Spatial-pass taps: the pass's own integer disk offsets (radius 30,
    so |offset| <= 5 and dy^2 + dx^2 <= 30) clamped to the payload."""
    eh = h if eh is None else eh
    off = disk_int_from_uniform(
        torch.from_numpy(g.random((k, h, w)).astype(np.float32)), 30.0)
    off = off.numpy()
    ys = np.arange(h)[None, :, None] + top
    xs = np.arange(w)[None, None, :]
    return (np.clip(ys + off[..., 1], 0, eh - 1).astype(np.int32),
            np.clip(xs + off[..., 0], 0, w - 1).astype(np.int32))


@pytest.mark.parametrize("c,halo", [(24, 0), (32, 0), (24, 6)])
def test_gather_local_transpose_matches_pallas(c, halo):
    """The plain K4 (halo 0) and the index_add_ route of a halo-extended
    payload against jax.vjp of the JAX gather_local (its Pallas scatter
    transpose for halo 0, XLA's scatter-add otherwise): exact on integer
    cotangents. The interpreter needs H % 8 == 0 and W % 128 == 0."""
    g = np.random.default_rng(c + halo)
    k, h, w, r = 5, 16, 128, 5
    eh = h + 2 * halo
    payload = g.standard_normal((eh, w, c)).astype(np.float32)
    tys, txs = _disk_taps(g, k, h, w, top=halo, eh=eh)
    ct = g.integers(-16, 17, (k, h, w, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jlg.gather_local(p, jnp.asarray(tys),
                                                jnp.asarray(txs), r, halo,
                                                30), jnp.asarray(payload))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    pt = torch.from_numpy(payload).requires_grad_(True)
    out = tlg.gather_local(pt, torch.from_numpy(tys), torch.from_numpy(txs),
                           r, top=halo, disk_r2=30)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(pt.grad.numpy(), want)
    if halo == 0:
        got = tlg.scatter_local_ref(torch.from_numpy(ct),
                                    torch.from_numpy(tys),
                                    torch.from_numpy(txs))
        np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_local_takes_the_plain_version_on_cpu():
    before = tracing.counted("launch.")
    g = torch.ones((2, 4, 8, 3))
    i = torch.zeros((2, 4, 8), dtype=torch.int32)
    out = tlg.scatter_local(g, i, i, 8)
    assert tracing.counted("launch.") == before
    assert float(out[0, 0].sum()) == 2 * 4 * 8 * 3
    with pytest.raises(ValueError):
        tlg.scatter_local(g, i[:, :2], i, 8)


def test_emissive_subset_gradient_through_the_light_table():
    """The light table's emission rows (take_rows of a 6-row material
    table) carry the cotangent of l_i, as JAX's gather transpose does."""
    from tpu_restir_torch.scene import lights as tlights
    from tpu_restir.scene import lights as jlights
    js, ts = j_cornell_box(), t_cornell_box("cpu")
    u3 = np.random.default_rng(2).random((64, 3)).astype(np.float32)
    ct = np.random.default_rng(3).standard_normal((64, 3)).astype(np.float32)

    def jl(em):
        s = js.replace(materials=js.materials.replace(emission=em))
        return jlights.light_point_from_uniforms(jnp.asarray(u3), s)["l_i"]

    _, vjp = jax.vjp(jl, js.materials.emission)
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    em = ts.materials.emission.clone().requires_grad_(True)
    s = dataclasses.replace(ts, materials=dataclasses.replace(
        ts.materials, emission=em))
    l_i = tlights.light_point_from_uniforms(torch.from_numpy(u3), s)["l_i"]
    (got,) = torch.autograd.grad(l_i, em, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
