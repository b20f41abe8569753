"""Row-sharded rendering of the port (`tpu_restir_torch.dist`) on gloo
ranks on the CPU, against one device and against the JAX package's
sharded step.

Each spawn of ranks (tests/torch_dist_worker.py) runs several checks, to
pay the start of the processes once:
  * 4 ranks: extend_rows equals the neighbour concatenation (zero rows at
    the global edges) for float, int32 and bool fields, and its backward
    equals autograd of that concatenation in one process: every owner
    receives the summed cotangents of its border rows; gather_rows and
    its backward likewise (integer-valued cotangents, so every sum is
    exact and the comparison is bit for bit);
  * sharded == one-device ReSTIR frames, bit for bit, over 3 frames at
    32x32 (the JAX test's config): radius 4 over 4 ranks (halo 3 in
    8-row shards) and radius 30 over 8 ranks (halo 7 above 4-row shards:
    the all-gather fallback);
  * sharded value and gradients w.r.t. the material table against the
    one-device estimator at the JAX test's tolerance (loss rtol 1e-5,
    gradients rtol 2e-4 and atol 1e-6; tests/test_sharded_diff.py), in
    halo mode (4 ranks) and in the all-gather fallback (8 ranks);
  * a camera move whose reprojection leaves the shard and its halo, which
    the reference never pinned: the sharded frame then differs from the
    one-device frame by design (the reprojection is clamped into shard +
    halo), and is held to the JAX package's sharded step on the same
    inputs by the whole-frame criteria of tests/test_torch_restir.py
    (image means within one standard error, fewer than 1% of final
    reservoirs holding another sample, their weights at rtol 1e-3). The
    JAX step compiles once: the test takes about 14 s on the CPU with a
    cold compilation cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as wk
from tpu_restir import rng as jrng
from tpu_restir.config import (CameraConfig, RenderConfig, RenderParams,
                               RestirParams)
from tpu_restir.dist.mesh import make_mesh as j_make_mesh
from tpu_restir.dist.sharded import (device_put_replicated,
                                     device_put_row_sharded,
                                     make_sharded_restir_step as j_sharded)
from tpu_restir.render import camera as jcam
from tpu_restir.render.integrators.restir.pipeline import (
    init_restir_state as j_init_state)
from tpu_restir.scene import cornell_box as j_cornell_box
from tpu_restir_torch import rng
from tpu_restir_torch.diff.params import extract_params
from tpu_restir_torch.diff.render import make_value_and_grad
from tpu_restir_torch.dist import halo
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render.integrators.restir.pipeline import (
    init_restir_state, restir_step)
from tpu_restir_torch.scene.cornell import cornell_box

SIZE = 32
# frame 1 looks 0.6 higher: its reprojections move ~7 rows, beyond the
# halo of 3 rows at radius 4
MOVE = [((0.0, -3.9, 1.0), (0.0, 0.0, 1.0)),
        ((0.0, -3.9, 1.0), (0.0, 0.0, 1.6)),
        ((0.0, -3.9, 1.0), (0.0, 0.0, 1.0))]
EXT = dict(h=32, w=4, halo_rows=3)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return wk.spawn([("extend", EXT),
                     ("frames", dict(size=SIZE, radius=4.0)),
                     ("grads", dict(size=16, radius=4.0)),
                     ("frames", dict(size=SIZE, radius=4.0, views=MOVE))],
                    4, tmp_path_factory.mktemp("four"))


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return wk.spawn([("frames", dict(size=SIZE, radius=30.0)),
                     ("grads", dict(size=16, radius=30.0))],
                    8, tmp_path_factory.mktemp("eight"))


def _one_device_frames(radius, views=None):
    cfg = wk.restir_cfg(SIZE, radius)
    scene = cornell_box("cpu")
    state = init_restir_state(SIZE, SIZE, "cpu")
    out = []
    for f in range(3):
        vf, va = views[f] if views else (None, None)
        cam = cam_mod.make_camera(cfg.camera, "cpu", vf, va)
        frame, state = restir_step(scene, cam, cfg,
                                   rng.make_frame_seed(0, f), state, f)
        out.append(frame.numpy())
    return out, state


def test_halo_exchange_matches_concat(four):
    n, h, w, hr = 4, EXT["h"], EXT["w"], EXT["halo_rows"]
    lh = h // n
    x = torch.arange(h * w, dtype=torch.float32).reshape(h, w) \
        .requires_grad_(True)
    xi = (x.detach() * 3).to(torch.int32)
    xb = x.detach().to(torch.int64) % 3 == 0

    def ext_of(t, d):
        z = torch.zeros((hr, w), dtype=t.dtype)
        top = t[d * lh - hr:d * lh] if d > 0 else z
        bot = t[(d + 1) * lh:(d + 1) * lh + hr] if d < n - 1 else z
        return torch.cat([top, t[d * lh:(d + 1) * lh], bot])

    loss = 0.0
    loss2 = 0.0
    for d in range(n):
        got = four[d][0]
        e = ext_of(x, d)
        np.testing.assert_array_equal(got["ext"], e.detach().numpy())
        np.testing.assert_array_equal(got["ext_i"], ext_of(xi, d).numpy())
        np.testing.assert_array_equal(got["ext_b"], ext_of(xb, d).numpy())
        np.testing.assert_array_equal(got["full"], x.detach().numpy())
        np.testing.assert_array_equal(got["full_i"], xi.numpy())
        loss = loss + (e * wk.int_field(lh + 2 * hr, w, 100 + d)).sum()
        loss2 = loss2 + (x * wk.int_field(h, w, 200 + d)).sum()
    (g,) = torch.autograd.grad(loss, [x])
    (g2,) = torch.autograd.grad(loss2, [x])
    # every owner holds the summed cotangents of its border rows
    np.testing.assert_array_equal(
        np.concatenate([four[d][0]["g_ext"] for d in range(n)]), g.numpy())
    np.testing.assert_array_equal(
        np.concatenate([four[d][0]["g_full"] for d in range(n)]),
        g2.numpy())


def test_halo_width_and_local_row():
    assert halo.halo_width(30.0) == 7 and halo.halo_width(4.0) == 3
    gy = torch.tensor([0, 5, 9, 31])
    np.testing.assert_array_equal(halo.local_row(gy, 3, 10).numpy(),
                                  [0, 2, 6, 9])


@pytest.mark.parametrize("extra_rows", [0, 14, 24])
def test_temporal_tap_of_an_extended_payload_goes_through_k3(monkeypatch,
                                                             extra_rows):
    """The temporal taps read a payload of the shard's height, of the shard
    and its halo (+14 rows at radius 30) or of all-gathered rows through
    K3's wrapper, whose CUDA gather has no window: payload[tys, txs]."""
    from tpu_restir_torch.kernels import local_gather as lg
    from tpu_restir_torch.render.integrators.restir import temporal
    calls = []
    orig = lg.gather_local
    monkeypatch.setattr(lg, "gather_local", lambda p, ty, tx, *a, **k: (
        calls.append(p.shape) or orig(p, ty, tx, *a, **k)))
    g = np.random.default_rng(11)
    h, w = 8, 16
    payload = torch.from_numpy(g.standard_normal(
        (h + extra_rows, w, 12)).astype(np.float32))
    tys = torch.from_numpy(g.integers(0, h + extra_rows, (h, w)).astype(
        np.int32))
    txs = torch.from_numpy(g.integers(0, w, (h, w)).astype(np.int32))
    got = temporal._reproject_tap(payload, tys, txs)
    assert calls == [payload.shape]
    np.testing.assert_array_equal(
        got.numpy(), payload.numpy()[tys.numpy(), txs.numpy()])


@pytest.mark.parametrize("mode", ["halo", "all_gather"])
def test_sharded_restir_bitwise_parity(four, eight, mode):
    radius, got = (4.0, four[0][1]) if mode == "halo" else (30.0, eight[0][0])
    want, _state = _one_device_frames(radius)
    for f in range(3):
        np.testing.assert_array_equal(got[f"frame{f}"], want[f],
                                      err_msg=f"frame {f}")
    # halo mode sends strips; the fallback sends whole shards
    assert int(got["sent"]) > 0 and int(got["staged"]) == 0


@pytest.mark.parametrize("mode", ["halo", "all_gather"])
def test_sharded_grads_match_one_device(four, eight, mode):
    radius, ranks = (4.0, [four[d][2] for d in range(4)]) \
        if mode == "halo" else (30.0, [eight[d][1] for d in range(8)])
    cfg = wk.restir_cfg(16, radius, neighbors=3)
    scene = cornell_box("cpu")
    cam = cam_mod.make_camera(cfg.camera, "cpu")
    target = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (16, 16, 3)).astype(np.float32))
    v1, g1 = make_value_and_grad(scene, cam, cfg, (0, 1), target)(
        extract_params(scene))
    for got in ranks:   # every rank holds the all-reduced values
        np.testing.assert_allclose(got["loss"], v1.numpy(), rtol=1e-5)
        for k, g in g1.items():
            np.testing.assert_allclose(got[f"g_{k}"], g.numpy(), rtol=2e-4,
                                       atol=1e-6, err_msg=k)
    assert any(float(g.abs().max()) > 0 for g in g1.values())


def _jax_sharded_frames(views):
    """The JAX package's sharded step over 4 of the 8 virtual devices."""
    ccfg = CameraConfig(width=SIZE, height=SIZE, fov_y_deg=45.0,
                        view_from=(0, -3.9, 1.0), view_at=(0, 0, 1.0),
                        pixel_sampler="random")
    cfg = RenderConfig(camera=ccfg, params=RenderParams(use_skybox=False),
                       restir=RestirParams(
                           m_area=2, m_brdf=1, do_temporal_reuse=True,
                           do_spatial_reuse=True, spatial_neighbor_count=4,
                           spatial_reuse_radius=4.0, spatial_mis="pairwise"),
                       integrator="restir", n_devices=4)
    mesh = j_make_mesh(4)
    step = j_sharded(mesh, cfg)
    state = device_put_row_sharded(j_init_state(SIZE, SIZE), mesh, SIZE)
    scene = device_put_replicated(j_cornell_box(), mesh)
    out = []
    for f, (vf, va) in enumerate(views):
        cam = device_put_replicated(jcam.make_camera(ccfg, vf, va), mesh)
        frame, state = step(scene, cam, jrng.make_frame_seed(0, f), state,
                            jnp.asarray(f))
        out.append(np.asarray(frame))
    return out, jax.tree.map(np.asarray, state.res_prev)


def test_reprojection_leaving_the_halo_matches_jax_sharded(four):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    got = four[0][3]
    one, _state = _one_device_frames(4.0, MOVE)
    # the move leaves the halo: the sharded frame departs from one device
    assert not np.array_equal(got["frame1"], one[1])
    want, res = _jax_sharded_frames(MOVE)
    for f in range(3):
        pix = want[f].mean(-1)
        stderr = pix.std() / np.sqrt(pix.size)
        assert abs(got[f"frame{f}"].mean() - want[f].mean()) <= stderr, f
    same = (np.abs(got["point"] - res.sample.point).max(-1) <= 1e-4) \
        & (got["valid"] == res.sample.valid)
    assert 1.0 - same.mean() < 0.01, 1.0 - same.mean()
    np.testing.assert_allclose(got["w"][same], res.w[same], rtol=1e-3,
                               atol=1e-5)
