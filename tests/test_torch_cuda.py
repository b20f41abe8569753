"""The port's CUDA kernels against their plain PyTorch versions on the
card. Needs a CUDA card (marker `gpu`); skipped without one. The file
imports nothing of JAX or of the JAX package, so it also runs where they
are absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: hit ids, occlusion masks and gathered values are exact, and so
are t, u, v: the ray/triangle kernels are built with --fmad=false and keep
the plain version's operation order, and PyTorch runs each operation of
the plain version as its own kernel, so both round every step alike. K4
(scatter_local) is exact on integer cotangents (exact in any summation
order) and within 1e-5 on normal ones (its plain version, index_add_, sums
in atomic order). Gradients on cuda and cpu: closest_hit's (go, gd) at
rtol 1e-6 (the same ops on bit-identical hits); a whole 64x32 frame at
rtol 1e-3 plus 1e-3 of each field's largest entry (CUDA and the CPU round
sin, pow and exp differently, which can move a pixel's reservoir choice).
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from tpu_restir_torch.config import (CameraConfig, RenderConfig,
                                     RenderParams, RestirParams)
from tpu_restir_torch.kernels import local_gather as lg
from tpu_restir_torch.kernels import ray_tri
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render.integrators.restir.pipeline import (
    render_restir_frames)
from tpu_restir_torch.scene.cornell import cornell_box

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rays(dev, n, seed, dead_share=0.0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    o = torch.rand((n, 3), generator=g, device=dev) * 3.0 \
        - torch.tensor([1.5, 1.5, 0.5], device=dev)
    d = torch.randn((n, 3), generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    tn = torch.full((n,), 1e-2, device=dev)
    tf = torch.rand((n,), generator=g, device=dev) * 3.0
    dead = torch.rand((n,), generator=g, device=dev) < dead_share
    d = torch.where(dead[:, None], 0.0, d).contiguous()
    tf = torch.where(dead, -1e-3, tf).contiguous()
    return o.contiguous(), d, tn, tf


@pytest.mark.parametrize("n", [1, 255, 100_003])
def test_closest_hit_kernel_matches_plain(cuda, n):
    scene = cornell_box(cuda)
    o, d, tn, _tf = _rays(cuda, n, n)
    tf = torch.full_like(tn, float("inf"))
    before = ray_tri.LAUNCHES["closest_hit"]
    got = ray_tri.closest_hit(scene, o, d, tn, tf)
    assert ray_tri.LAUNCHES["closest_hit"] == before + 1
    want = ray_tri.closest_hit_ref(ray_tri.woop_rows(scene), o, d, tn, tf)
    torch.cuda.synchronize()
    assert got[3].dtype == torch.int32
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_closest_hit_emissive_subset(cuda):
    scene = cornell_box(cuda)
    idx = scene.lights.tri_idx.long()
    sub = dataclasses.replace(scene, tri_v=scene.tri_v[idx],
                              woop=scene.woop[idx])
    o, d, tn, _ = _rays(cuda, 50_000, 7)
    tf = torch.full_like(tn, float("inf"))
    got = ray_tri.closest_hit(sub, o, d, tn, tf)
    want = ray_tri.closest_hit_ref(ray_tri.woop_rows(sub), o, d, tn, tf)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_any_hit_kernel_matches_plain(cuda):
    scene = cornell_box(cuda)
    o, d, tn, tf = _rays(cuda, 100_003, 3, dead_share=0.1)
    got = ray_tri.any_hit(scene, o, d, tn, tf)
    want = ray_tri.any_hit_ref(ray_tri.woop_rows(scene), o, d, tn, tf)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert 0 < int(got.sum()) < got.numel()


def test_ray_tri_refuses_bad_inputs(cuda):
    scene = cornell_box(cuda)
    o, d, tn, tf = _rays(cuda, 64, 1)
    with pytest.raises(ValueError):
        ray_tri.any_hit(scene, o, d.double(), tn, tf)
    with pytest.raises(ValueError):
        ray_tri.any_hit(scene, o, d, tn.cpu(), tf)


@pytest.mark.parametrize("h,w,c,k,top", [(7, 13, 5, 3, 0),
                                         (32, 48, 24, 5, 0),
                                         (20, 40, 32, 1, 4)])
def test_gather_local_kernel_matches_plain(cuda, h, w, c, k, top):
    g = torch.Generator(device=cuda)
    g.manual_seed(h * w)
    eh = h + 2 * top
    payload = torch.randn((eh, w, c), generator=g, device=cuda)
    tys = torch.randint(0, eh, (k, h, w), generator=g, device=cuda,
                        dtype=torch.int32)
    txs = torch.randint(0, w, (k, h, w), generator=g, device=cuda,
                        dtype=torch.int32)
    before = lg.LAUNCHES["gather_local"]
    got = lg.gather_local(payload, tys, txs, 8, top=top)
    assert lg.LAUNCHES["gather_local"] == before + 1
    assert torch.equal(got, lg.gather_local_ref(payload, tys, txs))


def test_small_frame_cuda_matches_cpu(cuda):
    cfg = RenderConfig(
        camera=CameraConfig(width=32, height=16, fov_y_deg=45.0,
                            view_from=(0.0, -3.9, 1.0),
                            view_at=(0.0, 0.0, 1.0), pixel_sampler="random"),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(m_area=1, m_brdf=1, do_temporal_reuse=True,
                            do_spatial_reuse=True, spatial_mis="pairwise"),
        integrator="restir")
    imgs = [render_restir_frames(cornell_box(dev),
                                 cam_mod.make_camera(cfg.camera, dev), cfg,
                                 0, 2, dev).cpu()
            for dev in (cuda, torch.device("cpu"))]
    pix = imgs[1].mean(-1)
    assert abs(float(imgs[0].mean() - imgs[1].mean())) \
        <= float(pix.std()) / pix.numel() ** 0.5


def _disk_taps(dev, k, h, w, r, disk_r2, seed):
    """Tap coordinates whose offsets lie in the window of r and disk_r2,
    clamped to the image (clamping only shrinks an offset)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dy = torch.randint(-r, r + 1, (k, h, w), generator=g, device=dev)
    dx = torch.randint(-r, r + 1, (k, h, w), generator=g, device=dev)
    out = dy * dy + dx * dx > disk_r2
    dy, dx = torch.where(out, 0, dy), torch.where(out, 0, dx)
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    return ((ys + dy).clamp(0, h - 1).to(torch.int32).contiguous(),
            (xs + dx).clamp(0, w - 1).to(torch.int32).contiguous())


@pytest.mark.parametrize("h,w,c,k,r,disk_r2", [(7, 13, 5, 3, 3, None),
                                               (32, 48, 24, 5, 5, 30),
                                               (17, 33, 32, 2, 4, None),
                                               (9, 200, 8, 1, 1, 1)])
def test_scatter_local_kernel_matches_plain(cuda, h, w, c, k, r, disk_r2):
    tys, txs = _disk_taps(cuda, k, h, w, r,
                          2 * r * r if disk_r2 is None else disk_r2, h * c)
    g = torch.Generator(device=cuda)
    g.manual_seed(w)
    gi = torch.randint(-50, 51, (k, h, w, c), generator=g,
                       device=cuda).to(torch.float32)
    before = lg.LAUNCHES["scatter_local"]
    got = lg.scatter_local(gi, tys, txs, r, disk_r2)
    assert lg.LAUNCHES["scatter_local"] == before + 1
    assert torch.equal(got, lg.scatter_local_ref(gi, tys, txs))
    gn = torch.randn((k, h, w, c), generator=g, device=cuda)
    torch.testing.assert_close(lg.scatter_local(gn, tys, txs, r, disk_r2),
                               lg.scatter_local_ref(gn, tys, txs),
                               rtol=0.0, atol=1e-5)


def test_gather_local_backward_launches_k4(cuda):
    tys, txs = _disk_taps(cuda, 5, 24, 40, 5, 30, 3)
    payload = torch.randn((24, 40, 24), device=cuda, requires_grad=True)
    before = lg.LAUNCHES["scatter_local"]
    out = lg.gather_local(payload, tys, txs, 5, top=0, disk_r2=30)
    gi = torch.randint(-9, 10, out.shape, device=cuda).to(torch.float32)
    out.backward(gi)
    assert lg.LAUNCHES["scatter_local"] == before + 1
    assert torch.equal(payload.grad, lg.scatter_local_ref(gi, tys, txs))


_TRAP = """
import torch
from tpu_restir_torch.kernels import local_gather as lg
dev = torch.device("cuda")
h, w, r = 16, 16, 2
ys = torch.arange(h, device=dev)[None, :, None].expand(1, h, w)
xs = torch.arange(w, device=dev)[None, None, :].expand(1, h, w)
tys = ys.to(torch.int32).contiguous()
txs = (xs + {dx}).clamp(0, w - 1).to(torch.int32).contiguous()
g = torch.ones((1, h, w, 4), device=dev)
lg.scatter_local(g, tys, txs, r)
torch.cuda.synchronize()
print("finished")
"""


@pytest.mark.parametrize("dx,traps", [(2, False), (3, True)])
def test_scatter_local_traps_out_of_window_taps(cuda, dx, traps):
    """A tap outside the window faults the device (in a subprocess: a trap
    leaves its CUDA context unusable)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _TRAP.format(dx=dx)],
                          cwd=root, capture_output=True, text=True,
                          timeout=300)
    if traps:
        assert proc.returncode != 0 and "finished" not in proc.stdout
    else:
        assert proc.returncode == 0 and "finished" in proc.stdout, \
            proc.stderr


def test_closest_hit_gradient_cuda_matches_cpu(cuda):
    scene = {dev: cornell_box(dev) for dev in ("cuda", "cpu")}
    o, d, tn, _tf = _rays(cuda, 20_000, 11)
    tf = torch.full_like(tn, float("inf"))
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    wts = torch.randn((3, o.shape[0]), generator=g, device=cuda)
    grads = {}
    for dev in ("cuda", "cpu"):
        oo = o.to(dev).requires_grad_(True)
        dd = d.to(dev).requires_grad_(True)
        t, u, v, tri = ray_tri.closest_hit(scene[dev], oo, dd, tn.to(dev),
                                           tf.to(dev))
        w = wts.to(dev)
        hit = tri >= 0
        loss = (torch.where(hit, t, 0.0) * w[0] + u * w[1] + v * w[2]).sum()
        grads[dev] = [x.cpu() for x in torch.autograd.grad(loss, (oo, dd))]
    assert float(grads["cpu"][0].abs().max()) > 0.0
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_small_frame_gradients_cuda_match_cpu(cuda):
    from tpu_restir_torch.diff.params import extract_params
    from tpu_restir_torch.diff.render import make_value_and_grad
    cfg = RenderConfig(
        camera=CameraConfig(width=64, height=32, fov_y_deg=45.0,
                            view_from=(0.0, -3.9, 1.0),
                            view_at=(0.0, 0.0, 1.0), pixel_sampler="random"),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(m_area=1, m_brdf=1, do_temporal_reuse=True,
                            do_spatial_reuse=True, spatial_mis="pairwise"),
        integrator="restir")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene = cornell_box(dev)
        vg = make_value_and_grad(scene, cam_mod.make_camera(cfg.camera, dev),
                                 cfg, (1,), torch.zeros((32, 64, 3),
                                                        device=dev))
        loss, grads = vg(extract_params(scene))
        out[dev.type] = (float(loss), {k: v.cpu() for k, v in grads.items()})
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    for k in gp:
        assert torch.isfinite(gc[k]).all()
        scale = float(gp[k].abs().max())
        assert bool(((gc[k] - gp[k]).abs()
                     <= 1e-3 * gp[k].abs() + 1e-3 * scale).all()), k
