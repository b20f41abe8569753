"""The port's CUDA kernels against their plain PyTorch versions on the
card. Needs a CUDA card (marker `gpu`); skipped without one. The file
imports nothing of JAX or of the JAX package, so it also runs where they
are absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: hit ids, occlusion masks and gathered values are exact, and so
are t, u, v: the ray/triangle kernels are built with --fmad=false and keep
the plain version's operation order, and PyTorch runs each operation of
the plain version as its own kernel, so both round every step alike.
"""

import dataclasses

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
