"""The port's CUDA kernels against their plain PyTorch versions on the
card. Needs a CUDA card (marker `gpu`); skipped without one. The file
imports nothing of JAX or of the JAX package, so it also runs where they
are absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: hit ids, occlusion masks and gathered values are exact, and so
are t, u, v: the ray/triangle kernels (K1/K2) and the clustered traversal
(K5/K6, and its Woop variant K7/K8) are built with --fmad=false and keep
the plain version's operation order, and PyTorch runs each operation of
the plain version as its own kernel, so both round every step alike. K4
(scatter_local) is exact on integer cotangents (exact in any summation
order), within 1e-5 of its plain version index_add_ on normal ones (which
sums in atomic order), and bit for bit the sum in its own order
(`scatter_local_ordered_ref`). Gradients on cuda and cpu: closest_hit's (go, gd) at
rtol 1e-6 (the same ops on bit-identical hits); a whole 64x32 frame at
rtol 1e-3 plus 1e-3 of each field's largest entry (CUDA and the CPU round
sin, pow and exp differently, which can move a pixel's reservoir choice).
"""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tpu_restir_torch import tracing
from tpu_restir_torch.config import (CameraConfig, RenderConfig,
                                     RenderParams, RestirParams)
from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.kernels import local_gather as lg
from tpu_restir_torch.kernels import ray_tri
from tpu_restir_torch.kernels.woop import build_woop_matrices
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render.integrators.restir.pipeline import (
    render_restir_frames)
from tpu_restir_torch.scene.cornell import cornell_box, many_lights_scene
from tpu_restir_torch.scene.procedural import TERRAIN_SPECS, terrain_scene
from tpu_restir_torch.scene.scene import build_scene
from torch_phase1_cases import (K9_CASES, box_rays, max_face_rays,
                                patches_scene, phase1_case)
from torch_ray_families import ANY_FAMILIES, family

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


@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_closest_hit_kernel_matches_plain(cuda, n):
    scene = cornell_box(cuda)
    o, d, tn, _tf = _rays(cuda, n, n)
    tf = torch.full_like(tn, float("inf"))
    before = tracing.COUNTS["launch.closest_hit"]
    got = ray_tri.closest_hit(scene, o, d, tn, tf)
    assert tracing.COUNTS["launch.closest_hit"] == before + 1
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


def _woop_table(dev, n, seed):
    """A scene-like table of n random triangles (edges up to 0.6) in and
    around the unit box, the middle one degenerate when n > 1."""
    g = np.random.default_rng(seed)
    centres = g.uniform(-1.5, 1.5, (n, 1, 3))
    tris = centres + g.uniform(-0.3, 0.3, (n, 3, 3))
    if n > 1:
        tris[n // 2, 2] = tris[n // 2, 1]
    w = torch.from_numpy(build_woop_matrices(tris)).to(dev)
    return types.SimpleNamespace(woop=w, num_tris=n)


def _table(dev, name):
    """"cornell36" (the Cornell box) or "random<n>" (_woop_table)."""
    if name == "cornell36":
        return cornell_box(dev)
    n = int(name[len("random"):])
    return _woop_table(dev, n, n)


@pytest.mark.parametrize("table", ["random1", "cornell36", "random512",
                                   "random700"])
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_any_hit_kernel_tables(cuda, n, table):
    """K2 against its plain version at ray counts off the kernel's
    blocking (2 rays a thread, 256 a block) and on tables of 1, 36, 512
    (one shared-memory tile) and 700 rows (two tiles)."""
    scene = _table(cuda, table)
    o, d, tn, tf = _rays(cuda, n, n + 1, dead_share=0.1)
    before = tracing.COUNTS["launch.any_hit"]
    got = ray_tri.any_hit(scene, o, d, tn, tf)
    assert tracing.COUNTS["launch.any_hit"] == before + 1
    want = ray_tri.any_hit_ref(ray_tri.woop_rows(scene), o, d, tn, tf)
    assert torch.equal(got, want)
    if n == 100_003 and table != "random1":
        assert 0 < int(got.sum()) < n


@pytest.mark.parametrize("pattern", ["occluded", "visible", "alternating"])
def test_any_hit_kernel_whole_warps(cuda, pattern):
    """Warps whose rays are all occluded (the warp leaves the triangle
    loop early) or all visible, and both kinds in one launch: rays from
    z = 1 straight down onto a floor of two triangles at z = 0, with
    tfar 2 (occluded) or 0.5 (visible); "alternating" flips the verdict
    every 64 rays, so each warp (32 threads of 2 adjacent rays) is
    uniform."""
    floor = np.array([[[-2, -2, 0], [2, -2, 0], [2, 2, 0]],
                      [[-2, -2, 0], [2, 2, 0], [-2, 2, 0]]], np.float64)
    scene = types.SimpleNamespace(
        woop=torch.from_numpy(build_woop_matrices(floor)).to(cuda),
        num_tris=2)
    n = 4096 + 37
    g = torch.Generator(device=cuda)
    g.manual_seed(17)
    o = torch.rand((n, 3), generator=g, device=cuda) * 2.0 - 1.0
    o[:, 2] = 1.0
    d = torch.tensor([0.0, 0.0, -1.0], device=cuda).expand(n, 3).contiguous()
    tn = torch.full((n,), 1e-3, device=cuda)
    occluded = {"occluded": torch.ones(n, dtype=torch.bool, device=cuda),
                "visible": torch.zeros(n, dtype=torch.bool, device=cuda),
                "alternating": (torch.arange(n, device=cuda) // 64) % 2 == 0
                }[pattern]
    tf = torch.where(occluded, 2.0, 0.5)
    got = ray_tri.any_hit(scene, o, d, tn, tf)
    assert torch.equal(got, occluded)
    assert torch.equal(got, ray_tri.any_hit_ref(ray_tri.woop_rows(scene), o,
                                                d, tn, tf))


def test_any_hit_kernel_special_ranges(cuda):
    """K2 folds [tnear, tfar] once per ray: infinite and NaN bounds, empty
    and single-point ranges, zero and NaN directions give the plain
    version's mask."""
    scene = cornell_box(cuda)
    o, d, tn, tf = _rays(cuda, 8192, 21)
    inf, nan = float("inf"), float("nan")
    cases = [(-inf, inf), (0.0, inf), (-inf, 2.0), (nan, 2.0), (0.0, nan),
             (2.0, 1.0), (inf, inf), (-inf, -inf), (1.0, 1.0), (0.0, 0.0)]
    k = torch.arange(o.shape[0], device=cuda) % (len(cases) + 1)
    for i, (a, b) in enumerate(cases):
        tn = torch.where(k == i, a, tn)
        tf = torch.where(k == i, b, tf)
    d = d.clone()
    d[::97] = 0.0
    d[5::101] = nan
    want = ray_tri.any_hit_ref(ray_tri.woop_rows(scene), o, d, tn, tf)
    got = ray_tri.any_hit(scene, o, d, tn.contiguous(), tf.contiguous())
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("table", ["random1", "random512", "random700"])
def test_closest_hit_kernel_tables(cuda, table):
    """K1 (which shares the tile staging with K2) on tables of 1, 512 and
    700 rows (two tiles): ids and t, u, v bit-identical."""
    scene = _table(cuda, table)
    o, d, tn, _tf = _rays(cuda, 50_003, 5)
    tf = torch.full_like(tn, float("inf"))
    got = ray_tri.closest_hit(scene, o, d, tn, tf)
    want = ray_tri.closest_hit_ref(ray_tri.woop_rows(scene), o, d, tn, tf)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[3] >= 0).sum()) > 0


@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_closest_hit_kernel_shared_edges(cuda, n):
    """K1 on rays that graze the Cornell box's shared edges: ids (a tie
    goes to the lowest id) and t, u, v bit-identical."""
    scene = cornell_box(cuda)
    w = ray_tri.woop_rows(scene)
    rays = [torch.from_numpy(x).to(cuda).contiguous()
            for x in family("shared_edges", n, n)[1:]]
    got = ray_tri.closest_hit(scene, *rays)
    want = ray_tri.closest_hit_ref(w, *rays)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    if n == 100_003:
        t, _u, _v, ok = ray_tri._woop_tuvok(*rays, w)
        tt = torch.where(ok, t, torch.inf)
        ties = ((tt == tt.amin(1, keepdim=True)) & ok).sum(1) > 1
        assert int(ties.sum()) > 0


@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_closest_hit_kernel_special_ranges(cuda, n):
    """K1 folds [tnear, tfar] once per ray as K2 does: infinite and NaN
    bounds, empty and single-point ranges, zero and NaN directions give
    the plain version's (t, u, v, tri)."""
    scene = cornell_box(cuda)
    o, d, tn, tf = _rays(cuda, n, 21 + n)
    inf, nan = float("inf"), float("nan")
    cases = [(-inf, inf), (0.0, inf), (-inf, 2.0), (nan, 2.0), (0.0, nan),
             (2.0, 1.0), (inf, inf), (-inf, -inf), (1.0, 1.0), (0.0, 0.0)]
    k = torch.arange(n, device=cuda) % (len(cases) + 1)
    for i, (a, b) in enumerate(cases):
        tn = torch.where(k == i, a, tn)
        tf = torch.where(k == i, b, tf)
    d = d.clone()
    d[::97] = 0.0
    d[5::101] = nan
    tn, tf = tn.contiguous(), tf.contiguous()
    want = ray_tri.closest_hit_ref(ray_tri.woop_rows(scene), o, d, tn, tf)
    got = ray_tri.closest_hit(scene, o, d, tn, tf)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    if n == 100_003:
        assert 0 < int((got[3] >= 0).sum()) < n


def test_ray_tri_refuses_bad_inputs(cuda):
    scene = cornell_box(cuda)
    o, d, tn, tf = _rays(cuda, 64, 1)
    with pytest.raises(ValueError):
        ray_tri.any_hit(scene, o, d.double(), tn, tf)
    with pytest.raises(ValueError):
        ray_tri.any_hit(scene, o, d, tn.cpu(), tf)


@pytest.mark.parametrize("h,w,c,k,top", [(7, 13, 5, 3, 0),
                                         (32, 48, 24, 5, 0),
                                         (20, 40, 32, 1, 4),
                                         (33, 47, 3, 1, 0),
                                         (33, 47, 24, 5, 2),
                                         (9, 300, 32, 5, 0),
                                         (16, 16, 24, 1, 0),
                                         (5, 61, 8, 2, 1)])
@pytest.mark.parametrize("aligned", [True, False])
def test_gather_local_kernel_matches_plain(cuda, h, w, c, k, top, aligned):
    """K3 against its plain version: C = 3, 5, 8, 24, 32, K = 1 to 5, top
    != 0, tap slices of 91 to 2,700 taps (whole blocks of 256 and partial
    ones); with the payload 16-byte aligned and, unaligned, a view 4
    bytes into its buffer (one float a thread)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(h * w)
    eh = h + 2 * top
    buf = torch.randn((eh * w * c + 1,), generator=g, device=cuda)
    payload = (buf[:-1] if aligned else buf[1:]).view(eh, w, c)
    assert (payload.data_ptr() % 16 == 0) == aligned
    tys = torch.randint(0, eh, (k, h, w), generator=g, device=cuda,
                        dtype=torch.int32)
    txs = torch.randint(0, w, (k, h, w), generator=g, device=cuda,
                        dtype=torch.int32)
    before = tracing.COUNTS["launch.gather_local"]
    got = lg.gather_local(payload, tys, txs, 8, top=top)
    assert tracing.COUNTS["launch.gather_local"] == before + 1
    assert torch.equal(got, lg.gather_local_ref(payload, tys, txs))


_GATHER_TRAP = """
import torch
from tpu_restir_torch.kernels import local_gather as lg
dev = torch.device("cuda")
payload = torch.ones((16, 16, 24), device=dev)
tys = torch.zeros((5, 16, 16), dtype=torch.int32, device=dev)
txs = torch.zeros((5, 16, 16), dtype=torch.int32, device=dev)
tys[3, 7, 9], txs[3, 7, 9] = {ty}, {tx}
lg.gather_local(payload, tys, txs, 8)
torch.cuda.synchronize()
print("finished")
"""


@pytest.mark.parametrize("ty,tx,traps", [(15, 15, False), (16, 0, True),
                                         (0, -1, True), (-1, 3, True)])
def test_gather_local_traps_out_of_range_taps(cuda, ty, tx, traps):
    """A tap outside the payload faults the device (in a subprocess: a
    trap leaves its CUDA context unusable)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _GATHER_TRAP.format(ty=ty, tx=tx)], cwd=root,
        capture_output=True, text=True, timeout=300)
    if traps:
        assert proc.returncode != 0 and "finished" not in proc.stdout
    else:
        assert proc.returncode == 0 and "finished" in proc.stdout, \
            proc.stderr


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
    before = tracing.COUNTS["launch.scatter_local"]
    got = lg.scatter_local(gi, tys, txs, r, disk_r2)
    assert tracing.COUNTS["launch.scatter_local"] == before + 1
    assert torch.equal(got, lg.scatter_local_ref(gi, tys, txs))
    gn = torch.randn((k, h, w, c), generator=g, device=cuda)
    torch.testing.assert_close(lg.scatter_local(gn, tys, txs, r, disk_r2),
                               lg.scatter_local_ref(gn, tys, txs),
                               rtol=0.0, atol=1e-5)


def _sink_taps(dev, k, h, w, r, disk_r2, seed):
    """`_disk_taps`, then every source within the disk of a corner taps
    that corner and every source within r rows of the top edge taps its
    column's top pixel: long match lists (up to K times the disk's offsets
    at a corner) where screen clamping piles taps onto the edge."""
    tys, txs = _disk_taps(dev, k, h, w, r, disk_r2, seed)
    ys = torch.arange(h, device=dev)[None, :, None].expand(k, h, w)
    xs = torch.arange(w, device=dev)[None, None, :].expand(k, h, w)
    top = ys <= r
    tys = torch.where(top, 0, tys)
    txs = torch.where(top, xs, txs)
    for cy, cx in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)):
        near = ((ys - cy) ** 2 + (xs - cx) ** 2 <= disk_r2) \
            & ((ys - cy).abs() <= r) & ((xs - cx).abs() <= r)
        tys = torch.where(near, cy, tys)
        txs = torch.where(near, cx, txs)
    return tys.to(torch.int32).contiguous(), txs.to(torch.int32).contiguous()


@pytest.mark.parametrize("taps", ["disk", "sink"])
@pytest.mark.parametrize("h,w,c,k,r,disk_r2", [(32, 64, 24, 5, 5, 30),
                                               (40, 96, 32, 5, 5, 30),
                                               (13, 45, 24, 5, 5, 30),
                                               (17, 33, 32, 2, 4, None),
                                               (9, 200, 8, 1, 1, 1),
                                               (7, 13, 5, 3, 3, None),
                                               (21, 37, 24, 12, 8, None)])
def test_scatter_local_kernel_matches_ordered_sum(cuda, taps, h, w, c, k, r,
                                                  disk_r2):
    """K4 on normal cotangents equals, bit for bit, the sum in its own
    (k, sy, sx) order (`scatter_local_ordered_ref`): widths that are no
    multiple of the 32 x 8 tile, C = 5 (no float4), K = 12 at r = 8
    (masks in chunks of taps), and "sink" taps piling up to K x the disk's
    offsets onto the corners and the top edge."""
    d2 = 2 * r * r if disk_r2 is None else disk_r2
    tys, txs = (_disk_taps if taps == "disk" else _sink_taps)(
        cuda, k, h, w, r, d2, h * c)
    g = torch.Generator(device=cuda)
    g.manual_seed(w + k)
    gn = torch.randn((k, h, w, c), generator=g, device=cuda)
    got = lg.scatter_local(gn, tys, txs, r, disk_r2)
    assert torch.equal(got, lg.scatter_local_ordered_ref(gn, tys, txs, r,
                                                         disk_r2))
    gi = torch.randint(-50, 51, (k, h, w, c), generator=g,
                       device=cuda).to(torch.float32)
    assert torch.equal(lg.scatter_local(gi, tys, txs, r, disk_r2),
                       lg.scatter_local_ref(gi, tys, txs))
    if taps == "sink":
        lands = torch.zeros((h, w), dtype=torch.int64, device=cuda)
        lands.view(-1).index_add_(
            0, (tys.long() * w + txs.long()).view(-1),
            torch.ones(tys.numel(), dtype=torch.int64, device=cuda))
        assert int(lands.max()) >= k * (r + 1)


def test_gather_local_backward_launches_k4(cuda):
    tys, txs = _disk_taps(cuda, 5, 24, 40, 5, 30, 3)
    payload = torch.randn((24, 40, 24), device=cuda, requires_grad=True)
    before = tracing.COUNTS["launch.scatter_local"]
    out = lg.gather_local(payload, tys, txs, 5, top=0, disk_r2=30)
    gi = torch.randint(-9, 10, out.shape, device=cuda).to(torch.float32)
    out.backward(gi)
    assert tracing.COUNTS["launch.scatter_local"] == before + 1
    assert torch.equal(payload.grad, lg.scatter_local_ref(gi, tys, txs))


def test_gather_local_at_top_halo_on_a_sharded_spatial_payload(cuda):
    """K3 at top = halo, as a rank of a row-sharded frame launches it: the
    spatial pass of rank 1 of 4 at 64x64 (16-row shards, radius 30: halo
    7), given the halo-extended G-buffer and reservoirs that extend_rows
    delivers (rows 9 to 39 of the one-device buffers), gives that rank's
    rows of the one-device pass bit for bit, and its gather equals
    gather_local_ref on the captured payload and taps bit for bit."""
    from tpu_restir_torch import rng
    from tpu_restir_torch.render.integrators.restir import gbuffer as gb_mod
    from tpu_restir_torch.render.integrators.restir.initial import (
        initial_pass)
    from tpu_restir_torch.render.integrators.restir.pipeline import (
        map_pixels)
    from tpu_restir_torch.render.integrators.restir.spatial import (
        spatial_pass)

    h = w = 64
    lh, halo, row0 = 16, 7, 16
    cfg = RenderConfig(
        camera=CameraConfig(width=w, height=h, pixel_sampler="random",
                            view_from=(0.0, -3.9, 1.0),
                            view_at=(0.0, 0.0, 1.0)),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(do_spatial_reuse=True, spatial_mis="pairwise",
                            spatial_neighbor_count=5))
    scene = cornell_box(cuda)
    cam = cam_mod.make_camera(cfg.camera, cuda)
    seed = rng.make_frame_seed(0, 0)
    ys = torch.arange(h, dtype=torch.int32, device=cuda)[:, None] \
        .expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=cuda)[None, :] \
        .expand(h, w)
    gb = gb_mod.gbuffer_fill(scene, cam, cfg, seed, ys, xs)
    res = initial_pass(seed, scene, gb, cfg, ys, xs)
    want = spatial_pass(seed, 0, scene, gb, res, cfg, ys, xs)

    def rows(obj, sl):
        return map_pixels(obj, lambda ts: [t[sl] for t in ts])

    own, ext = slice(row0, row0 + lh), slice(row0 - halo, row0 + lh + halo)
    calls = []
    orig = lg.gather_local

    def spy(payload, tys, txs, r, top=0, disk_r2=None):
        calls.append((payload, tys, txs, r, top))
        return orig(payload, tys, txs, r, top=top, disk_r2=disk_r2)

    lg.gather_local = spy
    try:
        before = tracing.COUNTS["launch.gather_local"]
        got = spatial_pass(seed, 0, scene, rows(gb, own), rows(res, own),
                           cfg, ys[own], xs[own], gb_ext=rows(gb, ext),
                           res_ext=rows(res, ext), ext_row0=row0 - halo,
                           ext_top=halo)
        assert tracing.COUNTS["launch.gather_local"] == before + 1
    finally:
        lg.gather_local = orig
    got_t, want_t = [], []
    map_pixels(got, lambda ts: got_t.extend(ts) or ts)
    map_pixels(rows(want, own), lambda ts: want_t.extend(ts) or ts)
    for a, b in zip(got_t, want_t):
        assert torch.equal(a, b)
    (payload, tys, txs, r, top), = calls
    assert top == halo and payload.shape[0] == lh + 2 * halo
    assert torch.equal(orig(payload, tys, txs, r, top=top),
                       lg.gather_local_ref(payload, tys, txs))


_TRAP = """
import torch
from tpu_restir_torch.kernels import cluster_trace as ct
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


def _cluster_rays(dev, n, seed, extent, tfar, dead_share=0.0):
    """Random rays through a clustered scene's box; a share of them dead
    (tfar < tnear, zero direction) and one NaN direction per 1000."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    o = (torch.rand((n, 3), generator=g, device=dev) - 0.5) * 2 * extent
    d = torch.randn((n, 3), generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    tn = torch.full((n,), 1e-3, device=dev)
    tf = torch.full((n,), tfar, device=dev)
    dead = torch.rand((n,), generator=g, device=dev) < dead_share
    d = torch.where(dead[:, None], 0.0, d)
    d[::1000] = float("nan")
    return o.contiguous(), d.contiguous(), tn, torch.where(dead, -1.0, tf)


def _packets(scene, rays, factor=1):
    return ct.pack(scene.cluster_min, scene.cluster_max, *rays, factor)


@pytest.mark.parametrize("name,n", [("terrain5k", 1), ("terrain5k", 700),
                                    ("terrain5k", 100_003),
                                    ("lights500", 50_000)])
def test_trace_closest_kernel_matches_plain(cuda, name, n):
    """K5 against its plain version on every ray: terrain (79 clusters)
    and the many-lights room (9 clusters, no cull)."""
    scene = terrain_scene(cuda, 5_000) if name == "terrain5k" \
        else many_lights_scene(cuda, 500)
    pk = _packets(scene, _cluster_rays(cuda, n, n, 4.0, 1e4, 0.1))
    before = tracing.COUNTS["launch.trace_closest"]
    got = ct.closest_packets(scene.cluster_tris, scene.cluster_min,
                             scene.cluster_max, pk)
    assert tracing.COUNTS["launch.trace_closest"] == before + 1
    want = ct.trace_closest_ref(scene.cluster_tris, pk)
    torch.cuda.synchronize()
    assert got[3].dtype == torch.int32
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if n > 1:
        assert 0 < int((got[3] >= 0).sum()) < n


@pytest.mark.parametrize("name", ["terrain5k", "lights500"])
def test_trace_closest_kernel_warps_and_lengths(cuda, name):
    """K5 against its plain version, bit for bit, where its warp-level
    shortcuts fire: the warps of a packet reach different depths (rays of
    one packet sharing an origin, each pair of rows of the 8x32 packet, a
    warp of K5, with its own tfar and a tenth of the rays dead), and
    shortlists of length 0, 1 and S (the many-lights room, whose packets
    of rays from inside it in every direction list every cluster)."""
    scene = terrain_scene(cuda, 5_000) if name == "terrain5k" \
        else many_lights_scene(cuda, 500)
    g = torch.Generator(device=cuda)
    g.manual_seed(23)
    n = 64 * ct.P
    origin = torch.tensor([0.0, -6.0, 3.0] if name == "terrain5k"
                          else [0.0, 0.0, 1.0], device=cuda)
    o = (origin + 0.01 * torch.randn((n, 3), generator=g, device=cuda))
    d = torch.randn((n, 3), generator=g, device=cuda)
    if name == "terrain5k":
        d = d * 0.3 + torch.tensor([0.0, 1.0, -0.5], device=cuda)
    d = d / d.norm(dim=-1, keepdim=True)
    depth = torch.tensor([0.5, 2.0, 4.0, 1e4], device=cuda)
    tf = depth[torch.randint(0, 4, (n // 64,), generator=g, device=cuda)] \
        .repeat_interleave(64)
    dead = torch.rand((n,), generator=g, device=cuda) < 0.1
    tf = torch.where(dead, -1.0, tf)
    pk = _packets(scene, (o.contiguous(), d.contiguous(),
                          torch.full((n,), 1e-3, device=cuda), tf))
    pk.count[0] = 0
    pk.count[int(torch.nonzero(pk.count[1:] > 1)[0]) + 1] = 1
    got = ct.closest_packets(scene.cluster_tris, scene.cluster_min,
                             scene.cluster_max, pk)
    want = ct.trace_closest_ref(scene.cluster_tris, pk)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    counts = set(pk.count.tolist())
    assert {0, 1} <= counts
    if name == "lights500":
        assert pk.shortlist.shape[1] in counts
    assert 0 < int((got[3] >= 0).sum()) < n


@pytest.mark.parametrize("name", ["terrain5k", "lights500"])
def test_trace_any_kernel_matches_plain(cuda, name):
    """K6 against its plain version: cull mode 5 on terrain (C = 79 > 64),
    none in the many-lights room; dead rays are never occluded."""
    scene = terrain_scene(cuda, 5_000) if name == "terrain5k" \
        else many_lights_scene(cuda, 500)
    rays = _cluster_rays(cuda, 100_003, 3, 4.0, 2.0, 0.1)
    pk = _packets(scene, rays)
    before = tracing.COUNTS["launch.trace_any"]
    got = ct.any_packets(scene.cluster_tris, scene.cluster_min,
                         scene.cluster_max, pk)
    assert tracing.COUNTS["launch.trace_any"] == before + 1
    want = ct.trace_any_ref(scene.cluster_tris, pk)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert 0 < int(got.sum()) < got.numel()
    assert not got[:pk.n_rays][rays[3] < rays[2]].any()


def _pattern_rays(scene, dev, pattern, n_packets=48, seed=5):
    """Rays of 256-ray packets whose warps (32 consecutive rays) differ:
    "one_warp": one warp a packet aimed into the scene, the other seven
    pointing away from it (terrain: slab-dead for every listed cluster) or
    too short to reach anything (the room); "mid_occlusion": every ray
    aimed at a point of the scene, a quarter of them stopping halfway, so
    lanes are occluded at different rows and slots; "dead_mixed": the same
    with a random half of each warp's lanes dead (tfar < tnear, d = 0)."""
    g = torch.Generator().manual_seed(seed)
    lo = scene.cluster_min.amin(0).cpu()
    hi = scene.cluster_max.amax(0).cpu()
    mid, ext = (lo + hi) / 2, (hi - lo) / 2
    n = n_packets * ct.P
    room = scene.cluster_tris.shape[0] <= ct.SMALL_C
    target = mid + ext * 0.9 * (torch.rand((n, 3), generator=g) * 2 - 1)
    if room:
        o = mid + ext * 0.5 * (torch.rand((n // 32, 1, 3), generator=g)
                               * 2 - 1)
    else:
        # above the terrain, under the light: inside the scene's box
        o = torch.cat([mid[:2] + ext[:2] * (torch.rand((n // 32, 1, 2),
                                                       generator=g) * 2 - 1),
                       (lo[2] + 0.45 * (hi[2] - lo[2])).expand(n // 32, 1,
                                                               1)], -1)
    o = (o + 0.01 * torch.randn((n // 32, 32, 3), generator=g)).reshape(n, 3)
    d = target - o
    dist = d.norm(dim=-1)
    d = d / dist[:, None]
    tf = dist + 1.0
    warp = torch.arange(n) // 32 % 8
    if pattern == "one_warp":
        chosen = torch.randint(0, 8, (n_packets,), generator=g) \
            .repeat_interleave(ct.P)
        other = warp != chosen
        if room:
            tf = torch.where(other, 1e-2, tf)
        else:
            d = torch.where(other[:, None], -d, d)
    elif pattern == "mid_occlusion":
        tf = torch.where(torch.rand((n,), generator=g) < 0.25, dist * 0.5,
                         tf)
    elif pattern == "dead_mixed":
        dead = torch.rand((n,), generator=g) < 0.5
        d = torch.where(dead[:, None], 0.0, d)
        tf = torch.where(dead, -1.0, tf)
    return tuple(x.to(dev).contiguous() for x in
                 (o, d, torch.full((n,), 1e-3), tf))


@pytest.mark.parametrize("pattern", ["one_warp", "mid_occlusion",
                                     "dead_mixed"])
@pytest.mark.parametrize("name", ["terrain5k", "lights500"])
def test_trace_any_kernel_warp_patterns(cuda, name, pattern):
    """K6 against its plain version, 0 mismatches, where its warp-level
    shortcuts fire: packets of which one warp reaches the clusters (the
    per-warp slab skip, cull mode 5 on the terrain), lanes occluded in the
    middle of a warp's row loop, and dead lanes among live ones; the
    terrain (79 clusters: mode 5) and the many-lights room (9: no cull)."""
    scene = terrain_scene(cuda, 5_000) if name == "terrain5k" \
        else many_lights_scene(cuda, 500)
    pk = _packets(scene, _pattern_rays(scene, cuda, pattern))
    got = ct.any_packets(scene.cluster_tris, scene.cluster_min,
                         scene.cluster_max, pk)
    want = ct.trace_any_ref(scene.cluster_tris, pk)
    assert int((got != want).sum()) == 0
    live = pk.tfar >= pk.tnear
    assert 0 < int(want.sum()) < int(live.sum())


def test_trace_any_kernel_max_face_plane(cuda):
    """Rays lying in the plane of a patch's max-x face (d_x = 0), from
    above onto its edge there: the plain test finds the hits, and K6 with
    cull mode 5 must too. The JAX kernel's slab test sends such rays out
    of the box at t = 0, so a cull on it misses them (most of them in a
    block vote; tests/test_torch_any_skips.py)."""
    scene = patches_scene(cuda)
    pk = _packets(scene, max_face_rays(cuda))
    got = ct.any_packets(scene.cluster_tris, scene.cluster_min,
                         scene.cluster_max, pk)
    want = ct.trace_any_ref(scene.cluster_tris, pk)
    assert int(want.sum()) > pk.n_rays // 2
    assert int((got != want).sum()) == 0


def test_trace_factor4_matches_factor1(cuda):
    """Superclusters (factor 4: closest-hit cull mode 5) give the flat
    result exactly, through the wrappers."""
    scene = terrain_scene(cuda, 20_000)
    o, d, tn, tf = _cluster_rays(cuda, 50_000, 35, 5.0, 1e4)
    args = (scene.cluster_tris, scene.cluster_min, scene.cluster_max, o, d,
            tn)
    for a, b in zip(ct.trace_closest(*args, tf, factor=1),
                    ct.trace_closest(*args, tf, factor=4)):
        assert torch.equal(a, b)
    tfs = torch.full_like(tf, 3.0)
    assert torch.equal(ct.trace_any(*args, tfs, factor=1),
                       ct.trace_any(*args, tfs, factor=4))


def test_trace_dead_packets(cuda):
    """Packets of dead rays only: every ray misses and is visible."""
    scene = terrain_scene(cuda, 5_000)
    o, d, tn, tf = _cluster_rays(cuda, 1024, 8, 4.0, 1e4)
    tf = torch.full_like(tf, -1.0)
    t, _u, _v, tri = ct.trace_closest(scene.cluster_tris, scene.cluster_min,
                                      scene.cluster_max, o, d, tn, tf)
    assert bool((tri == -1).all()) and bool(torch.isinf(t).all())
    assert not ct.trace_any(scene.cluster_tris, scene.cluster_min,
                            scene.cluster_max, o, d, tn, tf).any()


def test_ptrace_gradient_cuda_matches_cpu(cuda):
    """The detached-winner gradient through the clustered closest query:
    K5's winners are the plain version's, so (go, gd) agree at 1e-6."""
    from tpu_restir_torch.config import IntersectorConfig
    from tpu_restir_torch.render import intersect
    o, d, tn, _tf = _cluster_rays(cuda, 20_000, 12, 4.0, 1e4)
    wts = torch.randn((3, o.shape[0]), device=cuda)
    grads = {}
    for dev in ("cuda", "cpu"):
        scene = terrain_scene(dev, 3_000)
        oo = o.to(dev).requires_grad_(True)
        dd = torch.nan_to_num(d).to(dev).requires_grad_(True)
        h = intersect.intersect_closest(scene, oo, dd, 1e-3, 1e4,
                                        IntersectorConfig(backend="ptrace"))
        w = wts.to(dev)
        loss = (torch.where(h.hit, h.t, 0.0) * w[0] + h.u * w[1]
                + h.v * w[2]).sum()
        grads[dev] = [x.cpu() for x in torch.autograd.grad(loss, (oo, dd))]
    assert float(grads["cpu"][0].abs().max()) > 0.0
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# --- K9, phase 1's keys ------------------------------------------------------

def _plain_pack(*args):
    """`pack` with the plain key build in place of K9."""
    keep = ct.packet_keys
    ct.packet_keys = ct.shortlist_keys
    try:
        return ct.pack(*args)
    finally:
        ct.packet_keys = keep


@pytest.mark.parametrize("case", K9_CASES)
def test_shortlist_keys_kernel_matches_plain(cuda, case):
    """K9 against `shortlist_keys` on the same CUDA tensors: keys equal as
    int32 bits, counts equal; through `pack`, count, shortlist and entry
    equal the plain key build's, with one K9 launch a pack of rays."""
    cmin, cmax, rays, factor, packed = phase1_case(cuda, case)
    if packed:
        before = tracing.COUNTS["launch.shortlist_keys"]
        pk = ct.pack(cmin, cmax, *rays, factor)
        launched = tracing.COUNTS["launch.shortlist_keys"] - before
        assert launched == (1 if pk.count.shape[0] else 0)
        want = _plain_pack(cmin, cmax, *rays, factor)
        for name in ("count", "shortlist", "entry", "tfar"):
            a, b = getattr(pk, name), getattr(want, name)
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.int32), b.view(torch.int32)), name
        smin, smax = ct._super_boxes(cmin, cmax, factor)
        args = (pk.o, pk.d, pk.tnear, pk.tfar, smin.contiguous(),
                smax.contiguous())
    else:
        args = (*rays, cmin, cmax)
    key, count = ct.packet_keys(*args)
    want_key, want_count = ct.shortlist_keys(*args)
    torch.cuda.synchronize()
    assert key.dtype == torch.float32 and count.dtype == torch.int32
    assert key.shape == want_key.shape and count.shape == want_count.shape
    assert int((key.view(torch.int32) != want_key.view(torch.int32))
               .sum()) == 0
    assert torch.equal(count, want_count)
    if case not in ("Rp0", "nan_inf"):
        assert int(count.sum()) > 0
    if case == "signed_zero_planes":
        assert bool((key == 0.0).any())


def test_pack_on_cuda_opens_the_keys_span_and_launches_k9_once(cuda):
    """On CUDA tensors phase 1's keys are one K9 launch inside the span
    `phase1.keys` (the plain version's `phase1.interval` and
    `phase1.boxcull` stay shut), after the span of the (super)cluster and
    scene boxes and before the sort's span, each once a pack."""
    from torch.profiler import ProfilerActivity, profile
    lo, hi, *rays = box_rays(cuda, 300, 3 * ct.P + 5, 9)
    before = tracing.COUNTS["launch.shortlist_keys"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ct.pack(lo, hi, *rays, 1)
        ct.pack(lo, hi, *(x[:300] for x in rays), 1)
    assert tracing.COUNTS["launch.shortlist_keys"] == before + 2
    spans = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.name.startswith("phase1.")]
    assert spans == ["phase1.superboxes", "phase1.keys", "phase1.sort"] * 2


def test_shortlist_keys_kernel_refuses_bad_inputs(cuda):
    lo, hi, o, d, tn, tf = box_rays(cuda, 10, 2 * ct.P, 10)
    bad = [(o[:300], d[:300], tn[:300], tf[:300], lo, hi),
           (o, d, tn.double(), tf, lo, hi),
           (o, d.t().contiguous().t(), tn, tf, lo, hi),
           (o, d, tn, tf, lo[:, :2].contiguous(), hi),
           (o, d, tn, tf, lo.cpu(), hi.cpu())]
    for args in bad:
        with pytest.raises(ValueError):
            ct.packet_keys(*args)


def _woop_terrain(dev, n):
    """terrain_scene(n) rebuilt at cluster size 128 (Woop blocks)."""
    from tpu_restir_torch.scene.procedural import TERRAIN_SPECS
    from tpu_restir_torch.scene.scene import build_scene
    t = terrain_scene("cpu", n)
    return build_scene(t.tri_v.numpy(), t.tri_mat.numpy(), TERRAIN_SPECS,
                       dev, cluster_size=128)


@pytest.mark.parametrize("n", [1, 700, 100_003])
def test_trace_closest_mxu_kernel_matches_plain(cuda, n):
    """K7 against its plain version on every ray (terrain_scene(5_000) at
    cluster size 128: 40 clusters)."""
    scene = _woop_terrain(cuda, 5_000)
    pk = _packets(scene, _cluster_rays(cuda, n, n, 4.0, 1e4, 0.1))
    before = tracing.COUNTS["launch.trace_closest_mxu"]
    got = ct.closest_packets_mxu(scene.cluster_woop, pk)
    assert tracing.COUNTS["launch.trace_closest_mxu"] == before + 1
    want = ct.trace_closest_mxu_ref(scene.cluster_woop, pk)
    torch.cuda.synchronize()
    assert got[3].dtype == torch.int32
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if n > 1:
        assert 0 < int((got[3] >= 0).sum()) < n


def test_trace_any_mxu_kernel_matches_plain(cuda):
    """K8 against its plain version; dead rays are never occluded."""
    scene = _woop_terrain(cuda, 5_000)
    rays = _cluster_rays(cuda, 100_003, 3, 4.0, 2.0, 0.1)
    pk = _packets(scene, rays)
    before = tracing.COUNTS["launch.trace_any_mxu"]
    got = ct.any_packets_mxu(scene.cluster_woop, scene.cluster_min,
                             scene.cluster_max, pk)
    assert tracing.COUNTS["launch.trace_any_mxu"] == before + 1
    want = ct.trace_any_mxu_ref(scene.cluster_woop, pk)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert 0 < int(got.sum()) < got.numel()
    assert not got[:pk.n_rays][rays[3] < rays[2]].any()


@pytest.fixture(scope="module")
def woop_terrain10k():
    """terrain_scene(10_000) at cluster size 128: 79 clusters, so that K8
    culls (mode 5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _woop_terrain(torch.device("cuda"), 10_000)


@pytest.mark.parametrize("name", ANY_FAMILIES)
def test_trace_mxu_kernels_ray_families(cuda, woop_terrain10k, name):
    """K7 bit for bit and K8 with 0 mismatches against their plain
    versions, on the rays of each family (random, shared-edge, tiny-det,
    u-above-1, v = -0.0 and box-grazing rays; their own triangles left
    out) over the Woop terrain, where K8 culls (mode 5) on its grown
    boxes; and on the same rays as segments ending halfway, so that K8
    meets occluded and visible rays."""
    scene = woop_terrain10k
    assert ct._skip_for("any", scene.cluster_woop.shape[0]) == 5
    o, d, tn, tf = (torch.from_numpy(x).to(cuda)
                    for x in family(name, n=20_000)[1:])
    pk = _packets(scene, (o, d, tn, tf))
    got = ct.closest_packets_mxu(scene.cluster_woop, pk)
    want = ct.trace_closest_mxu_ref(scene.cluster_woop, pk)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    t = want[0][:pk.n_rays]
    for tfar in (tf, torch.where(torch.isfinite(t), t * 0.5, tf)):
        pk = _packets(scene, (o, d, tn, tfar.contiguous()))
        got = ct.any_packets_mxu(scene.cluster_woop, scene.cluster_min,
                                 scene.cluster_max, pk)
        want = ct.trace_any_mxu_ref(scene.cluster_woop, pk)
        assert int((got != want).sum()) == 0


@pytest.mark.parametrize("pattern", ["one_warp", "mid_occlusion",
                                     "dead_mixed"])
def test_trace_any_mxu_kernel_warp_patterns(cuda, woop_terrain10k, pattern):
    """K8 against its plain version, 0 mismatches, where its warp-level
    shortcuts fire (the patterns of test_trace_any_kernel_warp_patterns)
    on the Woop terrain, cull mode 5."""
    scene = woop_terrain10k
    pk = _packets(scene, _pattern_rays(scene, cuda, pattern))
    got = ct.any_packets_mxu(scene.cluster_woop, scene.cluster_min,
                             scene.cluster_max, pk)
    want = ct.trace_any_mxu_ref(scene.cluster_woop, pk)
    assert int((got != want).sum()) == 0
    live = pk.tfar >= pk.tnear
    assert 0 < int(want.sum()) < int(live.sum())


def test_trace_any_mxu_kernel_max_face_plane(cuda):
    """The rays of test_trace_any_kernel_max_face_plane on the patches at
    cluster size 128 (81 clusters: K8 culls, mode 5): the plain Woop test
    finds the hits, and K8 must too."""
    scene = patches_scene(cuda, block=128)
    c = scene.cluster_woop.shape[0]
    assert ct._skip_for("any", c) == 5
    # most of the rays' planes are a cluster box's max-x face
    faces = set(scene.cluster_max[:, 0].tolist())
    assert sum(1.5 * i + 1.0 in faces for i in range(79)) > 60
    pk = _packets(scene, max_face_rays(cuda))
    got = ct.any_packets_mxu(scene.cluster_woop, scene.cluster_min,
                             scene.cluster_max, pk)
    want = ct.trace_any_mxu_ref(scene.cluster_woop, pk)
    assert int(want.sum()) > pk.n_rays // 2
    assert int((got != want).sum()) == 0


def test_ptrace_mxu_selects_k7_k8(cuda):
    """Through the query: ptrace_mxu on a cluster-size-128 scene launches
    K7/K8 and not K5/K6, once per chunk; their dead-packet results miss."""
    from tpu_restir_torch.config import IntersectorConfig
    from tpu_restir_torch.render import intersect
    scene = _woop_terrain(cuda, 5_000)
    o, d, tn, tf = _cluster_rays(cuda, 20_000, 9, 4.0, 1e4)
    cfg = IntersectorConfig(backend="ptrace", ptrace_mxu=True,
                            ptrace_chunk=8192)
    before = tracing.COUNTS.copy()
    h = intersect.intersect_closest(scene, o, d, tn, tf, cfg)
    occ = intersect.intersect_any(scene, o, d, tn, torch.full_like(tf, 2.0),
                                  cfg)
    torch.cuda.synchronize()
    grew = {k: tracing.COUNTS["launch." + k] - before["launch." + k]
            for k in ("trace_closest", "trace_any", "trace_closest_mxu",
                      "trace_any_mxu")}
    assert grew == {"trace_closest": 0, "trace_any": 0,
                    "trace_closest_mxu": 3, "trace_any_mxu": 3}
    assert 0 < int(h.hit.sum()) < 20_000 and 0 < int(occ.sum()) < 20_000
    dead = torch.full_like(tf, -1.0)
    t, _u, _v, tri = ct.trace_closest(scene.cluster_tris, scene.cluster_min,
                                      scene.cluster_max, o, d, tn, dead,
                                      cwoop=scene.cluster_woop)
    assert bool((tri == -1).all()) and bool(torch.isinf(t).all())


@pytest.mark.parametrize("shape", [(7,), (12, 16, 5), (1080, 1920, 3)])
def test_threefry_uniform_cuda_equals_cpu(cuda, shape):
    """rng.uniform is the same int64 arithmetic on both devices: bit for
    bit equal draws."""
    from tpu_restir_torch import rng
    k = rng.draw_key(rng.frame_key(123, 4), 9)
    got = rng.uniform(k, shape, cuda).cpu().numpy().view(np.uint32)
    want = rng.uniform(k, shape, "cpu").numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("integrator,kw", [
    ("naive", {}), ("nee", dict(direct_strategy="mis"))])
def test_path_frame_cuda_matches_cpu(cuda, integrator, kw):
    """A 64x32 naive or NEE-MIS frame (default bounces) through K1/K2 on
    the card and the plain versions on the CPU: allclose at rtol 1e-4,
    atol 1e-5 on at least 99% of the pixels (CUDA and the CPU round sin,
    cos and pow otherwise, which can flip a pixel's path), as chip_smoke's
    [integrators] phase holds them."""
    from tpu_restir_torch import rng
    from tpu_restir_torch.renderer import _render_frame
    cfg = RenderConfig(
        camera=CameraConfig(width=64, height=32, fov_y_deg=45.0,
                            view_from=(0.0, -3.9, 1.0),
                            view_at=(0.0, 0.0, 1.0), pixel_sampler="random"),
        params=RenderParams(use_skybox=False), integrator=integrator, **kw)
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        before = tracing.COUNTS["launch.closest_hit"]
        imgs.append(_render_frame(cornell_box(dev),
                                  cam_mod.make_camera(cfg.camera, dev), cfg,
                                  rng.frame_key(0, 3)).cpu())
        launched = tracing.COUNTS["launch.closest_hit"] - before
        # one closest-hit query a vertex, NEE-MIS one more for its BRDF
        # sample, each one launch on the card
        want = {"naive": 6, "nee": 12}[integrator]
        assert launched == (want if dev.type == "cuda" else 0), launched
    assert torch.isfinite(imgs[0]).all()
    close = torch.isclose(imgs[0], imgs[1], rtol=1e-4, atol=1e-5).all(-1)
    assert float(close.float().mean()) >= 0.99, float(close.float().mean())


def test_demo_frame_and_texel_gradient_cuda_match_cpu(cuda):
    """The demo asset loaded on the card (78 triangles through K1/K2, its
    texture stack and sky on the device): one 64x32 ReSTIR frame's loss and
    its texel gradient against the CPU run, as chip_smoke's [demo] phase
    holds them (loss at rtol 1e-4, gradients at rtol 1e-3 plus 1e-3 of the
    largest entry: CUDA's index_put_ backward of the texel gathers sums
    atomically, in another order than the CPU)."""
    import chip_smoke
    from tpu_restir_torch.diff.params import extract_params
    from tpu_restir_torch.diff.render import make_value_and_grad
    cfg = chip_smoke.demo_cfg(64, 32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene = chip_smoke.demo_scene(dev)
        assert scene.textures.data.device.type == dev.type
        assert scene.envmap.device.type == dev.type
        before = tracing.COUNTS["launch.closest_hit"]
        vg = make_value_and_grad(scene, cam_mod.make_camera(cfg.camera, dev),
                                 cfg, (1,), torch.zeros((32, 64, 3),
                                                        device=dev))
        loss, grads = vg(extract_params(scene, ("tex_data",)))
        launched = tracing.COUNTS["launch.closest_hit"] - before
        assert (launched > 0) == (dev.type == "cuda"), launched
        out[dev.type] = (float(loss), grads["tex_data"].cpu())
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    assert torch.isfinite(gc).all() and (gp != 0).any()
    scale = float(gp.abs().max())
    assert bool(((gc - gp).abs() <= 1e-3 * gp.abs() + 1e-3 * scale).all())


# the backends that are plain tensor code (render/intersect.py), each on a
# scene it serves: the same operations on either device, so every result
# is bit for bit the CPU's, and no kernel launches
BACKEND_SCENES = {
    "cornell": lambda dev: cornell_box(dev),
    "lights500": lambda dev: many_lights_scene(dev, 500),
    "terrain5k": lambda dev: terrain_scene(dev, 5_000),
}


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("name,backend", [
    ("cornell", "brute"), ("cornell", "woop_mxu"), ("lights500", "cluster"),
    ("lights500", "fcluster"), ("lights500", "bvh"),
    ("terrain5k", "fcluster"), ("terrain5k", "bvh")])
def test_backend_query_cuda_matches_cpu(cuda, name, backend, kind):
    """Each fallback backend's closest and any query on 4,096 rays, cuda
    against cpu: ids, masks and t, u, v equal."""
    from tpu_restir_torch.config import IntersectorConfig
    from tpu_restir_torch.render import intersect
    o, d, tn, tf = _cluster_rays(cuda, 4096, 17, 3.0,
                                 1e4 if kind == "closest" else 1.5)
    cfg = IntersectorConfig(backend=backend)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene = BACKEND_SCENES[name](dev)
        before = tracing.counted("launch.")
        args = (o.to(dev), d.to(dev), tn.to(dev), tf.to(dev), cfg)
        if kind == "closest":
            h = intersect.intersect_closest(scene, *args)
            out[dev.type] = [x.cpu() for x in (h.tri, h.t, h.u, h.v)]
        else:
            out[dev.type] = [intersect.intersect_any(scene, *args).cpu()]
        assert tracing.counted("launch.") == before
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    hit = out["cpu"][0] >= 0 if kind == "closest" else out["cpu"][0]
    assert 0 < int(hit.sum()) < hit.numel()
