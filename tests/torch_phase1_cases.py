"""Inputs on which the tests hold phase 1's keys: K9 against its plain
version `shortlist_keys` on the card (tests/test_torch_cuda.py), and the
emulation of K9's early exits, `chip_smoke.key_work`, against it on the CPU
(tests/test_torch_roofline.py). Also the patches scene and the rays in
the plane of a box's max face, on which the any-hit kernels are held.
Every case is made from seeds on the device given."""

import numpy as np
import torch

from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.scene.procedural import TERRAIN_SPECS, terrain_scene
from tpu_restir_torch.scene.scene import build_scene

def patches_scene(dev, n=80, block=64):
    """n flat 1 x 2 patches of `block` triangles each (4 x block / 8 cells
    with edges along x and y), 0.5 apart along x, and a 2-triangle light,
    built at cluster size `block`: 81 clusters (cull mode 5), and no
    triangle beyond a patch's max-x face."""
    tris = []
    ny = block // 8
    for i in range(n):
        xs = np.linspace(1.5 * i, 1.5 * i + 1.0, 5)
        ys = np.linspace(0.0, 2.0, ny + 1)
        for a in range(4):
            for b in range(ny):
                p00, p10 = [xs[a], ys[b], 0.0], [xs[a + 1], ys[b], 0.0]
                p11, p01 = [xs[a + 1], ys[b + 1], 0.0], [xs[a], ys[b + 1], 0.0]
                tris += [[p00, p10, p11], [p00, p11, p01]]
    panel = [[[0, 0, 5.0], [1, 1, 5.0], [1, 0, 5.0]],
             [[0, 0, 5.0], [0, 1, 5.0], [1, 1, 5.0]]]
    mats = np.concatenate([np.zeros(len(tris), np.int32),
                           np.ones(2, np.int32)])
    return build_scene(np.array(tris + panel, np.float32), mats,
                       TERRAIN_SPECS, dev, cluster_size=block)


def max_face_rays(dev, n=16 * ct.P):
    """Rays lying in the plane x = 1.5 i + 1 of patch i's max-x face (d_x
    = 0), from above onto its edge there."""
    g = torch.Generator().manual_seed(3)
    x = 1.5 * (torch.arange(n) // ct.P % 79) + 1.0
    o = torch.stack([x, 0.1 + 1.8 * torch.rand((n,), generator=g),
                     torch.ones(n)], 1)
    d = torch.stack([torch.zeros(n),
                     (torch.rand((n,), generator=g) - 0.5) * 0.2,
                     -torch.ones(n)], 1)
    d = d / d.norm(dim=-1, keepdim=True)
    return tuple(v.to(dev).contiguous() for v in
                 (o, d, torch.full((n,), 1e-3), torch.full((n,), 1e4)))


K9_CASES = ["terrain_primary", "terrain_shadow", "terrain_bounce",
            "dead_and_padding", "nan_inf", "max_face_plane",
            "signed_zero_planes", "factor4", "C1", "C63", "C64", "C65",
            "C257", "C4096", "Rp0", "Rp1"]


def terrain_queries(dev, kind):
    """Rays of the three query kinds of a terrain frame from the bench's
    terrain camera (0, -7, 4) on terrain_scene(20_000), 32 packets of 256:
    primary rays, each packet's toward a patch of the terrain 0.5 wide, as
    a tile of pixels; from their hits (K5), shadow segments toward random
    points of the sun panel, and bounce rays into the upper hemisphere, a
    tenth of them dead (rays that miss are dead already)."""
    scene = terrain_scene(dev, 20_000)
    g = torch.Generator(device=dev)
    g.manual_seed(41)
    n = 32 * ct.P
    o = torch.tensor([0.0, -7.0, 4.0], device=dev).expand(n, 3)
    centre = (torch.rand((32, 1, 3), generator=g, device=dev)
              * torch.tensor([9.0, 9.0, 1.6], device=dev)
              - torch.tensor([4.5, 4.5, 0.0], device=dev))
    target = (centre + 0.25 * (torch.rand((32, ct.P, 3), generator=g,
                                          device=dev) * 2 - 1)).reshape(n, 3)
    d = target - o
    d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    tn = torch.zeros((n,), device=dev)
    tf = torch.full((n,), float("inf"), device=dev)
    if kind == "terrain_primary":
        return scene, (o.contiguous(), d, tn, tf)
    t, _u, _v, tri = ct.trace_closest(scene.cluster_tris, scene.cluster_min,
                                      scene.cluster_max, o, d, tn, tf)
    hit = tri >= 0
    p = torch.where(hit[:, None], o + t[:, None] * d, 0.0)
    if kind == "terrain_shadow":
        panel = scene.tri_v[scene.lights.tri_idx.long()].reshape(-1, 3)
        lo, hi = panel.amin(0), panel.amax(0)
        q = lo + torch.rand((n, 3), generator=g, device=dev) * (hi - lo)
        s = q - p
        dist = s.norm(dim=-1)
        sd = (s / dist[:, None]).contiguous()
        return scene, (p.contiguous(), sd, torch.full_like(dist, 1e-3),
                       torch.where(hit, dist - 1e-3, -1.0))
    b = torch.randn((n, 3), generator=g, device=dev)
    b[:, 2] = b[:, 2].abs()
    b = (b / b.norm(dim=-1, keepdim=True)).contiguous()
    dead = ~hit | (torch.rand((n,), generator=g, device=dev) < 0.1)
    return scene, (p.contiguous(), b, torch.full_like(t, 1e-3),
                   torch.where(dead, -1.0, float("inf")))


def box_rays(dev, n_boxes, n_rays, seed):
    """n_boxes random boxes in [-1, 1]^3 and n_rays rays in packets of
    256: each packet's from a patch above the boxes (0.1 wide) toward a
    patch 0.2 wide about a box's centre, every fifth packet's in any
    direction."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lo = torch.rand((n_boxes, 3), generator=g, device=dev) * 1.8 - 1.0
    hi = lo + 0.02 + torch.rand((n_boxes, 3), generator=g, device=dev) * 0.3
    k = torch.arange(n_rays, device=dev) // ct.P
    n_pk = -(-n_rays // ct.P)
    src = torch.rand((n_pk, 3), generator=g, device=dev) * 0.5 \
        + torch.tensor([-0.25, -0.25, 2.5], device=dev)

    def jitter(w):
        return w * (torch.rand((n_rays, 3), generator=g, device=dev) - 0.5)

    o = src[k] + jitter(0.1)
    # aimed at a box's centre (the first box's for half the packets)
    box = torch.randint(0, n_boxes, (n_pk,), generator=g, device=dev)
    box = torch.where(torch.arange(n_pk, device=dev) % 2 == 0, 0, box)
    dst = (lo[box] + hi[box]) / 2
    d = torch.where((k % 5 == 4)[:, None],
                    torch.randn((n_rays, 3), generator=g, device=dev),
                    dst[k] + jitter(0.2) - o)
    d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    return (lo.contiguous(), hi.contiguous(), o.contiguous(), d,
            torch.zeros((n_rays,), device=dev),
            torch.full((n_rays,), 1e4, device=dev))


def phase1_case(dev, case):
    """(cmin, cmax, rays, factor, packed): the rays go through `pack`
    (scene-box clamp and padding) when packed, else straight to the keys
    (a multiple of 256 rays, raw bounds: tfar = inf, NaN, -inf tnear)."""
    if case.startswith("terrain_"):
        scene, rays = terrain_queries(dev, case)
        return scene.cluster_min, scene.cluster_max, rays, 1, True
    if case == "factor4":
        scene, rays = terrain_queries(dev, "terrain_primary")
        return scene.cluster_min, scene.cluster_max, rays, 4, True
    if case == "max_face_plane":
        scene = patches_scene(dev)
        return (scene.cluster_min, scene.cluster_max, max_face_rays(dev),
                1, True)
    if case == "dead_and_padding":
        lo, hi, *rays = box_rays(dev, 300, 5 * ct.P + 77, 3)
        o, d, tn, tf = rays
        g = torch.Generator(device=dev)
        g.manual_seed(4)
        dead = torch.rand((o.shape[0],), generator=g, device=dev) < 0.3
        dead[:ct.P] = True                       # a dead packet
        d = torch.where(dead[:, None], 0.0, d).contiguous()
        return lo, hi, (o, d, tn, torch.where(dead, -1.0, tf)), 1, True
    if case == "nan_inf":
        lo, hi, o, d, tn, tf = box_rays(dev, 300, 12 * ct.P, 5)
        o, d, tn, tf = (x.clone() for x in (o, d, tn, tf))
        nan, inf = float("nan"), float("inf")
        # packets 0-3: unbounded (tfar = inf, so NaN points at fraction 0);
        # 4: a NaN direction and an inf origin among live rays; 5: NaN
        # and inf bounds; 6: tnear = -inf; 7: all NaN directions; 8: an
        # inf direction; 9-11 plain
        tf[:4 * ct.P:3] = inf
        d[4 * ct.P + 5, 1] = nan
        o[4 * ct.P + 9, 0] = inf
        tf[5 * ct.P + 1] = nan
        tn[5 * ct.P + 2] = nan
        tf[5 * ct.P + 3] = inf
        tn[6 * ct.P:7 * ct.P:2] = -inf
        d[7 * ct.P:8 * ct.P] = nan
        d[8 * ct.P + 7, 2] = -inf
        return lo, hi, (o, d, tn, tf), 1, False
    if case == "signed_zero_planes":
        # origins at x = +0 or -0 and tnear +0 or -0 (one sign a packet)
        # inside the boxes along y and z, on a box face at x = +0 or -0,
        # directions of one x sign a packet: plane distances and keys of
        # zero with either sign
        n = 8 * ct.P
        g = torch.Generator(device=dev)
        g.manual_seed(6)
        k = torch.arange(n, device=dev) // ct.P
        o = torch.stack([torch.where(k % 2 == 0, 0.0, -0.0),
                         torch.rand((n,), generator=g, device=dev) - 0.5,
                         torch.rand((n,), generator=g, device=dev) - 0.5], 1)
        d = torch.stack([torch.where(k % 4 < 2, 1.0, -1.0),
                         torch.rand((n,), generator=g, device=dev) - 0.5,
                         torch.rand((n,), generator=g, device=dev) - 0.5], 1)
        d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
        tn = torch.where(k < 4, 0.0, -0.0)
        j = torch.arange(64, device=dev) % 4
        lo = torch.full((64, 3), -1.0, device=dev)
        hi = torch.full((64, 3), 1.0, device=dev)
        lo[:, 0] = torch.where(j == 0, 0.0, torch.where(j == 1, -0.0, -0.4))
        hi[:, 0] = torch.where(j == 2, 0.0, torch.where(j == 3, -0.0, 0.4))
        return (lo, hi, (o.contiguous(), d, tn,
                         torch.full((n,), 1e4, device=dev)), 1, False)
    if case.startswith("C"):
        lo, hi, *rays = box_rays(dev, int(case[1:]), 6 * ct.P + 13, 7)
        return lo, hi, tuple(rays), 1, True
    n = {"Rp0": 0, "Rp1": 100}[case]
    lo, hi, *rays = box_rays(dev, 40, n, 8)
    return lo, hi, tuple(rays), 1, True
