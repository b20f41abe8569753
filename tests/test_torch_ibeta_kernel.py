"""K10, the incomplete beta of the Phong normalization (`kernels/ibeta.py`,
`csrc/ibeta.cu`), against its plain version `mathx.special._ibeta_value`
on the same CUDA tensors. Needs a CUDA card (marker `gpu`); skipped
without one. The file imports nothing of JAX, so it also runs where JAX
is absent:

    python -m pytest --noconftest -q tests/test_torch_ibeta_kernel.py

Tolerance: none. The kernel keeps the plain version's operations in their
order and builds with --fmad=false, and PyTorch runs each operation of
the plain version as its own kernel with the same device math library,
so both round every step alike: float64 and float32 results are compared
bit for bit (a NaN lane only as NaN on both sides).
"""

import math

import pytest
import torch

from tpu_restir_torch import mathx, tracing
from tpu_restir_torch.kernels import ibeta as k10
from tpu_restir_torch.mathx import special

pytestmark = pytest.mark.gpu

AS = [1e-12, 1e-6, 0.05, 0.5, 1.0, 2.5, 10.0, 31.5, 32.0, 64.0, 64.5, 100.0,
      1000.0, 1e4]
XS = [0.0, 5e-324, 1e-300, 1e-12, 0.01, 0.25, 0.5, 0.75, 0.99, 1.0 - 1e-12,
      1.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mismatches(got, want):
    """Lanes whose bits differ (NaN on both sides counts as equal)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    same = (got.view(ints[got.dtype]) == want.view(ints[want.dtype])) \
        | (torch.isnan(got) & torch.isnan(want))
    return int((~same).sum())


def _grid(b, dev):
    """(x, a, b) float64 over AS x (XS, the swap boundary (a + 1) /
    (a + b + 2) and its float64 neighbours)."""
    rows = []
    for a in AS:
        edge = (a + 1.0) / (a + b + 2.0)
        for x in XS + [edge, math.nextafter(edge, 0.0),
                       math.nextafter(edge, 1.0)]:
            rows.append((x, a))
    t = torch.tensor(rows, dtype=torch.float64, device=dev)
    x, a = t[:, 0].contiguous(), t[:, 1].contiguous()
    return x, a, torch.full_like(x, b)


def _plain(monkeypatch):
    """Route `_IBetaX` on CUDA tensors to the plain version."""
    monkeypatch.setattr(k10, "ibeta", special._ibeta_value)


@pytest.mark.parametrize("b", [0.5, 2.0])
def test_k10_equals_plain_on_the_grid(cuda, b):
    x, a, bb = _grid(b, cuda)
    before = tracing.COUNTS["launch.ibeta"]
    got = k10.ibeta(x, a, bb)
    want = special._ibeta_value(x, a, bb)
    torch.cuda.synchronize()
    assert tracing.COUNTS["launch.ibeta"] == before + 1
    assert _mismatches(got, want) == 0
    assert _mismatches(got.to(torch.float32), want.to(torch.float32)) == 0
    assert bool(torch.isfinite(want).all())


def test_k10_reads_broadcast_operands_in_place(cuda):
    """b as one value broadcast to every lane (stride 0, as ibeta_nonnorm
    passes 0.5), a broadcast too, and x as a strided view: the same bits
    as the plain version on contiguous copies."""
    g = torch.Generator(device=cuda)
    g.manual_seed(25)
    x = torch.rand((64, 48), generator=g, device=cuda,
                   dtype=torch.float64).t()
    half = torch.tensor(0.5, dtype=torch.float64, device=cuda)
    for a in (torch.rand((48, 64), generator=g, device=cuda,
                         dtype=torch.float64) * 64.0,
              torch.tensor(3.5, dtype=torch.float64, device=cuda)):
        aa, bb, xx = torch.broadcast_tensors(a, half, x)
        assert k10.lane_operand(bb)[1] == 0 and k10.lane_operand(xx)[1] == 1
        got = k10.ibeta(xx, aa, bb)
        want = special._ibeta_value(xx.contiguous(), aa.contiguous(),
                                    bb.contiguous())
        assert _mismatches(got, want) == 0


def test_ibeta_nonnorm_clamps_a_and_counts_one_launch(cuda, monkeypatch):
    """ibeta_nonnorm from float32 inputs, a below 1e-12 (clamped) up to
    64 and beyond: float32 bits equal to the plain path, one K10 launch a
    call, and the x-gradient unchanged."""
    g = torch.Generator(device=cuda)
    g.manual_seed(250)
    n = 4096
    a = torch.cat([torch.tensor([0.0, 1e-20, 1e-13, 1e-12, 64.0, 64.5,
                                 500.0], device=cuda),
                   torch.rand((n - 7,), generator=g, device=cuda) * 80.0])
    x = torch.rand((n,), generator=g, device=cuda)
    x[:3] = torch.tensor([0.0, 1.0, 0.5])
    xg = x.clone().requires_grad_(True)
    before = tracing.COUNTS["launch.ibeta"]
    got = special.ibeta_nonnorm(xg, a, 0.5)
    assert tracing.COUNTS["launch.ibeta"] == before + 1
    gx = torch.autograd.grad(got.sum(), xg)[0]
    with monkeypatch.context() as m:
        _plain(m)
        xw = x.clone().requires_grad_(True)
        want = special.ibeta_nonnorm(xw, a, 0.5)
        gw = torch.autograd.grad(want.sum(), xw)[0]
    assert tracing.COUNTS["launch.ibeta"] == before + 1
    assert _mismatches(got.detach(), want.detach()) == 0
    assert _mismatches(gx, gw) == 0


def test_k10_on_a_terrain100k_gbuffer(cuda, monkeypatch):
    """The 1080p terrain100k G-buffer's own n_dot_v and shininess, as
    gbuffer_fill hands them to calc_i_m: K10's B_x and calc_i_m's value
    equal the plain path's bit for bit."""
    from tpu_restir_torch import rng
    from tpu_restir_torch.bench import SCENES, TERRAIN_VIEW, bench_cfg
    from tpu_restir_torch.render import camera as cam_mod
    from tpu_restir_torch.render.integrators.restir import gbuffer as gb_mod

    w, h = 1920, 1080
    scene = SCENES["terrain100k"][0](cuda)
    cfg = bench_cfg(w, h, TERRAIN_VIEW)
    cam = cam_mod.make_camera(cfg.camera, cuda)
    ys = torch.arange(h, dtype=torch.int32, device=cuda)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=cuda)[None, :].expand(h, w)
    got = []

    def capture(n_dot_v, n):
        got.append((n_dot_v, n))
        return special.calc_i_m(n_dot_v, n)

    monkeypatch.setattr(gb_mod, "calc_i_m", capture)
    gb_mod.gbuffer_fill(scene, cam, cfg, rng.make_frame_seed(0, 0), ys, xs)
    (n_dot_v, shin), = got
    assert n_dot_v.shape == (h, w)

    # B_x's operands as calc_i_m hands them to ibeta_nonnorm
    cost = n_dot_v.to(torch.float32)
    x, a, b = special.ibeta_operands(
        mathx.clip(1.0 - cost * cost, 0.0, 1.0), 0.5 * shin, 0.5)
    assert k10.lane_operand(b)[1] == 0
    kb = k10.ibeta(x, a, b)
    pb = special._ibeta_value(x, a, b)
    assert _mismatches(kb, pb) == 0
    assert _mismatches(kb.to(torch.float32), pb.to(torch.float32)) == 0

    kv = special.calc_i_m(n_dot_v, shin)
    _plain(monkeypatch)
    pv = special.calc_i_m(n_dot_v, shin)
    assert _mismatches(kv, pv) == 0
