"""The operation order that K10 (`csrc/ibeta.cu`) shares with its plain
version `mathx.special._beta_cf`, held on the CPU.

K10 equals the plain version on the card bit for bit only because it
computes the same float64 operations in the same order, each rounded
once (it builds with --fmad=false). `k10_beta_cf` below transcribes the
kernel's Lentz loop line for line into Python, whose floats are IEEE
float64 with no contraction; it must equal `_beta_cf` on CPU float64
tensors bit for bit over a grid of (a, b, x), and its lines must be the
kernel's own, so that an edit to either side that changes a rounding
shows here. The CPU path of `calc_i_m` never launches K10.
"""

import math
from pathlib import Path

import pytest
import torch

from tpu_restir_torch import tracing
from tpu_restir_torch.kernels import ibeta as k10
from tpu_restir_torch.mathx import special

SOURCE = Path(special.__file__).resolve().parents[1] / "csrc" / "ibeta.cu"
TINY = 1e-300

# K10's Lentz loop, as csrc/ibeta.cu writes it; the Python below runs
# these very expressions
KERNEL_LINES = (
    "const double qab = a + b, qap = a + 1.0, qam = a - 1.0;",
    "double d = 1.0 / nonzero(1.0 - qab * x / qap);",
    "for (int m = 1; m <= kSteps; ++m) {",
    "const double fm = (double)m, m2 = 2.0 * fm;",
    "double aa = fm * (b - fm) * x / ((qam + m2) * (a + m2));",
    "aa = -(a + fm) * (qab + fm) * x / ((a + m2) * (qap + m2));",
    "d = 1.0 / nonzero(1.0 + aa * d);",
    "c = nonzero(1.0 + aa / c);",
    "h = h * d * c;",
    "return fabs(v) < kTiny ? kTiny : v;",
    "constexpr int kSteps = 64;",
)


def nonzero(v):
    return TINY if abs(v) < TINY else v


def k10_beta_cf(a, b, x):
    """csrc/ibeta.cu `beta_cf` on Python floats, in the kernel's order."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 / nonzero(1.0 - qab * x / qap)
    h = d
    for m in range(1, 65):
        fm = float(m)
        m2 = 2.0 * fm
        aa = fm * (b - fm) * x / ((qam + m2) * (a + m2))
        d = 1.0 / nonzero(1.0 + aa * d)
        c = nonzero(1.0 + aa / c)
        h = h * d * c
        aa = -(a + fm) * (qab + fm) * x / ((a + m2) * (qap + m2))
        d = 1.0 / nonzero(1.0 + aa * d)
        c = nonzero(1.0 + aa / c)
        h = h * d * c
    return h


def _xs(a, b):
    edge = (a + 1.0) / (a + b + 2.0)
    return [0.0, 5e-324, 1e-300, 1e-12, 1e-3, 0.1, 0.25, 0.4, 0.5, 0.6,
            0.75, 0.9, 0.99, 1.0 - 1e-12, 1.0, edge,
            math.nextafter(edge, 0.0), math.nextafter(edge, 1.0)]


def test_transcription_is_the_kernels_source():
    src = SOURCE.read_text()
    for line in KERNEL_LINES:
        assert line in src, line
    assert special._CF_STEPS == 64 and special._TINY == TINY


@pytest.mark.parametrize("b", [0.5, 2.0])
@pytest.mark.parametrize("a", [1e-12, 1e-6, 0.05, 0.5, 1.0, 2.5, 10.0,
                               32.0, 64.0, 64.5, 500.0])
def test_k10_loop_equals_beta_cf_bit_for_bit(a, b):
    xs = _xs(a, b)
    x = torch.tensor(xs, dtype=torch.float64)
    want = special._beta_cf(torch.full_like(x, a), torch.full_like(x, b), x)
    got = torch.tensor([k10_beta_cf(a, b, v) for v in xs],
                       dtype=torch.float64)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64)), \
        [(v, g, w) for v, g, w in zip(xs, got.tolist(), want.tolist())
         if g != w]


def test_lane_operand_reads_a_broadcast_value_in_place():
    half = torch.tensor(0.5, dtype=torch.float64)
    x = torch.rand((6, 4), dtype=torch.float64).t()
    a = torch.rand((6, 1), dtype=torch.float64)
    aa, bb, xx = torch.broadcast_tensors(a.t(), half, x)
    t, step = k10.lane_operand(bb)
    assert step == 0 and t.data_ptr() == half.data_ptr()
    for op in (xx, aa):
        t, step = k10.lane_operand(op)
        assert step == 1 and t.is_contiguous() and torch.equal(t, op)


def test_cpu_calc_i_m_launches_no_kernel():
    before = tracing.COUNTS["launch.ibeta"]
    v = special.calc_i_m(torch.rand(64), torch.rand(64) * 128.0)
    assert bool(torch.isfinite(v).all())
    assert tracing.COUNTS["launch.ibeta"] == before
