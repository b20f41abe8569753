"""Vector math on tensors whose last axis is the 3-vector axis.

The counterpart of `tpu_restir.mathx`, cut to what the ReSTIR frame and
the naive and NEE path tracers call. Three-term sums are written out left
to right, the order in which XLA reduces a length-3 axis, so that the two
packages round alike.
"""

from __future__ import annotations

import functools

import torch

from perfbench.refrender.mathx.color import aces, srgb_compress  # noqa: F401
from perfbench.refrender.mathx.special import calc_i_m  # noqa: F401

_EPS = 1e-30


# tables of at most this many rows take the masked-sum backward
_MASKSUM_MAX_ROWS = 128


class _TakeRows(torch.autograd.Function):
    """`table[idx]` with the backward of `tpu_restir.mathx._rows_bwd`.

    Autograd's own backward of a row select is an `index_add_` of millions
    of rows into a few (a material table has 4-7): on CUDA, atomics on a
    few addresses, summed in no fixed order. For T <= 128 rows the table
    cotangent is T masked row sums instead, deterministic on every device;
    larger tables take `index_add_`."""

    @staticmethod
    def forward(ctx, table, idx):
        flat = idx.reshape(-1)
        ctx.save_for_backward(flat)
        ctx.rows = table.shape[0]
        return table.index_select(0, flat).reshape(
            idx.shape + table.shape[-1:])

    @staticmethod
    def backward(ctx, g):
        (ix,) = ctx.saved_tensors
        gf = g.reshape(ix.shape[0], -1)
        if ctx.rows <= _MASKSUM_MAX_ROWS:
            gt = torch.stack([torch.where((ix == r)[:, None], gf, 0.0).sum(0)
                              for r in range(ctx.rows)])
        else:
            gt = gf.new_zeros((ctx.rows, gf.shape[1])).index_add_(0, ix, gf)
        return gt, None


def take_rows(table, idx):
    """Row select `table[idx]` -> idx.shape + (C,), exact (a gather);
    differentiable in `table` (see `_TakeRows`)."""
    return _TakeRows.apply(table, idx)


@functools.lru_cache(maxsize=None)
def _bound(c: float, dtype):
    # a 0-dim CPU tensor: binary ops take it as a scalar on any device
    return torch.tensor(c, dtype=dtype)


def maximum(x, c: float):
    """max(x, c) for a constant c with jnp.maximum's gradient: at a tie
    x == c the cotangent splits 0.5/0.5 (torch.clamp passes all of it)."""
    return torch.maximum(x, _bound(float(c), x.dtype))


def minimum(x, c: float):
    """min(x, c), splitting the cotangent at a tie as jnp.minimum does."""
    return torch.minimum(x, _bound(float(c), x.dtype))


def clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi) with its tie gradients (0.5 at either bound)."""
    return minimum(maximum(x, lo), hi)


class _Recip(torch.autograd.Function):
    """1/x whose backward is -(g r) r with r = 1/x: the forward of 1/x, and
    a zero cotangent stays zero where r * r overflows float32 (autograd's
    own -g r^2 is 0 * inf = NaN there, e.g. on the branch a where drops)."""

    @staticmethod
    def forward(ctx, x):
        r = torch.reciprocal(x)
        ctx.save_for_backward(r)
        return r

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        return -(g * r) * r


def recip(x):
    """1/x, with a backward that keeps a zero cotangent zero (`_Recip`)."""
    return _Recip.apply(x)


def bary_interp(rows, w):
    """Barycentric blend of three per-vertex k-vectors packed as (..., 3k)
    rows with weights w (..., 3), the vertex sum taken in order."""
    k = rows.shape[-1] // 3
    return (rows[..., 0:k] * w[..., 0:1] + rows[..., k:2 * k] * w[..., 1:2]
            + rows[..., 2 * k:3 * k] * w[..., 2:3])


def dot(a, b):
    """Batched 3-vector dot product -> (...,)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def dot1(a, b):
    """Batched dot product keeping the last axis -> (..., 1)."""
    return dot(a, b)[..., None]


def length(v):
    """|v|, 0 for the zero vector (the AD-safe form of the reference)."""
    s = maximum(dot(v, v), 0.0)
    pos = s > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, 1.0)), 0.0)


def safe_sqrt(x):
    """sqrt(max(x, 0))."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_pow(base, exp):
    """base**exp for base >= 0, with pow(0, 0) = 1 as std::pow."""
    pos = base > 0.0
    p = torch.pow(torch.where(pos, base, 1.0), exp)
    return torch.where(pos, p, torch.as_tensor(exp == 0.0, dtype=p.dtype,
                                               device=p.device))


def normalize(v):
    """Safe normalize: zero vectors map to zero (not NaN)."""
    return v * torch.rsqrt(maximum(dot1(v, v), _EPS))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def reflect(i, n):
    """glm::reflect: i points toward the surface."""
    return i - 2.0 * dot1(n, i) * n


def refract(i, n, eta):
    """glm::refract; 0 on total internal reflection. eta: (...,) or a
    scalar."""
    eta = torch.as_tensor(eta, dtype=i.dtype, device=i.device)[..., None]
    ndi = dot1(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    refr = eta * i - (eta * ndi + torch.sqrt(maximum(k, 0.0))) * n
    return torch.where(k < 0.0, 0.0, refr)


def orthogonal(v):
    """A vector orthogonal to v (reference Utils::orthogonal)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    use_x = torch.abs(x) > torch.abs(z)
    zero = torch.zeros_like(x)
    return torch.stack([torch.where(use_x, y, zero),
                        torch.where(use_x, -x, z),
                        torch.where(use_x, zero, -y)], dim=-1)


def onb(n):
    """Orthonormal basis (o1, o2) around unit n (Gram-Schmidt frame of
    the reference's distributions)."""
    o2 = normalize(orthogonal(n))
    o1 = normalize(cross(n, o2))
    o2 = normalize(cross(o1, n))
    return o1, o2


def to_world(o1, o2, n, local):
    """Transform local (x, y, z) [z along n] into world space."""
    return local[..., 0:1] * o1 + local[..., 1:2] * o2 + local[..., 2:3] * n


def max_component(v):
    return torch.amax(v, dim=-1)


def power_heuristic(pdf, pdf_other):
    """Power heuristic, beta = 2 (reference
    pg/DirectMISIntegrator.cpp:10-15)."""
    p2 = pdf * pdf
    q2 = pdf_other * pdf_other
    return torch.where(p2 + q2 > 0.0, p2 / (p2 + q2), 0.0)


def schlick(incident, normal, ior1, ior2):
    """Scalar Schlick approximation (reference Utils::schlickApprox)."""
    f0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
    cos_t = maximum(dot(-incident, normal), 0.0)
    return f0 + (1.0 - f0) * (1.0 - cos_t) ** 5


def schlick_f0(incident, normal, f0):
    """Vector Schlick with an explicit F0 (reference
    Utils::schlickApprox3)."""
    cos_t = maximum(dot1(-incident, normal), 0.0)
    return f0 + (1.0 - f0) * (1.0 - cos_t) ** 5


def sanitize(radiance):
    """Zero NaN and negative radiance (reference pg/Integrator.cpp:6-23)."""
    bad = torch.isnan(radiance) | (radiance < 0.0)
    return torch.where(bad, 0.0, radiance)


def luminance(c):
    """Rec.709 luminance of an (..., 3) color."""
    return (0.2126 * c[..., 0] + 0.7152 * c[..., 1]
            + 0.0722 * c[..., 2])
