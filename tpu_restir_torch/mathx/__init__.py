"""Vector math on tensors whose last axis is the 3-vector axis.

The counterpart of `tpu_restir.mathx`, cut to what the ReSTIR frame
calls. Three-term sums are written out left to right, the order in which
XLA reduces a length-3 axis, so that the two packages round alike.
"""

from __future__ import annotations

import torch

from tpu_restir_torch.mathx.color import aces, srgb_compress  # noqa: F401
from tpu_restir_torch.mathx.special import calc_i_m  # noqa: F401

_EPS = 1e-30


def take_rows(table, idx):
    """Row select `table[idx]` -> idx.shape + (C,), exact (a gather)."""
    return table.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[-1:])


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
    s = torch.clamp(dot(v, v), min=0.0)
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
    return v * torch.rsqrt(torch.clamp(dot1(v, v), min=_EPS))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def reflect(i, n):
    """glm::reflect: i points toward the surface."""
    return i - 2.0 * dot1(n, i) * n


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


def sanitize(radiance):
    """Zero NaN and negative radiance (reference pg/Integrator.cpp:6-23)."""
    bad = torch.isnan(radiance) | (radiance < 0.0)
    return torch.where(bad, 0.0, radiance)
