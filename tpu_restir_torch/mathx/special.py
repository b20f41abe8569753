"""Special functions for the Phong energy normalization.

The reference normalizes its cosine-lobe specular term with Mallett &
Yuksel's I_M integral, built on the non-normalized incomplete beta
B_x(a, b) (reference pg/MaterialPhong.cpp:224-248). PyTorch has no
incomplete beta, so B_x(a, 1/2) is evaluated here as its continued
fraction (modified Lentz, a fixed number of steps so that it runs as
plain tensor ops) in float64, and cast to float32. On CUDA tensors that
value is one launch of K10 (`kernels/ibeta.py`), the same arithmetic in
the same order; CPU tensors take the plain ops below.
"""

from __future__ import annotations

import math

import torch

from tpu_restir_torch.kernels import ibeta as _k10

_TWO_PI = 2.0 * math.pi
_ROOT_PI = math.sqrt(math.pi)
_TINY = 1e-300
# Lentz steps: float64 convergence for a <= 64, b = 1/2 (shininess up
# to 128) measured below 1e-12 relative after 32 steps; 64 leave margin.
_CF_STEPS = 64


def _nonzero(x):
    return torch.where(torch.abs(x) < _TINY, _TINY, x)


def _beta_cf(a, b, x):
    """Continued fraction of I_x(a, b) (Numerical Recipes' betacf)."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / _nonzero(1.0 - qab * x / qap)
    h = d
    for m in range(1, _CF_STEPS + 1):
        m2 = 2.0 * m
        for aa in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                   -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1.0 / _nonzero(1.0 + aa * d)
            c = _nonzero(1.0 + aa / c)
            h = h * d * c
    return h


def _ibeta_value(x, a, b):
    """B_x(a, b) in float64 for broadcast float64 tensors."""
    # symmetry swap I_x(a, b) = 1 - I_{1-x}(b, a) where the fraction
    # converges slowly
    swap = x > (a + 1.0) / (a + b + 2.0)
    xs = torch.where(swap, 1.0 - x, x)
    as_ = torch.where(swap, b, a)
    bs = torch.where(swap, a, b)
    front = torch.exp(as_ * torch.log(xs) + bs * torch.log1p(-xs)) / as_
    part = front * _beta_cf(as_, bs, xs)
    full = torch.exp(torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b))
    return torch.where(swap, full - part, part)


class _IBetaX(torch.autograd.Function):
    """B_x(a, b) with the analytic x-derivative x^(a-1) (1-x)^(b-1) (the
    integrand; jax.scipy's betainc x-derivative times B(a, b)), so the 64
    Lentz steps record no graph. a and b come detached. The value is K10's
    on CUDA tensors, `_ibeta_value`'s on CPU tensors."""

    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(x, a, b)
        if x.device.type == "cuda":
            return _k10.ibeta(x, a, b)
        return _ibeta_value(x, a, b)

    @staticmethod
    def backward(ctx, g):
        x, a, b = ctx.saved_tensors
        dx = torch.exp((b - 1.0) * torch.log1p(-x) + (a - 1.0) * torch.log(x))
        # dx is infinite at x = 1 (b = 1/2) and NaN at x = 0 for a = 1; a
        # zero cotangent (a lane that a where or a clip drops) stays zero
        return torch.where(g == 0.0, 0.0, g * dx), None, None


def ibeta_operands(x, a, b):
    """The float64 operands (x, a, b) of `ibeta_nonnorm`'s B_x(a, b): x
    clipped to [0, 1], a at least 1e-12, a and b detached, all three
    broadcast to one shape (b = 1/2 as one value of stride 0)."""
    from tpu_restir_torch import mathx

    x = mathx.clip(torch.as_tensor(x).to(torch.float64), 0.0, 1.0)
    a = mathx.maximum(torch.as_tensor(a, device=x.device).detach()
                      .to(torch.float64), 1e-12)
    b = torch.as_tensor(b, device=x.device).detach().to(torch.float64)
    a, b, x = torch.broadcast_tensors(a, b, x)
    return x, a, b


def ibeta_nonnorm(x, a, b):
    """Non-normalized incomplete beta B_x(a, b) = I_x(a, b) * B(a, b), the
    boost::math::beta(a, b, x) of pg/MaterialPhong.cpp:246-248.
    a, b > 0; x in [0, 1]. Evaluated in float64, returned as float32.

    Differentiable in x only: the shape parameters are detached, as the
    JAX function detaches them (its betainc has no a/b gradient), so the
    normalization's derivative through B_x's shape is dropped by design."""
    return _IBetaX.apply(*ibeta_operands(x, a, b)).to(torch.float32)


def calc_i_m(n_dot_v, n):
    """Mallett-Yuksel I_M normalization integral for a cosine lobe of
    exponent n viewed at cos(theta) = n_dot_v (pg/MaterialPhong.cpp:228-244):
      I_M = (2 pi c + sqrt(pi) G(n/2+1/2)/G(n/2+1) (s^(n/2) - negterm))
            / (n + 2)
    with s = clamp(1 - c^2, 0, 1) and negterm = c (n/2) B_s(n/2, 1/2) when
    n >= 1e-18, else c."""
    from tpu_restir_torch import mathx

    cost = n_dot_v.to(torch.float32)
    n = torch.as_tensor(n, dtype=torch.float32, device=cost.device)
    sin2 = mathx.clip(1.0 - cost * cost, 0.0, 1.0)
    halfn = 0.5 * n
    negterm = torch.where(n >= 1e-18,
                          cost * halfn * ibeta_nonnorm(sin2, halfn, 0.5), cost)
    gq = torch.exp(torch.lgamma(halfn + 0.5) - torch.lgamma(halfn + 1.0))
    pow_term = mathx.safe_pow(mathx.maximum(sin2, 0.0), halfn)
    return (_TWO_PI * cost + _ROOT_PI * gq * (pow_term - negterm)) / (n + 2.0)
