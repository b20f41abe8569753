"""Tonemapping and transfer functions (reference pg/utils.cpp:178-230)."""

from __future__ import annotations

import torch


def aces(x):
    """ACES filmic tonemap, clamped to [0,1] (reference Utils::aces)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def srgb_compress(u):
    """Linear -> sRGB (reference Utils::compress, pg/utils.cpp:220-230)."""
    u = torch.clamp(u, 0.0, 1.0)
    return torch.where(u <= 0.0031308, u * 12.92,
                       1.055 * torch.pow(torch.clamp(u, min=1e-12), 1.0 / 2.4)
                       - 0.055)

