"""Denoiser: edge-preserving filters guided by the ReSTIR G-buffer
(counterpart of `tpu_restir.denoise`; plain PyTorch, the JAX package has
no kernel here).

The reference feeds color, albedo and normal into OIDN
(pg/simpleguidx11.cpp:52-75, 255-260); here the same feature buffers (the
G-buffer's diffuse and normal, plus depth) guide a joint-bilateral filter
or the variance-guided SVGF a-trous filter with its temporal history,
applied to the HDR accumulator before tonemapping. Neighbour taps are
`torch.roll`, wrap-around included, as `jnp.roll` in the JAX package; the
SVGF stencil zeroes the weight of wrapped taps.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu_restir_torch.mathx import luminance as _luminance
from tpu_restir_torch.render import camera as cam_mod


def _shifted(x, dy: int, dx: int):
    return torch.roll(x, shifts=(-dy, -dx), dims=(0, 1))


def joint_bilateral(color, albedo, normal, depth, *, radius: int = 3,
                    sigma_space: float = 2.0, sigma_albedo: float = 0.15,
                    sigma_normal: float = 0.25, sigma_depth: float = 0.5):
    """color (H,W,3) guided by albedo (H,W,3), normal (H,W,3), depth (H,W)."""
    acc = torch.zeros_like(color)
    wacc = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            w_s = math.exp(-(dy * dy + dx * dx) / (2 * sigma_space ** 2))
            a = _shifted(albedo, dy, dx)
            n = _shifted(normal, dy, dx)
            z = _shifted(depth, dy, dx)
            c = _shifted(color, dy, dx)
            w_a = torch.exp(-torch.sum((a - albedo) ** 2, -1)
                            / (2 * sigma_albedo ** 2))
            w_n = torch.exp(-torch.sum((n - normal) ** 2, -1)
                            / (2 * sigma_normal ** 2))
            w_z = torch.exp(-(z - depth) ** 2 / (2 * sigma_depth ** 2))
            wgt = w_s * w_a * w_n * w_z
            acc = acc + c * wgt[..., None]
            wacc = wacc + wgt
    return acc / torch.clamp(wacc, min=1e-8)[..., None]


_B3 = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)   # B3-spline taps


def svgf_denoise(color, albedo, normal, depth, variance, exclude=None, *,
                 iterations: int = 5, sigma_l: float = 4.0,
                 sigma_z: float = 1.0, sigma_n: float = 128.0,
                 sigma_a: float = 0.2):
    """SVGF-style edge-avoiding a-trous wavelet filter with variance
    guidance (Schied et al. 2017), as `tpu_restir.denoise.svgf_denoise`:
    `iterations` passes of a 5x5 B3-spline stencil at dilation 2^i, with
    per-tap weights from depth, normal, albedo, and a luminance weight
    scaled by the per-pixel noise standard deviation. The variance image is
    filtered alongside the color with squared weights. Filtering runs in a
    Reinhard-compressed domain (y = c/(1+L), s = 1/(1+L), output
    Sum(w y)/Sum(w s)); excluded pixels pass through.

    color (H,W,3) HDR; albedo/normal (H,W,3); depth (H,W); variance (H,W),
    the luminance variance of the color estimate; exclude (H,W) bool."""
    h, w = depth.shape
    dev = depth.device
    yi = torch.arange(h, device=dev)[:, None]
    xi = torch.arange(w, device=dev)[None, :]

    def inside(dy, dx):
        # roll wraps; off-image taps must get zero weight
        return ((yi + dy >= 0) & (yi + dy < h)
                & (xi + dx >= 0) & (xi + dx < w)).to(torch.float32)

    keepf = (torch.zeros((h, w), device=dev) if exclude is None
             else exclude.to(torch.float32))

    lum0 = _luminance(color)
    sc = 1.0 / (1.0 + lum0)

    # cap the dilation so the widest stencil still fits the image
    # (5 levels is the 1080p setting; tiny images use fewer)
    iters = min(iterations,
                max(1, int(np.log2(max(min(h, w) // 10, 2))) + 1))

    c = color * sc[..., None]
    sw = sc
    # Var(sc * L) = sc^2 Var(L)
    var = torch.clamp(variance, min=0.0) * sc ** 2
    for it in range(iters):
        s = 1 << it
        # 3x3 prefilter of the variance -> stable sigma for w_l
        vg = torch.zeros_like(var)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                vg = vg + _shifted(var, dy, dx)
        sig_l = sigma_l * torch.sqrt(vg / 9.0) + 1e-6
        lum = _luminance(c)
        acc = torch.zeros_like(c)
        sacc = torch.zeros_like(sw)
        vacc = torch.zeros_like(var)
        wacc = torch.zeros_like(var)
        for ty in range(-2, 3):
            for tx in range(-2, 3):
                dy, dx = ty * s, tx * s
                hk = float(np.float32(_B3[ty + 2]) * np.float32(_B3[tx + 2]))
                cq = _shifted(c, dy, dx)
                vq = _shifted(var, dy, dx)
                w_z = torch.exp(-torch.abs(_shifted(depth, dy, dx) - depth)
                                / (sigma_z * s + 1e-6))
                w_n = torch.clamp(
                    torch.sum(_shifted(normal, dy, dx) * normal, -1),
                    min=0.0) ** sigma_n
                w_a = torch.exp(-torch.sum(
                    (_shifted(albedo, dy, dx) - albedo) ** 2, -1)
                    / (2 * sigma_a ** 2))
                w_l = torch.exp(-torch.abs(_luminance(cq) - lum) / sig_l)
                wt = hk * w_z * w_n * w_a * w_l * inside(dy, dx) \
                    * (1.0 - _shifted(keepf, dy, dx))
                acc = acc + cq * wt[..., None]
                sacc = sacc + _shifted(sw, dy, dx) * wt
                vacc = vacc + vq * wt * wt
                wacc = wacc + wt
        cf = acc / torch.clamp(wacc, min=1e-8)[..., None]
        sf = sacc / torch.clamp(wacc, min=1e-8)
        # excluded pixels (and pixels whose whole stencil is excluded)
        # pass through untouched
        keep = (keepf > 0.5) | (wacc <= 1e-8)
        c = torch.where(keep[..., None], c, cf)
        sw = torch.where(keep, sw, sf)
        var = torch.where(keep, var, vacc / torch.clamp(wacc, min=1e-8) ** 2)
    return c / torch.clamp(sw, min=1e-6)[..., None]


@dataclasses.dataclass
class SvgfHistory:
    """Per-pixel temporal history for SVGF (Schied et al. 2017 §4.1):
    exponentially integrated color and luminance moments, plus the
    geometry and camera snapshot needed to reproject and validate them
    next frame. It survives camera motion (where the accumulator resets)
    by reprojection."""

    color: torch.Tensor     # (H, W, 3) integrated radiance
    m1: torch.Tensor        # (H, W) integrated luminance
    m2: torch.Tensor        # (H, W) integrated luminance^2
    length: torch.Tensor    # (H, W) history length (frames, clamped)
    depth: torch.Tensor     # (H, W) depth at integration time
    normal: torch.Tensor    # (H, W, 3)
    view_mat: torch.Tensor  # (4, 4) camera snapshot
    focal: torch.Tensor     # ()


def empty_svgf_history(h: int, w: int, device) -> SvgfHistory:
    def z(*shape):
        return torch.zeros(shape, device=device)

    return SvgfHistory(color=z(h, w, 3), m1=z(h, w), m2=z(h, w),
                       length=z(h, w), depth=z(h, w), normal=z(h, w, 3),
                       view_mat=torch.eye(4, device=device), focal=z())


def svgf_temporal_update(hist: SvgfHistory, frame, gb, alpha: float = 0.2,
                         max_len: float = 32.0):
    """One frame of SVGF temporal accumulation, as
    `tpu_restir.denoise.svgf_temporal_update`: reproject the history into
    the current camera (the current surface position through the previous
    view matrix), accept taps by depth ratio and normal similarity, clamp
    the reprojected color to the current frame's 3x3 range, then blend
    with alpha = max(1/(len+1), alpha). -> (new_hist, integrated color,
    variance): the moment variance from 4 frames of history on, the 3x3
    spatial estimate before."""
    h, w = frame.shape[:2]
    lum = _luminance(frame)

    sx, sy, valid = cam_mod.project_to_screen(hist.view_mat, hist.focal, w,
                                              h, gb.pos)
    sx = torch.clamp(sx, 0, w - 1).long()
    sy = torch.clamp(sy, 0, h - 1).long()
    tap_color = hist.color[sy, sx]
    tap_m1 = hist.m1[sy, sx]
    tap_m2 = hist.m2[sy, sx]
    tap_len = hist.length[sy, sx]
    tap_depth = hist.depth[sy, sx]
    tap_normal = hist.normal[sy, sx]

    depth = gb.depth
    ratio = torch.minimum(depth, tap_depth) / torch.clamp(
        torch.maximum(depth, tap_depth), min=1e-20)
    n_sim = torch.sum(gb.normal * tap_normal, dim=-1)
    accept = (valid & (tap_len > 0.0) & (depth > 0.0)
              & (ratio >= 0.9) & (n_sim >= 0.9))

    # neighbourhood clamp: the reprojected color may not leave the current
    # frame's local 3x3 range (ghosting, stale fireflies)
    cmin = frame
    cmax = frame
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            q = _shifted(frame, dy, dx)
            cmin = torch.minimum(cmin, q)
            cmax = torch.maximum(cmax, q)
    tap_color = torch.minimum(torch.maximum(tap_color, cmin), cmax)
    # clamp the moments consistently with the clamped mean
    tap_m1 = torch.minimum(torch.maximum(tap_m1, _luminance(cmin)),
                           _luminance(cmax))
    tap_m2 = torch.maximum(tap_m2, tap_m1 * tap_m1)

    new_len = torch.where(accept, torch.clamp(tap_len + 1.0, max=max_len),
                          1.0)
    a = torch.clamp(1.0 / new_len, min=alpha)
    a = torch.where(accept, a, 1.0)
    color = tap_color + (frame - tap_color) * a[..., None]
    m1 = tap_m1 + (lum - tap_m1) * a
    m2 = tap_m2 + (lum * lum - tap_m2) * a

    var_t = torch.clamp(m2 - m1 * m1, min=0.0)
    var = torch.where(new_len >= 4.0, var_t, spatial_variance(color))

    new_hist = SvgfHistory(color=color, m1=m1, m2=m2, length=new_len,
                           depth=depth, normal=gb.normal,
                           view_mat=gb.view_mat, focal=gb.focal)
    return new_hist, color, var


def spatial_variance(color):
    """3x3 local luminance variance: the SVGF first-frames estimate when
    too few samples exist for a temporal moment estimate."""
    lum = _luminance(color)

    def blur(x):
        acc = torch.zeros_like(x)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = acc + _shifted(x, dy, dx)
        return acc / 9.0

    return torch.clamp(blur(lum * lum) - blur(lum) ** 2, min=0.0)


def denoise_accumulator(accumulator, gbuffer, radius: int = 3,
                        variance=None, method: str = "svgf"):
    """OIDN-style call: color = accumulator, albedo = gBuffer.diffuse,
    normal = gBuffer.worldNormal (pg/simpleguidx11.cpp:55-66).
    method 'svgf' (default) runs the variance-guided a-trous filter,
    'bilateral' the joint bilateral. Without a variance image, svgf takes
    the 3x3 spatial estimate."""
    if method == "bilateral":
        return joint_bilateral(accumulator, gbuffer.diffuse, gbuffer.normal,
                               gbuffer.depth, radius=radius)
    if variance is None:
        variance = spatial_variance(accumulator)
    return svgf_denoise(accumulator, gbuffer.diffuse, gbuffer.normal,
                        gbuffer.depth, variance,
                        exclude=gbuffer.is_emissive())
