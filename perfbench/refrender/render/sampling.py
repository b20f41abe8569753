"""Shaped Monte-Carlo samplers (counterpart of `tpu_restir.render.sampling`,
cut to what the ReSTIR frame and the path tracers call). Every draw is a
function of given uniforms; the key-based wrappers of the path tracers
draw them from `rng.uniform`, the same numbers as `jax.random.uniform`."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from perfbench.refrender.config import PixelSamplerKind
from perfbench.refrender import mathx, rng

_TWO_PI = 2.0 * math.pi


def pixel_offsets_u(u4, kind: str, grid=(5, 5)):
    """Sub-pixel offsets in [0,1)^2 from (..., 4) uniforms
    (reference pg/PixelSampler.h:6-67)."""
    if kind == PixelSamplerKind.CENTER:
        return torch.zeros(u4.shape[:-1] + (2,), dtype=torch.float32,
                           device=u4.device)
    if kind == PixelSamplerKind.RANDOM:
        return u4[..., :2]
    if kind == PixelSamplerKind.STRATIFIED:
        gx, gy = grid
        block = torch.tensor([1.0 / gx, 1.0 / gy], dtype=torch.float32,
                             device=u4.device)
        cells = torch.tensor([gx, gy], dtype=torch.float32, device=u4.device)
        return torch.floor(u4[..., 2:4] * cells) * block + u4[..., :2] * block
    raise ValueError(f"unknown pixel sampler {kind!r}")


@functools.lru_cache(maxsize=None)
def disk_int_offset_table(radius: float, n: int = 4096):
    """Static table of the integer spatial-neighbour offsets, distributed
    as trunc(disk sample) with the reference's r = sqrt(U(0, R)) quirk
    (pg/ReSTIRIntegrator.cpp:334-341). The same numpy construction as
    tpu_restir.render.sampling.disk_int_offset_table: each integer cell's
    probability is its area overlap with the disk of radius sqrt(R),
    quantized to n slots by largest remainder. Returns (starts, deltas, n):
    slot s maps to cell sum_j [s >= starts_j] * deltas_j."""
    rad = float(np.sqrt(max(radius, 0.0)))
    m = 2048
    xs = (np.arange(m, dtype=np.float64) + 0.5) / m * 2 * rad - rad
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    inside = gx * gx + gy * gy <= rad * rad
    ix = np.trunc(gx[inside]).astype(np.int64)
    iy = np.trunc(gy[inside]).astype(np.int64)
    k = int(np.ceil(rad)) + 1
    w = 2 * k + 1
    hist = np.bincount((ix + k) * w + (iy + k), minlength=w * w)
    probs = hist / hist.sum()
    counts = np.floor(probs * n).astype(np.int64)
    rem = probs * n - counts
    short = n - counts.sum()
    counts[np.argsort(-rem)[:short]] += 1
    occ = np.nonzero(counts)[0]
    starts = np.concatenate([[0], np.cumsum(counts[occ])[:-1]])
    cells = np.stack([occ // w - k, occ % w - k], axis=1)
    deltas = np.diff(cells, axis=0, prepend=np.zeros((1, 2), np.int64))
    return (starts.astype(np.float32), deltas.astype(np.float32), int(n))


def disk_int_from_uniform(u, radius: float):
    """Integer disk offsets (dx, dy) int32 from ONE uniform draw, exactly
    as the reference's compare-sum: the slot is floor(u * n) (exact), and
    the count of slot starts at or below it picks the cell, whose offset
    is the running sum of the small-integer deltas (exact in float32)."""
    starts, deltas, n = disk_int_offset_table(float(radius))
    starts_t = torch.from_numpy(starts).to(u.device)
    cells = torch.from_numpy(np.cumsum(deltas, axis=0)).to(u.device)
    idx = torch.clamp(torch.floor(u * n), 0, n - 1)
    count = torch.searchsorted(starts_t, idx.contiguous(), right=True)
    return cells[count - 1].to(torch.int32)


def triangle_barycentrics_from_uniforms(u):
    """Uniform barycentric weights per pg/Sampling.cpp:63-76."""
    r1, r2 = u[..., 0], u[..., 1]
    s = torch.sqrt(r1)
    return torch.stack([1.0 - s, s * (1.0 - r2), s * r2], dim=-1)


def cosine_hemisphere_from_uniforms(u, normal):
    """Cosine-weighted hemisphere direction around `normal`
    (CosineWeightedDistribution::sample, pg/Distribution.h:9-31)."""
    r1, r2 = u[..., 0], u[..., 1]
    sq = mathx.safe_sqrt(1.0 - r2)
    local = torch.stack([torch.cos(_TWO_PI * r1) * sq,
                         torch.sin(_TWO_PI * r1) * sq,
                         mathx.safe_sqrt(r2)], dim=-1)
    local = mathx.normalize(local)
    o1, o2 = mathx.onb(normal)
    return mathx.to_world(o1, o2, normal, local)


def sample_cosine_hemisphere(key, normal):
    return cosine_hemisphere_from_uniforms(
        rng.uniform(key, normal.shape[:-1] + (2,), normal.device), normal)


def pdf_cosine_hemisphere(normal, omega_i):
    """max(n.wi, 0)/pi (CosineWeightedDistribution::getPdf)."""
    return mathx.maximum(mathx.dot(normal, omega_i), 0.0) / math.pi


def cosine_lobe_from_uniforms(u, omega_r, gamma):
    """Cosine-lobe (Phong exponent gamma) direction around omega_r
    (CosineLobeDistribution::sample, pg/Distribution.h:41-63)."""
    r1, r2 = u[..., 0], u[..., 1]
    gamma = torch.as_tensor(gamma, dtype=torch.float32,
                            device=omega_r.device).expand(omega_r.shape[:-1])
    z = torch.pow(mathx.maximum(r2, 1e-30), 1.0 / (gamma + 1.0))
    sq = mathx.safe_sqrt(1.0 - z * z)
    local = torch.stack([torch.cos(_TWO_PI * r1) * sq,
                         torch.sin(_TWO_PI * r1) * sq, z], dim=-1)
    local = mathx.normalize(local)
    o1, o2 = mathx.onb(omega_r)
    return mathx.to_world(o1, o2, omega_r, local)


def sample_cosine_lobe(key, omega_r, gamma):
    return cosine_lobe_from_uniforms(
        rng.uniform(key, omega_r.shape[:-1] + (2,), omega_r.device),
        omega_r, gamma)


def pdf_cosine_lobe(omega_i, omega_r, gamma):
    """(gamma+1)/(2 pi) * max(0, wi.wr)^gamma (CosineLobeDistribution::getPdf)."""
    c = mathx.maximum(mathx.dot(omega_i, omega_r), 0.0)
    return (gamma + 1.0) / _TWO_PI * mathx.safe_pow(c, gamma)
