"""Per-pixel counter-based RNG (PCG4D), bit for bit as `tpu_restir.rng`.

Every random number of the ReSTIR path is a pure function of (frame seed,
stream id, global pixel coords) through the PCG4D hash (Jarzynski & Olano,
"Hash Functions for GPU Rendering", JCGT 2020). PyTorch lacks `+` and `>>`
on uint32 tensors, so the hash runs on int64 tensors holding uint32
values, masked back to 32 bits after every step; the same code runs on
the CPU and on CUDA.
"""

from __future__ import annotations

import torch

# Pass ids (the same constants as tpu_restir.rng).
PASS_PIXEL_JITTER = 0
PASS_INITIAL_AREA = 2
PASS_INITIAL_BRDF = 3
PASS_INITIAL_WRS = 4
PASS_TEMPORAL = 5
PASS_SPATIAL = 6       # + pass index is folded in separately

_M32 = 0xFFFFFFFF


def make_frame_seed(seed: int, frame: int) -> int:
    """Mix the config seed and frame counter into one uint32 (a Python int)."""
    return (int(seed) * 0x9E3779B9 + int(frame) * 0x85EBCA6B + 1) & _M32


def stream_id(pass_id: int, draw: int = 0, slot: int = 0) -> int:
    """Stable stream encoding: one stream per (pass, draw, slot)."""
    return (pass_id << 16) | (draw << 4) | slot


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors holding uint32 values, split in
    16-bit halves so that no product leaves the int64 range."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix(x, y, z, w):
    x = (x + _mul32(y, w)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    w = (w + _mul32(y, z)) & _M32
    return x, y, z, w


def pcg4d(a, b, c, d):
    """PCG4D hash: four uint32-valued int64 tensors in, four out."""
    x, y, z, w = ((_mul32(v & _M32, 1664525) + 1013904223) & _M32
                  for v in (a, b, c, d))
    x, y, z, w = _mix(x, y, z, w)
    x, y, z, w = (v ^ (v >> 16) for v in (x, y, z, w))
    return _mix(x, y, z, w)


def _to_unit(u):
    """uint32 -> float32 in [0, 1) using the top 24 bits (exact)."""
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


def pixel_uniforms(frame_seed, stream: int, ys, xs, n: int = 1):
    """n <= 4 independent U[0,1) draws per pixel, shaped like ys/xs + (n,).

    ys/xs are GLOBAL integer pixel coordinates (tensors of one shape);
    frame_seed is a uint32 value (Python int or 0-d tensor)."""
    if not 1 <= n <= 4:
        raise ValueError(f"pixel_uniforms draws 1..4 values, got {n}")
    ys = ys.to(torch.int64)
    xs = xs.to(torch.int64)
    fs = torch.as_tensor(frame_seed, dtype=torch.int64,
                         device=ys.device).expand(ys.shape)
    st = torch.full(ys.shape, stream & _M32, dtype=torch.int64,
                    device=ys.device)
    outs = pcg4d(xs, ys, fs, st)
    return torch.stack([_to_unit(outs[i]) for i in range(n)], dim=-1)


def pixel_uniform(frame_seed, stream: int, ys, xs):
    """Single U[0,1) draw per pixel, shaped like ys/xs."""
    return pixel_uniforms(frame_seed, stream, ys, xs, 1)[..., 0]
