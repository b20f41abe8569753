"""Counter-based RNG, bit for bit as `tpu_restir.rng` and `jax.random`.

Two generators, as in the JAX package:

* PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT
  2020): every random number of the ReSTIR path is a pure function of
  (frame seed, stream id, global pixel coords).
* threefry2x32 keys (Salmon et al., "Parallel random numbers: as easy as
  1, 2, 3", SC 2011): the naive and NEE path tracers draw from keys
  derived per (seed, frame, pass, draw), with the draws of one call
  indexed by the C-order flat index of their shape. `key`, `fold_in`,
  `split`, `uniform` and `randint_scalar` give what `jax.random` gives
  under `jax_threefry_partitionable` (the default): a key is the pair of
  uint32 words (k0, k1), held as Python ints; keys are scalars and are
  derived on the host, and only `uniform` runs on a device.

PyTorch lacks `+` and `>>` on uint32 tensors, so both hashes run on int64
tensors holding uint32 values, masked back to 32 bits after every step;
the same code runs on the CPU and on CUDA.
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
PASS_NAIVE = 7
PASS_NEE_DIRECT = 8
PASS_NEE_GI = 9

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# threefry2x32 keys (jax.random)
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _threefry2x32(k0: int, k1: int, x0, x1):
    """threefry2x32 of the counter pair (x0, x1) under the key (k0, k1):
    5 groups of 4 rounds with a key injection after each. x0, x1 are
    Python ints or int64 tensors holding uint32 values (either may be an
    int while the other is a tensor); the result has their type."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def key(seed: int):
    """jax.random.key(seed) for a seed in the int32 range: (0, seed mod
    2^32)."""
    return (0, int(seed) & _M32)


def fold_in(k, data: int):
    """jax.random.fold_in: the key hashed with the counter (0, data)."""
    return _threefry2x32(k[0], k[1], 0, int(data) & _M32)


def split(k, n: int = 2):
    """jax.random.split(k, n) as a list of n keys: key i is the hash of
    the counter (i >> 32, i mod 2^32)."""
    return [_threefry2x32(k[0], k[1], i >> 32, i & _M32) for i in range(n)]


def _random_bits(k, n: int, device):
    """The 32-bit draws 0..n-1 of key k (x0 ^ x1 of the hash of the flat
    index) as an int64 tensor on device."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    hi = 0
    if n > 1 << 32:
        hi, lo = lo >> 32, lo & _M32
    x0, x1 = _threefry2x32(k[0], k[1], hi, lo)
    return x0 ^ x1


def uniform(k, shape, device):
    """jax.random.uniform(k, shape): float32 U[0, 1) on device, from the
    top 23 bits of each draw as the mantissa of a float in [1, 2)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= int(s)
    bits = _random_bits(k, n, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).reshape(shape)


def randint_scalar(k, lo: int, hi: int) -> int:
    """jax.random.randint(k, (), lo, hi) for int32 bounds lo < hi, on the
    host: two 32-bit draws of split(k) folded into the span, in uint32
    arithmetic (jax/_src/random.py, _randint)."""
    k1, k2 = split(k)
    higher = _threefry2x32(k1[0], k1[1], 0, 0)
    lower = _threefry2x32(k2[0], k2[1], 0, 0)
    higher, lower = higher[0] ^ higher[1], lower[0] ^ lower[1]
    span = (hi - lo) & _M32
    # uint32 arithmetic: the square wraps before the remainder
    mult = ((((1 << 16) % span) ** 2) & _M32) % span
    offset = (((higher % span) * mult & _M32) + lower % span) & _M32
    return lo + offset % span


def base_key(seed: int):
    return key(seed)


def frame_key(seed: int, frame: int):
    """Key of one rendered frame: the frame counter folded into the seed
    key."""
    return fold_in(base_key(seed), frame)


def pass_key(fkey, pass_id: int):
    return fold_in(fkey, pass_id)


def draw_key(pkey, draw: int):
    """Key of the i-th candidate or draw inside a pass."""
    return fold_in(pkey, draw)


# ---------------------------------------------------------------------------
# PCG4D per-pixel hash
# ---------------------------------------------------------------------------

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
