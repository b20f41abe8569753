"""Per-triangle affine (Woop) transforms: the numpy builder of
`tpu_restir.kernels.woop.build_woop_matrices` (whose module imports JAX)
and the block test of the 'woop_mxu' and 'cluster' backends. Each
triangle gets the affine map W that sends it to the unit triangle
{(0,0,0), (1,0,0), (0,1,0)} with the third coordinate along the
(unscaled) normal. For a ray (o, d):

    o' = W [o; 1],  d' = W [d; 0]
    t = -o'_w / d'_w,  u = o'_u + t d'_u,  v = o'_v + t d'_v
    hit <=> u >= 0, v >= 0, u + v <= 1, tnear <= t <= tfar

The ray/triangle kernels (`kernels/ray_tri.py`) evaluate exactly this, as
does `intersect_block` in plain tensor code.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_restir_torch.kernels import ray_tri


def build_woop_matrices(tri_v: np.ndarray) -> np.ndarray:
    """(N, 3, 3) vertices -> (N, 3, 4) float32 maps, built in float64.
    Rows are the (u, v, w) coefficient rows; column 3 is the translation.
    Degenerate triangles get a map that never produces a valid hit."""
    v = np.asarray(tri_v, np.float64)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    a = np.stack([e1, e2, n], axis=-1)          # (N, 3, 3) columns e1,e2,n
    det = np.linalg.det(a)
    ok = np.abs(det) > 1e-18
    a_safe = np.where(ok[:, None, None], a, np.eye(3)[None])
    inv = np.linalg.inv(a_safe)
    trans = -np.einsum("nij,nj->ni", inv, v[:, 0])
    m = np.concatenate([inv, trans[:, :, None]], axis=-1)
    # degenerate: send everything to u = v = +inf so the hit test fails
    m[~ok] = 0.0
    m[~ok, 0, 3] = np.inf
    m[~ok, 1, 3] = np.inf
    return m.astype(np.float32)


def _pack(m: torch.Tensor) -> torch.Tensor:
    """(N, 3, 4) maps -> (4, 3N) operand of `intersect_block`, the u, v, w
    rows of each triangle side by side (tpu_restir/kernels/woop.py:55-58)."""
    return m.reshape(m.shape[0] * 3, 4).T


def intersect_block(o, d, w_packed, tnear, tfar):
    """Rays (C, 3) x packed triangles (4, 3B) -> t, u, v, ok, each (C, B)
    (tpu_restir/kernels/woop.py:61-87): K1's plain test
    (`ray_tri._woop_tuvok`) on the unpacked rows.

    The JAX package takes o' and d' as two matmuls. Here the four
    products of each coefficient are written out and summed in K1's
    order, ((x w0 + y w1) + z w2) + w3: no tensor core and no TF32, whose
    truncated products gave false hits, and on the card the same bits as
    K1. XLA's CPU dot sums in an order of its own that depends on the
    shapes, so t, u and v can differ from the JAX package's in the last
    bits. Watertight slack 1e-5 on u, v and u + v; both divisions are safe
    under autograd."""
    rows = w_packed.reshape(4, -1, 3).permute(1, 2, 0).reshape(-1, 12)
    return ray_tri._woop_tuvok(o, d, tnear, tfar, rows)
