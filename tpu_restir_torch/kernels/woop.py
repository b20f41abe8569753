"""Per-triangle affine (Woop) transforms, host side.

The numpy builder of `tpu_restir.kernels.woop.build_woop_matrices`
(whose module imports JAX): each triangle gets the affine map W that
sends it to the unit triangle {(0,0,0), (1,0,0), (0,1,0)} with the third
coordinate along the (unscaled) normal. For a ray (o, d):

    o' = W [o; 1],  d' = W [d; 0]
    t = -o'_w / d'_w,  u = o'_u + t d'_u,  v = o'_v + t d'_v
    hit <=> u >= 0, v >= 0, u + v <= 1, tnear <= t <= tfar

The ray/triangle kernels (`kernels/ray_tri.py`) evaluate exactly this.
"""

from __future__ import annotations

import numpy as np


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
