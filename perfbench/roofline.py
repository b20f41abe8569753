"""Speed-of-light arithmetic on one NVIDIA H100 SXM (80 GB): the card's
published ceilings and the operation and byte counts of the ray/triangle
tests, copied from the port's `roofline.py` so that a change to the
program cannot move the yardstick.

  HBM_BYTES_PER_S  3.35e12 bytes/s (the data sheet, 700 W);
  FP32_OPS_PER_S   33.5e12 float32 instructions/s without contraction:
                   132 SMs x 128 lanes x 1.98 GHz, one instruction a lane
                   a clock (the data sheet's 67e12 counts a fused
                   multiply-add as two). K1/K2 build with --fmad=false, so
                   each product and each sum is an instruction.

A Woop row (K1/K2) is 40 operations, a Moller-Trumbore row 46, a box test
28. A bound counts every input byte read once and every output byte
written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12

WOOP_OPS = 40
MT_OPS = 46
SLAB_OPS = 28
RAY_BYTES = 32        # o, d, tnear, tfar of one ray
HIT_BYTES = 16        # t, u, v, tri of one closest hit
OCC_BYTES = 1         # one occlusion flag
WOOP_ROW_BYTES = 48   # one triangle's 3x4 Woop map


def bound_s(ops: float, nbytes: float):
    """(least seconds, "operations" or "bytes"): the larger of operations
    over the float32 rate and bytes over the memory rate."""
    t_ops = ops / FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fused_query(kind: str, n_rays: int, n_tris: int):
    """A K1 ("closest") or K2 ("any") query: every (ray, triangle) pair
    tested whole -> (operations, bytes)."""
    out = HIT_BYTES if kind == "closest" else OCC_BYTES
    return (float(n_rays) * n_tris * WOOP_OPS,
            float(n_rays) * (RAY_BYTES + out) + float(n_tris) * WOOP_ROW_BYTES)
