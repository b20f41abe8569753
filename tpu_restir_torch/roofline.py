"""Speed-of-light accounting on one NVIDIA H100 (counterpart of
`tpu_restir.roofline`, with the card's ceilings in place of the TPU's):
the float32 operations and memory bytes of a kernel call, and the least
time the card could take for them.

The ceilings are NVIDIA's data sheet figures for the H100 SXM (80 GB), at
its 700 W power limit; a card set below that limit runs slower under
load, so a bound is stated with the card's name and limit beside it
(`nvidia-smi --query-gpu=name,power.limit`). Neither is measured here.

  HBM_BYTES_PER_S  3.35e12 bytes/s, the memory rate;
  FP32_OPS_PER_S   33.5e12 float32 instructions/s without contraction:
                   132 SMs x 128 lanes x 1.98 GHz, one instruction a lane
                   a clock (the data sheet's 67e12 counts a fused
                   multiply-add as two). The ray/triangle kernels build
                   with --fmad=false, so each product and each sum is an
                   instruction of its own.
  FP64_OPS_PER_S   16.75e12 float64 instructions/s: 132 SMs x 64 FP64
                   lanes x 1.98 GHz (the data sheet's 33.5e12 float64
                   FLOP/s counts a fused multiply-add as two); the bound of
                   K10, the incomplete beta, which builds with --fmad=false.

The per-test counts are those of the plain tests (`chip_smoke.py`
`ray_tri_ops`, `trace_ops`): a Woop row 40 operations, a Moller-Trumbore
row 46, a box test 28. A bound counts every input byte read once and
every output byte written once. All functions are arithmetic over
shapes and counts; the device-side count of what ran is the ray census
of `render.intersect`'s `rays.` counts (`summarize_query_log`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# --- H100 SXM 80GB ceilings (NVIDIA's data sheet, 700 W) -----------------
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
FP64_OPS_PER_S = 16.75e12

# --- float32 operations of one test, from the plain tests ----------------
WOOP_OPS = 40      # a Woop row (K1/K2/K7/K8, 'woop_mxu', 'cluster')
MT_OPS = 46        # a fused Moller-Trumbore row (K5/K6, 'brute', 'fcluster')
# the leading parts of a test that can rule a row out alone
WOOP_T_OPS = 13    # the Woop t half: dw (5), ow (6), t = -ow / dw (2)
WOOP_TU_OPS = 26   # ... and u = ou + t du (13)
MT_U_OPS = 24      # p = d x e2 (9), det (5), 1 / det, tv = o - v0 (3), u (6)
# a box test of one ray (slab_live of csrc/cluster_trace.cu): the plane
# distances (6 subtractions, 6 products), the per-axis entries and exits (6
# min/max), tent (3 max), texit (2 min), the slack (3) and its two uses (2);
# compares and selects are not counted, as the row counts count none
SLAB_OPS = 28
SAFE_INV_OPS = 3   # a ray's clamped reciprocal direction, once per ray
RAY_BYTES = 32     # o, d, tnear, tfar of one ray
HIT_BYTES = 16     # t, u, v, tri of one closest hit
TRI_ROW_BYTES = 36  # v0, e1, e2 of one cluster row (the (C, B, 9) blocks)
WOOP_ROW_BYTES = 48  # one triangle's 3x4 Woop map

# K9, phase 1's keys (`shortlist_keys`), counted from the plain test as the
# kernel runs it (`chip_smoke.key_work`); here compares count, as the
# slice boxes are nothing else:
KEY_AXIS_OPS = 31       # an axis of the interval test: the distances to the
#                         box's two planes (2 x (2 subtractions, 4 products,
#                         3 min, 3 max)), the axis's entry and exit (2),
#                         their folds into the pair's (2), three compares
KEY_SPAN0_AXIS_OPS = 5  # an axis whose direction interval spans zero: the
#                         folds (2) and the compares (3)
KEY_SLICE_OPS = 6       # a slice box of the sub-box cull: six compares
KEY_PAIR_OPS = 1        # the key: max(entry, tn)
KEY_RAY_OPS = 148       # a live ray: the live test (7), its t span (1), 9
#                         points (9 x 8) and 68 values folded into the
#                         packet's summary
KEY_BYTES = 4           # a key written
BOX_BYTES = 24          # a (super)cluster box read

# K10, the incomplete beta of calc_i_m (`csrc/ibeta.cu`), one lane: 128
# Lentz half-steps of 11 products and sums and 3 divisions, a division
# counted as 10 FP64 instructions (its reciprocal seed and Newton steps),
# 128 x (11 + 3 x 10); the lane's one log, log1p and exp and three lgamma
# are not counted
IBETA_LANE_OPS = 5248
IBETA_LANE_BYTES = 24   # x and a read (b broadcast), the value written

# The JAX package's count of its phase-1 interval test of one (packet,
# cluster) pair (150) and of one swept slice box (6), and of one packet
# summary a ray (60): operation counts of the same algorithm, not rates.
PHASE1_PAIR_OPS = 150.0
PHASE1_SLICE_OPS = 6.0
PHASE1_RAY_OPS = 60.0


@dataclass
class KernelSpec:
    """One kernel call's work: float32 operations and memory bytes."""

    name: str
    flops: float            # float32 operations
    bytes_hbm: float        # memory bytes (each input read, output written)

    @property
    def intensity(self) -> float:
        """Operations per byte."""
        return self.flops / max(self.bytes_hbm, 1.0)

    @property
    def ridge(self) -> float:
        """The intensity at which the two ceilings meet (operations/byte)."""
        return FP32_OPS_PER_S / HBM_BYTES_PER_S

    @property
    def bound(self) -> str:
        """"operations" or "bytes": the ceiling that bounds the call."""
        return "operations" if self.intensity >= self.ridge else "bytes"

    def sol_time_s(self) -> float:
        """The least time: the larger of operations over the float32 rate
        and bytes over the memory rate."""
        return max(self.flops / FP32_OPS_PER_S,
                   self.bytes_hbm / HBM_BYTES_PER_S)

    def report(self, measured_s: Optional[float] = None) -> str:
        sol = self.sol_time_s()
        line = (f"{self.name}: {self.flops / 1e9:.2f} Gop, "
                f"{self.bytes_hbm / 1e6:.1f} MB, {self.intensity:.1f} op/B "
                f"({self.bound}-bound, ridge {self.ridge:.1f}), bound "
                f"{sol * 1e3:.3f} ms")
        if measured_s is not None and measured_s > 0:
            line += (f", measured {measured_s * 1e3:.3f} ms = "
                     f"{100.0 * sol / measured_s:.0f}% of the bound, "
                     f"{self.flops / measured_s / 1e12:.2f} Top/s")
        return line


def ptrace_query_spec(name: str, n_rays: int, clusters_visited: int,
                      block: int, packet: int = 256) -> KernelSpec:
    """One clustered query (K5/K6, `kernels/cluster_trace.py`):
    clusters_visited shortlist entries traversed in all, each a (block x
    packet) tile of Moller-Trumbore rows and one read of its cluster
    block; the rays in and the hits out."""
    pairs = float(clusters_visited) * block * packet
    return KernelSpec(
        name=name, flops=pairs * MT_OPS,
        bytes_hbm=(clusters_visited * block * TRI_ROW_BYTES
                   + n_rays * (RAY_BYTES + HIT_BYTES)))


def phase1_spec(name: str, n_rays: int, n_clusters: int,
                packet: int = 256, slices: int = 8) -> KernelSpec:
    """The dense culling phase (`cluster_trace.build_shortlists`): every
    (packet, cluster) pair's interval and swept-box tests, a summary per
    ray; bytes: the rays and about five (packets, clusters) int32
    arrays."""
    rp = -(-n_rays // packet)
    pairs = float(rp) * n_clusters
    return KernelSpec(
        name=name,
        flops=pairs * (PHASE1_PAIR_OPS + PHASE1_SLICE_OPS * slices)
        + n_rays * PHASE1_RAY_OPS,
        bytes_hbm=pairs * 4 * 5 + n_rays * RAY_BYTES)


def shading_spec(name: str, n_pixels: int, flops_per_pixel: float,
                 channels: int) -> KernelSpec:
    """An elementwise pass: `channels` float32 in and out per pixel."""
    return KernelSpec(name=name, flops=n_pixels * flops_per_pixel,
                      bytes_hbm=n_pixels * channels * 4 * 2)


def gather_spec(name: str, n_pixels: int, taps: int, channels: int,
                r_bound: int) -> KernelSpec:
    """The windowed tap gather (K3, `kernels/local_gather.py`), a bytes
    bound as `chip_smoke.check_gather` takes it: the payload read once,
    the tap coordinates (two int32 a tap) and the taps written. r_bound,
    the window radius, moves no bytes: the card's gather has no window."""
    del r_bound
    return KernelSpec(
        name=name, flops=0.0,
        bytes_hbm=4.0 * (n_pixels * channels + 2 * taps * n_pixels
                         + taps * n_pixels * channels))


def phat_spec(name: str, n_pixels: int, n_evals: int) -> KernelSpec:
    """p_hat evaluation without its occlusion query (`restir/phat.py`):
    the JAX package's count of ~220 operations a pixel (BRDF dispatch and
    geometry terms) over ~24 input channels and one output."""
    return KernelSpec(name=name, flops=n_pixels * 220.0 * n_evals,
                      bytes_hbm=n_pixels * 25 * 4 * n_evals)


def fused_query_spec(name: str, n_rays: int, n_tris: int) -> KernelSpec:
    """A small-scene query (K1, `kernels/ray_tri.py`): every ray against
    every triangle's Woop rows; the rays in, the hits out and the maps
    read once."""
    return KernelSpec(
        name=name, flops=float(n_rays) * n_tris * WOOP_OPS,
        bytes_hbm=n_rays * (RAY_BYTES + HIT_BYTES) + n_tris * WOOP_ROW_BYTES)


@dataclass
class FrameModel:
    """Accumulates per-kernel specs for a frame; prints a roofline table."""

    kernels: List[KernelSpec] = field(default_factory=list)

    def add(self, spec: KernelSpec) -> None:
        self.kernels.append(spec)

    def total_sol_s(self) -> float:
        return sum(k.sol_time_s() for k in self.kernels)

    def report(self, measured_frame_s: Optional[float] = None) -> str:
        lines = [k.report() for k in self.kernels]
        sol = self.total_sol_s()
        tail = f"frame bound {sol * 1e3:.1f} ms"
        if measured_frame_s:
            tail += (f"; measured {measured_frame_s * 1e3:.1f} ms = "
                     f"{100.0 * sol / measured_frame_s:.0f}% of the bound")
        lines.append(tail)
        return "\n".join(lines)


def summarize_query_log(recorded: List[Tuple[str, int]]) -> Dict:
    """The (name, value) entries of a `tracing.recording()` -> per-kind
    query and ray totals of its `rays.<kind>.<backend>` entries (one a
    query, `render.intersect`), and "total_rays"."""
    out: Dict[str, Dict[str, float]] = {}
    for name, rays in recorded:
        if name.startswith("rays."):
            k = out.setdefault(name.split(".")[1], {"queries": 0, "rays": 0})
            k["queries"] += 1
            k["rays"] += rays
    out["total_rays"] = sum(v["rays"] for v in out.values()
                            if isinstance(v, dict))
    return out
