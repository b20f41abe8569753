"""Packet-shortlist cluster traversal ("ptrace"), the large-scene queries:
K5 (closest hit) and K6 (any hit), the counterparts of
`tpu_restir.kernels.cluster_trace` `_closest_kernel` and `_any_kernel`,
and their Woop variant K7/K8 (`_closest_kernel_mxu`, `_any_kernel_mxu`).

Rays are grouped into packets of P = 256 consecutive rays (an 8x32 pixel
tile after `render.intersect`'s swizzle).

  Phase 1 (XLA code in the JAX package): each packet's interval hull is
  slab-tested against every (super)cluster AABB, with a conservative entry
  distance per passing pair, and one stable sort per packet orders the
  passing clusters front to back: a shortlist and a count per packet
  (`build_shortlists`). The sort keys before the sort are one kernel, K9
  (`csrc/cluster_trace.cu`), on CUDA tensors (`packet_keys`, span
  `phase1.keys`, `launch.shortlist_keys`), and plain PyTorch tensor ops,
  `shortlist_keys`, on CPU tensors (spans `phase1.interval` and
  `phase1.boxcull`); the sort is PyTorch's on both (`phase1.sort`).
  `pack` counts the packets, the pairs tested and the pairs listed
  (`tracing.count`), and the slots phase 2 is given (`phase2.slots`, the
  listed pairs times the supercluster factor); its supercluster and
  scene boxes are the span `phase1.superboxes`.

  Phase 2 (the kernels of `csrc/cluster_trace.cu` on CUDA tensors, the
  plain versions `trace_closest_ref` / `trace_any_ref` on CPU tensors):
  each packet tests its rays against the triangles of exactly its own
  shortlist by fused Moller-Trumbore and folds a running (t, u, v, tri)
  with a strict `<`, in shortlist order and then row order, so ties go to
  the earlier-listed cluster. The kernels stop early (closest: once the
  next entry distance passes every ray's min(best_t, tfar); any: once
  every live ray is occluded) and, above SMALL_C clusters, skip a slot
  that no ray's own slab test can reach (mode 5: K6 always, K5 wherever
  its cull boxes are the clusters' own, so on every factor-1 scene; the
  TPU runs closest hit there without a cull, but on the card a slot
  costs K5 a 64-row stage and a barrier, and incoherent bounce packets
  list hundreds of clusters that none of their rays reach); the plain
  versions test every listed slot, so they are the exact definition the
  kernels must reproduce bit for bit. Each kernel launch counts
  `launch.<wrapper>` (`launch.trace_closest`, ..., `tracing.count`), each
  launch that culls in mode 5 `cull.<wrapper>` too, and a closest-hit
  launch the slots its packets staged (`phase2.staged`, a tensor the
  kernel writes) and its packets (`phase2.closest_packets`).

Scenes above SUPER_MAX clusters group F = pick_factor(C) consecutive
leaf-order clusters into one supercluster for phase 1; shortlist slot s
maps to cluster min(sl[s // F] * F + s % F, C - 1). Triangle ids are
leaf-order ids cluster * B + row; a miss is t = inf, tri = -1, and dead
rays (tfar < tnear, including the padding) miss, or are not occluded.

The Woop variant (`ptrace_mxu`): scenes built at B = WOOP_BLOCK = 128
carry (C, 4, 384) Woop blocks (`build_cluster_woop`), and where F is 1
`trace_closest` / `trace_any` given them run K7/K8
(`csrc/cluster_trace.cu` with the Woop test; plain versions
`trace_closest_mxu_ref` / `trace_any_mxu_ref`) in place of K5/K6: the
same phase 1, slots and fold, with K1's Woop test (`kernels/ray_tri.py`,
watertight epsilon 1e-5) in place of Moller-Trumbore. K7 runs no per-ray
cull, as on the TPU; K8 culls as K6 does (mode 5 above SMALL_C
clusters), against the cluster boxes grown by the Woop test's reach
(`woop_cull_boxes`), which the TPU kernel does not. Otherwise they take
K5/K6, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tpu_restir_torch import tracing
from tpu_restir_torch.accel.fcluster import _clamp_tfar_bbox, _packet_bounds
from tpu_restir_torch.kernels import build

P = 256            # rays per packet == one 8x32 pixel tile
SUPER_MAX = 4096   # most shortlist entries per packet (see pick_factor)
BOX_MAX = 16_000   # mode-5 culls use per-cluster boxes up to this count
SMALL_C = 64       # scenes of at most this many clusters run no cull

WOOP_BLOCK = 128   # triangles per cluster of the Woop variant (one lane tile)
# K8's cull boxes: each cluster AABB grown by WOOP_BOX_REL of its extent
# per axis and WOOP_BOX_ABS of its largest coordinate (`woop_cull_boxes`)
WOOP_BOX_REL = 4e-5
WOOP_BOX_ABS = 4e-6

_INF = float("inf")
_BARY_EPS = 1e-5   # the Woop test's watertight slack, as kernels/ray_tri.py
_BIG = 3.0e38
_REF_PACKETS = 256   # packets per broadcast in the plain versions
_P = ctypes.c_void_p
_I = ctypes.c_int
tracing.COUNTS.update(dict.fromkeys(
    ("launch.trace_closest", "launch.trace_any", "launch.trace_closest_mxu",
     "launch.trace_any_mxu", "launch.shortlist_keys", "cull.trace_closest",
     "cull.trace_any", "cull.trace_any_mxu"), 0))


# ---------------------------------------------------------------------------
# Phase 1: dense packet-vs-cluster culling with entry distances
# ---------------------------------------------------------------------------

def _interval_axis(a: int, omin, omax, dmin, dmax, cmin, cmax):
    """Axis a of the interval pass: spans0 (Rp, 1), whether the packet's
    direction interval comes within 1e-12 of zero (the axis then
    constrains nothing), and the axis's entry and exit bounds (Rp, C):
    -_BIG and _BIG where spans0, else the least and the greatest plane
    distance of the packet's hull to the box's two planes."""
    dlo = dmin[:, a:a + 1]
    dhi = dmax[:, a:a + 1]
    spans0 = (dlo <= 1e-12) & (dhi >= -1e-12)
    safe_lo = torch.where(spans0, 1.0, dlo)
    safe_hi = torch.where(spans0, 1.0, dhi)
    rlo = torch.minimum(1.0 / safe_lo, 1.0 / safe_hi)
    rhi = torch.maximum(1.0 / safe_lo, 1.0 / safe_hi)
    rlo = torch.clamp(rlo, -1e12, 1e12)
    rhi = torch.clamp(rhi, -1e12, 1e12)
    planes = []
    for bound in (cmin, cmax):
        blo_n = bound[None, :, a] - omax[:, a:a + 1]
        bhi_n = bound[None, :, a] - omin[:, a:a + 1]
        q1 = blo_n * rlo
        q2 = blo_n * rhi
        q3 = bhi_n * rlo
        q4 = bhi_n * rhi
        planes.append((
            torch.minimum(torch.minimum(q1, q2), torch.minimum(q3, q4)),
            torch.maximum(torch.maximum(q1, q2), torch.maximum(q3, q4))))
    (t1lo, t1hi), (t2lo, t2hi) = planes
    return (spans0,
            torch.where(spans0, -_BIG, torch.minimum(t1lo, t2lo)),
            torch.where(spans0, _BIG, torch.maximum(t1hi, t2hi)))


def _interval_pass_entry(omin, omax, dmin, dmax, tnmin, tfmax, cmin, cmax):
    """Conservative packet-vs-cluster slab test by interval arithmetic
    (cluster_trace.py:131-178) -> passes (Rp, C) bool and entry_lo
    (Rp, C): a lower bound on the t at which any ray of the packet's hull
    can enter the cluster."""
    rp = omin.shape[0]
    c = cmin.shape[0]
    dev = omin.device
    entry_lo = torch.full((rp, c), -_BIG, device=dev)
    exit_hi = torch.full((rp, c), _BIG, device=dev)
    for a in range(3):
        _spans0, a_entry_lo, a_exit_hi = _interval_axis(a, omin, omax, dmin,
                                                        dmax, cmin, cmax)
        entry_lo = torch.maximum(entry_lo, a_entry_lo)
        exit_hi = torch.minimum(exit_hi, a_exit_hi)
    passes = ((entry_lo <= exit_hi)
              & (exit_hi >= tnmin[:, None])
              & (entry_lo <= tfmax[:, None]))
    return passes, entry_lo


def box_overlap(emin, emax, cmin, cmax):
    """The swept sub-box cull: (Rp, C) bool, whether a cluster box
    overlaps one of the packet's t-sliced hull boxes emin, emax (Rp, S, 3)
    (one slice at a time: (Rp, C, 3), not (Rp, C, S, 3))."""
    box_ok = torch.zeros((emin.shape[0], cmin.shape[0]), dtype=torch.bool,
                         device=emin.device)
    for s in range(emin.shape[1]):
        box_ok |= ((emin[:, None, s, :] <= cmax[None, :, :])
                   & (emax[:, None, s, :] >= cmin[None, :, :])).all(-1)
    return box_ok


def shortlist_keys(o, d, tnear, tfar, cmin, cmax, p: int = P):
    """Phase 1 before its sort: rays (R, 3), R a multiple of p -> the sort
    key (Rp, C) float32 of each (packet, cluster) pair, its conservative
    entry distance (at least the packet's least tnear) where the interval
    pass and the swept sub-box cull pass it, +inf elsewhere, and the count
    (Rp,) int32 of passing clusters. The plain version of K9
    (`packet_keys`)."""
    (omin, omax, dmin, dmax, tn, tf,
     bounded, emin, emax) = _packet_bounds(o, d, tnear, tfar, p)
    with tracing.span("phase1.interval"):
        passes, entry = _interval_pass_entry(omin, omax, dmin, dmax, tn, tf,
                                             cmin, cmax)
    with tracing.span("phase1.boxcull"):
        passes &= box_overlap(emin, emax, cmin, cmax) | ~bounded[:, None]
    key = torch.where(passes, torch.maximum(entry, tn[:, None]), _INF)
    return key, passes.sum(1, dtype=torch.int32)


def build_shortlists(o, d, tnear, tfar, cmin, cmax):
    """Rays (R, 3), R a multiple of P -> per-packet front-to-back cluster
    shortlists (cluster_trace.py:191-221): count (Rp,) int32, shortlist
    (Rp, C) int32 and entry (Rp, C) float32 ascending, +inf past count.
    Conservative: every cluster that a ray of the packet could hit within
    [tnear, tfar] is listed. Equal entries keep cluster order (a stable
    sort, as lax.sort with one key), which decides ties between hits."""
    key, count = packet_keys(o, d, tnear, tfar, cmin, cmax)
    with tracing.span("phase1.sort"):
        ent_sorted, sl = torch.sort(key, dim=1, stable=True)
    return count, sl.to(torch.int32), ent_sorted


def _super_boxes(cmin, cmax, factor: int):
    """Supercluster AABBs over groups of `factor` consecutive clusters (the
    last group repeats the final cluster's box)."""
    if factor == 1:
        return cmin, cmax
    c = cmin.shape[0]
    s = -(-c // factor)
    pad = s * factor - c
    if pad:
        cmin = torch.cat([cmin, cmin[-1:].expand(pad, 3)])
        cmax = torch.cat([cmax, cmax[-1:].expand(pad, 3)])
    return (cmin.reshape(s, factor, 3).amin(1),
            cmax.reshape(s, factor, 3).amax(1))


def pick_factor(n_clusters: int) -> int:
    """Supercluster factor: the smallest F with ceil(C / F) <= SUPER_MAX
    (F = 1 up to ~262k triangles at B = 64)."""
    return -(-n_clusters // SUPER_MAX)


def _skip_for(kind: str, c: int, factor: int = 1) -> int:
    """Per-ray cull mode of K5/K6: 0 (none) at C <= SMALL_C; 5 (slab cull)
    for any hit, and for closest hit where the cull boxes are per cluster
    (`cull_boxes`: factor 1, or C <= BOX_MAX); 0 for closest hit on
    supercluster boxes. The JAX package's production defaults
    (cluster_trace.py:1100-1109) but for closest hit at factor 1, which
    the TPU runs in mode 0."""
    if c <= SMALL_C:
        return 0
    if kind == "any" or factor == 1 or c <= BOX_MAX:
        return 5
    return 0


def launch_mode(kind: str, c: int, factor: int = 1) -> int:
    """The cull mode a launch of `kind` (a key of `_KINDS`) runs in: K7
    none, whose exactness under a cull on the Woop test's grown boxes has
    been shown for any hit alone; the others `_skip_for`'s."""
    if kind == "trace_closest_mxu":
        return 0
    return _skip_for("closest" if kind == "trace_closest" else "any", c,
                     factor)


@dataclasses.dataclass
class Packets:
    """Rays in packet order with their phase-1 shortlists. o, d (Rp*P, 3),
    tnear, tfar (Rp*P,) (tfar clamped to the scene box, padding dead);
    count (Rp,), shortlist (Rp, S) int32, entry (Rp, S) float32; factor
    F; n_rays, the rays before the padding."""

    o: torch.Tensor
    d: torch.Tensor
    tnear: torch.Tensor
    tfar: torch.Tensor
    count: torch.Tensor
    shortlist: torch.Tensor
    entry: torch.Tensor
    factor: int
    n_rays: int

    def take(self, idx) -> "Packets":
        """The packets idx (1-D int tensor), as a Packets of their own."""
        idx = idx.to(self.o.device).long()
        rows = (idx[:, None] * P
                + torch.arange(P, device=idx.device)[None, :]).reshape(-1)
        return Packets(o=self.o[rows].contiguous(),
                       d=self.d[rows].contiguous(),
                       tnear=self.tnear[rows].contiguous(),
                       tfar=self.tfar[rows].contiguous(),
                       count=self.count[idx].contiguous(),
                       shortlist=self.shortlist[idx].contiguous(),
                       entry=self.entry[idx].contiguous(),
                       factor=self.factor, n_rays=rows.shape[0])


def pack(cmin, cmax, o, d, tnear, tfar, factor: int) -> Packets:
    """Clamp tfar to the scene box, pad to a packet multiple (tfar = -1:
    dead) and build the shortlists against the supercluster AABBs, as
    `_pack` (cluster_trace.py:962-994) without the TPU's channel blocks."""
    r = o.shape[0]
    with tracing.span("phase1.superboxes"):
        scmin, scmax = (x.contiguous()
                        for x in _super_boxes(cmin, cmax, factor))
        lo, hi = scmin.amin(0), scmax.amax(0)
    tnear = tnear.expand(r)
    tfar = _clamp_tfar_bbox(o, d, tnear, tfar.expand(r), lo, hi)
    pad = (-r) % P
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_zeros((pad, 3))])
        tnear = torch.cat([tnear, tnear.new_zeros((pad,))])
        tfar = torch.cat([tfar, tfar.new_full((pad,), -1.0)])
    o, d, tnear, tfar = (x.contiguous() for x in (o, d, tnear, tfar))
    cnt, sl, ent = build_shortlists(o, d, tnear, tfar, scmin, scmax)
    rp = cnt.shape[0]
    tracing.count("phase1.listed", cnt)
    tracing.count("phase1.packets", rp)
    tracing.count("phase1.pairs", rp * scmin.shape[0])
    # each listed supercluster expands to `factor` slots; a view, no launch
    tracing.count("phase2.slots",
                  cnt if factor == 1 else cnt.expand(factor, rp))
    return Packets(o=o, d=d, tnear=tnear, tfar=tfar, count=cnt,
                   shortlist=sl.contiguous(), entry=ent.contiguous(),
                   factor=factor, n_rays=r)


def cull_boxes(cmin, cmax, factor: int):
    """The mode-5 slab-cull boxes: per cluster while C <= BOX_MAX (or
    factor 1), else per supercluster -> (bmin, bmax, per_cluster)."""
    if factor == 1 or cmin.shape[0] <= BOX_MAX:
        return cmin, cmax, True
    scmin, scmax = _super_boxes(cmin, cmax, factor)
    return scmin, scmax, False


def woop_cull_boxes(cmin, cmax):
    """K8's mode-5 cull boxes: the cluster AABBs (C, 3) grown by the reach
    of the Woop test. Its watertight slack passes u, v and 1 - u - v down
    to -1e-5, so a hit can lie outside its triangle by up to 2e-5 of the
    triangle's extent along each axis, and so outside the cluster's box: a
    ray lying just past a box face hits there, and the per-ray slab test
    of the box itself would cull it. Each box grows by WOOP_BOX_REL (twice
    that reach) of its own extent per axis, plus WOOP_BOX_ABS of its
    largest coordinate magnitude for the rounding of the Woop terms.
    tests/test_torch_any_skips.py holds that no ray `slab_live_ref` calls
    dead for a triangle's grown box hits it by the Woop test. The plain
    version of K8's `cull_box`, which grows each box as it reads it, in
    the same float32 operations."""
    big = torch.maximum(cmin.abs(), cmax.abs()).amax(-1, keepdim=True)
    m = WOOP_BOX_REL * (cmax - cmin) + WOOP_BOX_ABS * big
    return (cmin - m).contiguous(), (cmax + m).contiguous()


def slab_live_ref(o, d, tnear, upper, bmin, bmax):
    """Plain version of the kernels' per-ray slab test (`slab_live` of
    csrc/cluster_trace.cu, the mode-5 cull): can the ray o + t d enter the
    box [bmin, bmax] at a t in [tnear, upper]? o, d, bmin, bmax (..., 3),
    tnear, upper (...) -> (...) bool, all broadcast.

    The plane distances use `safe_inv`'s reciprocal (`_ray_inv` of the
    JAX kernel): a component of magnitude at most 1e-20 becomes +-1e20
    with its sign. On such an axis the ray does not leave the slab unless
    it lies beyond it (both distances negative): the clamp shortens the
    exit, which would put a ray lying in a box's max-face plane out of
    the box at t = 0 although it can hit a triangle edge in that plane
    (the JAX kernel's `_slab_entry_exit` has that fault). Relative and
    absolute slack, so that rounding cannot cull a graze. Conservative: a
    ray it calls dead has no hit in the box (tests/test_torch_any_skips.py)."""
    small = ~(d.abs() > 1e-20)   # NaN too, as the kernel's compare
    inv = torch.where(small, torch.where(d >= 0, 1e20, -1e20), 1.0 / d)
    t1 = (bmin - o) * inv
    t2 = (bmax - o) * inv
    lo = torch.fmin(t1, t2)
    hi = torch.fmax(t1, t2)
    hi = torch.where(small & (hi >= 0.0), _INF, hi)
    tent = torch.fmax(torch.fmax(lo[..., 0], lo[..., 1]),
                      torch.fmax(lo[..., 2], tnear))
    texit = torch.fmin(torch.fmin(hi[..., 0], hi[..., 1]), hi[..., 2])
    slack = 1e-4 * (tent.abs() + texit.abs()) + 1e-5
    return (tent <= texit + slack) & (tent - slack <= upper)


# ---------------------------------------------------------------------------
# Phase 2, plain versions: every listed slot, no early-out, no cull
# ---------------------------------------------------------------------------

def _mt(tr, ox, oy, oz, dx, dy, dz, tn, tf):
    """Fused Moller-Trumbore in the operation order of `_mt_cluster`
    (cluster_trace.py:235-260): triangles tr (A, B, 9) against rays
    (A, 1, P) -> t, u, v, ok of shape (A, B, P)."""
    v0x, v0y, v0z = tr[..., 0:1], tr[..., 1:2], tr[..., 2:3]
    e1x, e1y, e1z = tr[..., 3:4], tr[..., 4:5], tr[..., 5:6]
    e2x, e2y, e2z = tr[..., 6:7], tr[..., 7:8], tr[..., 8:9]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = torch.abs(det) > 1e-18
    inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    ok &= (t >= tn) & (t <= tf)
    return t, u, v, ok


def _slots(c: int, pk: Packets):
    """Yield (packet index (A,), cluster (A,)) for every listed slot of a
    scene of c clusters, for at most _REF_PACKETS packets at a time, slot
    by slot in order."""
    f = pk.factor
    s_last = pk.shortlist.shape[1] - 1
    ns = pk.count.long() * f
    n_slots = int(ns.max()) if ns.numel() else 0
    for j in range(n_slots):
        act = torch.nonzero(ns > j)[:, 0]
        q = min(j // f, s_last)
        for k in range(0, act.shape[0], _REF_PACKETS):
            a = act[k:k + _REF_PACKETS]
            sc = pk.shortlist[a, q].long()
            yield a, sc if f == 1 else torch.clamp(sc * f + j % f, max=c - 1)


def _packet_rays(pk: Packets):
    rp = pk.count.shape[0]
    o = pk.o.reshape(rp, 1, P, 3)
    d = pk.d.reshape(rp, 1, P, 3)
    return (o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2],
            pk.tnear.reshape(rp, 1, P), pk.tfar.reshape(rp, 1, P))


def _woop(wc, ox, oy, oz, dx, dy, dz, tn, tf):
    """K1's Woop test (`ray_tri._woop_tuvok`, in its operation order:
    ((o_x w_0 + o_y w_1) + o_z w_2) + w_3, the direction without the
    translation) of Woop blocks wc (A, 4, 3 * WOOP_BLOCK) against rays
    (A, 1, P) -> t, u, v, ok of shape (A, WOOP_BLOCK, P)."""
    w = wc.reshape(wc.shape[0], 4, 3, WOOP_BLOCK, 1)   # (A, k, comp, lane)

    def aff(c):
        return ox * w[:, 0, c] + oy * w[:, 1, c] + oz * w[:, 2, c] \
            + w[:, 3, c]

    def lin(c):
        return dx * w[:, 0, c] + dy * w[:, 1, c] + dz * w[:, 2, c]

    ow, dw = aff(2), lin(2)
    t = torch.where(torch.abs(dw) > 1e-18, -ow / dw, _INF)
    u = aff(0) + t * lin(0)
    v = aff(1) + t * lin(1)
    ok = ((u >= -_BARY_EPS) & (v >= -_BARY_EPS)
          & (u + v <= 1.0 + _BARY_EPS) & torch.isfinite(t)
          & (t >= tn) & (t <= tf))
    return t, u, v, ok


def _fold_closest(test, blocks, b: int, pk: Packets):
    """Closest hit of every listed slot's block by `test` (_mt or _woop)
    -> (t, u, v, tri int32), each (Rp*P,): per ray the hit of least t,
    ties to the earlier slot and then the lower row (a strict-< fold in
    that order)."""
    rp = pk.count.shape[0]
    dev = pk.o.device
    bt = torch.full((rp, P), _INF, device=dev)
    bu = torch.zeros((rp, P), device=dev)
    bv = torch.zeros((rp, P), device=dev)
    btri = torch.full((rp, P), -1, dtype=torch.int32, device=dev)
    rays = _packet_rays(pk)
    rows = torch.arange(b, device=dev)[None, :, None]
    for a, cl in _slots(blocks.shape[0], pk):
        t, u, v, ok = test(blocks[cl], *(x[a] for x in rays))
        tt = torch.where(ok, t, _INF)
        tmin = tt.amin(1, keepdim=True)                      # (A, 1, P)
        jwin = torch.where(tt <= tmin, rows, b).amin(1, keepdim=True)
        mu = u.gather(1, jwin)[:, 0]
        mv = v.gather(1, jwin)[:, 0]
        mtri = (cl[:, None] * b + jwin[:, 0]).to(torch.int32)
        tmin = tmin[:, 0]
        better = tmin < bt[a]
        bt[a] = torch.where(better, tmin, bt[a])
        bu[a] = torch.where(better, mu, bu[a])
        bv[a] = torch.where(better, mv, bv[a])
        btri[a] = torch.where(better, mtri, btri[a])
    return bt.reshape(-1), bu.reshape(-1), bv.reshape(-1), btri.reshape(-1)


def _fold_any(test, blocks, pk: Packets):
    """(Rp*P,) bool: any listed block's triangle hit within [tnear, tfar]."""
    rp = pk.count.shape[0]
    occ = torch.zeros((rp, P), dtype=torch.bool, device=pk.o.device)
    rays = _packet_rays(pk)
    for a, cl in _slots(blocks.shape[0], pk):
        occ[a] |= test(blocks[cl], *(x[a] for x in rays))[3].any(1)
    return occ.reshape(-1)


def trace_closest_ref(ctris, pk: Packets):
    """Plain version of K5 -> (t, u, v, tri int32), each (Rp*P,)."""
    return _fold_closest(_mt, ctris, ctris.shape[1], pk)


def trace_any_ref(ctris, pk: Packets):
    """Plain version of K6 -> (Rp*P,) bool."""
    return _fold_any(_mt, ctris, pk)


def trace_closest_mxu_ref(cwoop, pk: Packets):
    """Plain version of K7: K5's fold over the Woop test of the listed
    clusters' Woop blocks cwoop (C, 4, 384); factor 1."""
    return _fold_closest(_woop, cwoop, WOOP_BLOCK, pk)


def trace_any_mxu_ref(cwoop, pk: Packets):
    """Plain version of K8 -> (Rp*P,) bool."""
    return _fold_any(_woop, cwoop, pk)


def build_cluster_woop(woop, block: int):
    """Per-triangle Woop maps (N, 3, 4) (`kernels/woop.py`: rows u, v, w;
    column 3 the translation), leaf-ordered -> (C, 4, 3 * block) float32
    Woop blocks, as `build_cluster_woop` (cluster_trace.py:1218-1241) keeps
    them in its rows 0-3: element [c, k, comp * block + j] is coefficient
    k of component comp of triangle c * block + j. Padding triangles are
    zero (d'w = 0: t = inf, never hit), and so are degenerate triangles,
    whose inf translation marker would make a NaN of 0 * inf."""
    if block != WOOP_BLOCK:
        raise ValueError(f"Woop blocks need cluster size {WOOP_BLOCK}, got "
                         f"{block}")
    n = woop.shape[0]
    c = -(-n // block)
    wp = np.zeros((c * block, 3, 4), np.float32)
    wp[:n] = woop
    wp[~np.isfinite(wp).all(axis=(1, 2))] = 0.0
    return np.ascontiguousarray(
        wp.reshape(c, block, 3, 4).transpose(0, 3, 2, 1)
        .reshape(c, 4, 3 * block))


# ---------------------------------------------------------------------------
# The kernels (csrc/cluster_trace.cu: phase 1's keys K9, phase 2's K5-K8)
# ---------------------------------------------------------------------------

_IN = [_P] * 7 + [_I, _I] + [_P, _P, _I] + [_P] + [_I] * 5
_SIGNATURES = {
    "cluster_trace_closest": (_IN + [_P] * 6, ctypes.c_int),
    "cluster_trace_any": (_IN + [_P] * 2, ctypes.c_int),
    "cluster_shortlist_keys": ([_P] * 4 + [_I, _P, _P, _I] + [_P] * 3,
                               ctypes.c_int),
    "cluster_trace_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

# K5-K9 keep the plain version's rounding: no contracted multiply-adds
FLAGS = ("--fmad=false",)

# kind -> (C entry, Woop test)
_KINDS = {"trace_closest": ("cluster_trace_closest", False),
          "trace_any": ("cluster_trace_any", False),
          "trace_closest_mxu": ("cluster_trace_closest", True),
          "trace_any_mxu": ("cluster_trace_any", True)}


def _lib():
    return build.load("cluster_trace", _SIGNATURES, extra_flags=FLAGS)


def _check(who: str, dev, want: dict):
    """Raise unless each named tensor (name -> (tensor, shape, dtype)) is
    a contiguous tensor of its shape and dtype on dev."""
    for name, (x, shape, dtype) in want.items():
        if x.device != dev or x.dtype != dtype \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{who}: {name} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")


def _check_tensors(pk: Packets, **blocks):
    """Validate the packed rays, phase 1's tables and the named blocks
    (name -> (tensor, shape, dtype)): one device, contiguous."""
    n = pk.o.shape[0]
    rp = pk.count.shape[0]
    s = pk.shortlist.shape[1]
    _check("cluster_trace", pk.o.device, {
        "o": (pk.o, (rp * P, 3), torch.float32),
        "d": (pk.d, (n, 3), torch.float32),
        "tnear": (pk.tnear, (n,), torch.float32),
        "tfar": (pk.tfar, (n,), torch.float32),
        "count": (pk.count, (rp,), torch.int32),
        "shortlist": (pk.shortlist, (rp, s), torch.int32),
        "entry": (pk.entry, (rp, s), torch.float32), **blocks})


def _launch(kind, blocks, pk: Packets, outs, cmin=None, cmax=None):
    """Launch `kind` on the cluster blocks (C, B, 9) with their AABBs, or
    the Woop blocks (C, 4, 384) at factor 1 (K8 with the AABBs, which it
    grows as `woop_cull_boxes` does; K7 runs no cull and takes none)."""
    entry, woop = _KINDS[kind]
    c = blocks.shape[0]
    if woop:
        if pk.factor != 1:
            raise ValueError(f"cluster_trace: the Woop kernels take factor "
                             f"1, got {pk.factor}")
        b = WOOP_BLOCK
        skip = launch_mode(kind, c)
        cwoop = (blocks, (c, 4, 3 * b), torch.float32)
        if skip:
            _check_tensors(pk, cwoop=cwoop,
                           cmin=(cmin, (c, 3), torch.float32),
                           cmax=(cmax, (c, 3), torch.float32))
            boxes = (cmin.data_ptr(), cmax.data_ptr(), 1)
        else:
            _check_tensors(pk, cwoop=cwoop)
            boxes = (0, 0, 1)
    else:
        b = blocks.shape[1]
        bmin, bmax, per_cluster = cull_boxes(cmin, cmax, pk.factor)
        bmin, bmax = bmin.contiguous(), bmax.contiguous()
        _check_tensors(pk, ctris=(blocks, (c, b, 9), torch.float32),
                       bmin=(bmin, (bmin.shape[0], 3), torch.float32),
                       bmax=(bmax, (bmin.shape[0], 3), torch.float32))
        if b * 12 * 4 > 48 * 1024:   # rows staged as 12 floats
            raise ValueError(f"cluster_trace: cluster size {b} exceeds the "
                             "kernel's 48 KB shared-memory tile")
        skip = launch_mode(kind, c, pk.factor)
        boxes = (bmin.data_ptr(), bmax.data_ptr(), int(per_cluster))
    # closest hit: the slots each packet staged, written by the kernel
    staged = (torch.empty_like(pk.count) if entry == "cluster_trace_closest"
              else None)
    lib = _lib()
    with torch.cuda.device(pk.o.device):
        stream = torch.cuda.current_stream(pk.o.device).cuda_stream
        err = getattr(lib, entry)(
            pk.o.data_ptr(), pk.d.data_ptr(), pk.tnear.data_ptr(),
            pk.tfar.data_ptr(), pk.count.data_ptr(), pk.shortlist.data_ptr(),
            pk.entry.data_ptr(), pk.count.shape[0], pk.shortlist.shape[1],
            *boxes, blocks.data_ptr(), c, b, pk.factor, skip, int(woop),
            *[x.data_ptr() for x in outs],
            *(() if staged is None else (staged.data_ptr(),)), stream)
    if err:
        raise RuntimeError(f"cluster_trace {kind}: launch failed: "
                           f"{lib.cluster_trace_error_string(err).decode()}")
    tracing.count("launch." + kind, 1)
    if skip:
        tracing.count("cull." + kind, 1)
    if staged is not None:
        tracing.count("phase2.staged", staged)
        tracing.count("phase2.closest_packets", staged.shape[0])


def _on_cuda(x) -> bool:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cluster_trace: unsupported device {x.device}")
    return x.device.type == "cuda"


def packet_keys(o, d, tnear, tfar, cmin, cmax):
    """Phase 1 before its sort, `shortlist_keys`' key (Rp, C) float32 and
    count (Rp,) int32, of packed rays o, d (Rp*P, 3), tnear, tfar (Rp*P,)
    against the (super)cluster boxes cmin, cmax (C, 3): K9 on CUDA
    tensors, one launch in the span `phase1.keys`, bit-identical to the
    plain version, which CPU tensors take."""
    if not _on_cuda(o):
        return shortlist_keys(o, d, tnear, tfar, cmin, cmax)
    n = o.shape[0]
    if n % P:
        raise ValueError(f"shortlist_keys: {n} rays are not whole packets "
                         f"of {P}")
    rp, c = n // P, cmin.shape[0]
    _check("shortlist_keys", o.device, {
        "o": (o, (n, 3), torch.float32), "d": (d, (n, 3), torch.float32),
        "tnear": (tnear, (n,), torch.float32),
        "tfar": (tfar, (n,), torch.float32),
        "cmin": (cmin, (c, 3), torch.float32),
        "cmax": (cmax, (c, 3), torch.float32)})
    key = torch.empty((rp, c), dtype=torch.float32, device=o.device)
    count = torch.empty((rp,), dtype=torch.int32, device=o.device)
    if not rp:
        return key, count
    lib = _lib()
    with tracing.span("phase1.keys"), torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = lib.cluster_shortlist_keys(
            o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(),
            rp, cmin.data_ptr(), cmax.data_ptr(), c, key.data_ptr(),
            count.data_ptr(), stream)
    if err:
        raise RuntimeError(f"shortlist_keys: launch failed: "
                           f"{lib.cluster_trace_error_string(err).decode()}")
    tracing.count("launch.shortlist_keys", 1)
    return key, count


def closest_packets(ctris, cmin, cmax, pk: Packets):
    """K5 on CUDA tensors, `trace_closest_ref` on CPU tensors, over packed
    rays -> (t, u, v, tri), each (Rp*P,)."""
    if not _on_cuda(pk.o):
        return trace_closest_ref(ctris, pk)
    n = pk.o.shape[0]
    outs = tuple(torch.empty((n,), dtype=torch.float32, device=pk.o.device)
                 for _ in range(3)) \
        + (torch.empty((n,), dtype=torch.int32, device=pk.o.device),)
    if n:
        _launch("trace_closest", ctris, pk, outs, cmin, cmax)
    return outs


def any_packets(ctris, cmin, cmax, pk: Packets):
    """K6 on CUDA tensors, `trace_any_ref` on CPU tensors -> (Rp*P,) bool."""
    if not _on_cuda(pk.o):
        return trace_any_ref(ctris, pk)
    occ = torch.empty((pk.o.shape[0],), dtype=torch.bool, device=pk.o.device)
    if pk.o.shape[0]:
        _launch("trace_any", ctris, pk, (occ,), cmin, cmax)
    return occ


def closest_packets_mxu(cwoop, pk: Packets):
    """K7 on CUDA tensors, `trace_closest_mxu_ref` on CPU tensors, over
    rays packed at factor 1 -> (t, u, v, tri), each (Rp*P,)."""
    if not _on_cuda(pk.o):
        return trace_closest_mxu_ref(cwoop, pk)
    n = pk.o.shape[0]
    outs = tuple(torch.empty((n,), dtype=torch.float32, device=pk.o.device)
                 for _ in range(3)) \
        + (torch.empty((n,), dtype=torch.int32, device=pk.o.device),)
    if n:
        _launch("trace_closest_mxu", cwoop, pk, outs)
    return outs


def any_packets_mxu(cwoop, cmin, cmax, pk: Packets):
    """K8 on CUDA tensors, `trace_any_mxu_ref` on CPU tensors -> (Rp*P,)
    bool. cmin, cmax (C, 3): the cluster AABBs, which K8 grows into its
    cull boxes (`woop_cull_boxes`)."""
    if not _on_cuda(pk.o):
        return trace_any_mxu_ref(cwoop, pk)
    occ = torch.empty((pk.o.shape[0],), dtype=torch.bool, device=pk.o.device)
    if pk.o.shape[0]:
        _launch("trace_any_mxu", cwoop, pk, (occ,), cmin, cmax)
    return occ


def _factor_and_woop(ctris, cwoop, factor: int):
    """The JAX package's selection (cluster_trace.py:1122-1127): factor 1
    picks `pick_factor(C)`; the Woop kernels run when Woop blocks are
    given, B is WOOP_BLOCK and the factor is 1 -> (factor, use_woop)."""
    if factor == 1:
        factor = pick_factor(ctris.shape[0])
    return factor, (cwoop is not None and ctris.shape[1] == WOOP_BLOCK
                    and factor == 1)


def trace_closest(ctris, cmin, cmax, o, d, tnear, tfar, cwoop=None,
                  factor: int = 1):
    """Closest hit of flat rays o, d (R, 3), tnear, tfar (R,) or () against
    the cluster blocks ctris (C, B, 9) with AABBs cmin, cmax (C, 3) ->
    (t, u, v, tri int32), each (R,); t = inf and tri = -1 on a miss.
    factor 1 picks `pick_factor(C)`; with Woop blocks cwoop (C, 4, 384)
    K7 runs where it applies (`_factor_and_woop`), else K5. Computed
    without a graph."""
    factor, woop = _factor_and_woop(ctris, cwoop, factor)
    with torch.no_grad():
        pk = pack(cmin, cmax, o, d, tnear, tfar, factor)
        out = closest_packets_mxu(cwoop, pk) if woop \
            else closest_packets(ctris, cmin, cmax, pk)
    return tuple(x[:pk.n_rays] for x in out)


def trace_any(ctris, cmin, cmax, o, d, tnear, tfar, cwoop=None,
              factor: int = 1):
    """Any hit (occlusion) of flat rays -> (R,) bool; K8 or K6 as
    `trace_closest` picks K7 or K5."""
    factor, woop = _factor_and_woop(ctris, cwoop, factor)
    with torch.no_grad():
        pk = pack(cmin, cmax, o, d, tnear, tfar, factor)
        occ = any_packets_mxu(cwoop, cmin, cmax, pk) if woop \
            else any_packets(ctris, cmin, cmax, pk)
    return occ[:pk.n_rays]


def supports(scene) -> bool:
    """Applicability: the scene has cluster blocks."""
    return scene.cluster_tris is not None
