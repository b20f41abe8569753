"""Wide (8-ary) BVH: the collapse of a BVH2 and its lockstep traversal, the
'bvh' backend (counterpart of `tpu_restir.accel.wide`).

A wide node tests its 8 children with one (R, 8) slab test; each ray keeps
a stack of (node, children still to visit) pairs, one entry a level, and
re-tests a node's boxes against its current best t when it comes back to
it. Triangles are stored leaf-contiguous (a clustered scene is permuted
into the BVH2's leaf order), so a leaf names its triangles by start and
count.

The traversal runs all rays of a chunk in lockstep, as the JAX package's
`while_loop` does; its condition is read on the host, one sync a step
(`sync.bvh8`, `tracing.count`). The child test gives a clamped direction
component the exit rule of the clustered kernels (`slab_exit`): the JAX
package's test culls a box whose max-face plane the ray lies in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_restir_torch import tracing

_INF = float("inf")

# a slot's meta: 0 empty, > 0 the internal child's node id, < 0 a leaf
# with enc = -(meta + 1), start = enc >> 5, count = enc & 31
_CNT_BITS = 5
_CNT_MASK = (1 << _CNT_BITS) - 1


@dataclasses.dataclass
class BVH8Arrays:
    """Flat tensors on one device; node i's children are boxes[i] and
    meta[i]."""

    boxes: torch.Tensor    # (M, 8, 6) float32 child min | max (empty: +-inf)
    meta: torch.Tensor     # (M, 8) int32, encoded as above
    max_depth: int = 24
    max_leaf: int = 4


@dataclasses.dataclass
class BVH8Host:
    boxes: np.ndarray
    meta: np.ndarray
    order: np.ndarray      # (N,) primitive permutation (leaf-contiguous)
    max_depth: int
    max_leaf: int

    def to_device(self, device) -> BVH8Arrays:
        return BVH8Arrays(boxes=torch.tensor(self.boxes, device=device),
                          meta=torch.tensor(self.meta, device=device),
                          max_depth=int(self.max_depth),
                          max_leaf=int(self.max_leaf))


def collapse_bvh8(bvh, branching: int = 8) -> BVH8Host:
    """Collapse a BVH2 (`accel.bvh.BVH2`) into an 8-ary BVH
    (wide.py:68-120): each wide node splits its largest-area internal
    BVH2 slot until `branching` slots are filled or only leaves remain.
    Leaf slots keep the BVH2 leaf ranges, contiguous in bvh.order."""
    nmin, nmax = bvh.node_min, bvh.node_max
    left, right = bvh.left, bvh.right
    start, count = bvh.start, bvh.count

    def area(i: int) -> float:
        e = nmax[i] - nmin[i]
        return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    boxes = [np.zeros((8, 6), np.float32)]
    meta = [np.zeros(8, np.int32)]
    max_leaf = 1
    work = [(0, _expand(0, left, right, area, branching), 1)]
    max_depth = 1
    while work:
        node_id, slots, depth = work.pop()
        max_depth = max(max_depth, depth)
        b = np.zeros((8, 6), np.float32)
        b[:, 0:3] = np.inf
        b[:, 3:6] = -np.inf
        m = np.zeros(8, np.int32)
        for s, n2 in enumerate(slots):
            b[s, 0:3] = nmin[n2]
            b[s, 3:6] = nmax[n2]
            if left[n2] < 0:   # BVH2 leaf
                c = int(count[n2])
                if c > _CNT_MASK:
                    raise ValueError(f"collapse_bvh8: a leaf of {c} "
                                     f"primitives exceeds {_CNT_MASK}")
                max_leaf = max(max_leaf, c)
                m[s] = -((int(start[n2]) << _CNT_BITS) | c) - 1
            else:
                child_id = len(boxes)
                boxes.append(np.zeros((8, 6), np.float32))
                meta.append(np.zeros(8, np.int32))
                m[s] = child_id
                work.append((child_id,
                             _expand(n2, left, right, area, branching),
                             depth + 1))
        boxes[node_id] = b
        meta[node_id] = m
    return BVH8Host(boxes=np.stack(boxes), meta=np.stack(meta),
                    order=np.asarray(bvh.order, np.int32),
                    max_depth=max_depth, max_leaf=max_leaf)


def _expand(root: int, left, right, area, branching: int):
    """Slot set of the wide node rooted at BVH2 node `root`
    (wide.py:123-141)."""
    if left[root] < 0:
        return [root]
    slots = [int(left[root]), int(right[root])]
    while len(slots) < branching:
        best = -1
        best_a = -1.0
        for i, n2 in enumerate(slots):
            if left[n2] >= 0:
                a = area(n2)
                if a > best_a:
                    best_a = a
                    best = i
        if best < 0:
            break
        n2 = slots.pop(best)
        slots.extend([int(left[n2]), int(right[n2])])
    return slots


def safe_inv(d):
    """(reciprocal direction, clamped mask): components of magnitude at
    most 1e-20 become +-1e20 with their sign, as in the JAX package."""
    small = torch.abs(d) <= 1e-20
    d_safe = torch.where(small, torch.where(d >= 0.0, 1e-20, -1e-20), d)
    return 1.0 / d_safe, small


def slab(o, inv, small, bmin, bmax):
    """Entry and exit distances of rays against boxes, all broadcast
    (..., 3) -> (...), in the JAX package's operation order. On a clamped
    axis (`safe_inv`) the exit is +inf unless the ray lies beyond the slab
    (both plane distances negative), the rule of `slab_exit` in
    csrc/cluster_trace.cu: the clamp alone puts a ray lying in a box's
    max-face plane out of the box at t = 0, although it can hit the
    triangle edges in that plane. Other rays keep JAX's exit bit for
    bit."""
    t1 = (bmin - o) * inv
    t2 = (bmax - o) * inv
    t_hi = torch.maximum(t1, t2)
    return (torch.minimum(t1, t2).amax(-1),
            torch.where(small & (t_hi >= 0.0), _INF, t_hi).amin(-1))


def _traverse8(o, d, tnear, tfar, bvh: BVH8Arrays, v0, e1, e2,
               any_hit: bool):
    """Lockstep traversal of a flat ray chunk (R, 3) (wide.py:161-247).

    Each step, every live ray reads its top-of-stack node, slab-tests the
    8 children against (its remaining mask, its current best t), takes
    the nearest surviving child (a leaf: its triangles tested inline; an
    internal node: pushed) and clears that child's bit; a ray whose node
    has no surviving child pops. Masked-off stack writes go to a junk
    slot. -> (t, u, v, tri int32)."""
    from tpu_restir_torch.render.intersect import _mt

    r = o.shape[0]
    dev = o.device
    rows = torch.arange(r, device=dev)
    depth = bvh.max_depth + 2
    n_prims = v0.shape[0]
    inv, small = safe_inv(d)
    bits = 1 << torch.arange(8, dtype=torch.int32, device=dev)

    snode = torch.zeros((r, depth + 1), dtype=torch.int32, device=dev)
    smask = torch.zeros((r, depth + 1), dtype=torch.int32, device=dev)
    smask[:, 0] = 0xFF
    sp = torch.ones((r,), dtype=torch.int32, device=dev)
    bt = torch.full((r,), _INF, device=dev)
    bu = torch.zeros((r,), device=dev)
    bv = torch.zeros((r,), device=dev)
    btri = torch.full((r,), -1, dtype=torch.int32, device=dev)

    while True:
        live = sp > 0
        if any_hit:
            live &= btri < 0
        tracing.count("sync.bvh8", 1)
        if not bool(live.any()):
            break
        top = torch.clamp(sp - 1, min=0).long()
        node = snode[rows, top].long()
        mask = smask[rows, top]
        nb = bvh.boxes[node]                       # (R, 8, 6)
        nm = bvh.meta[node]                        # (R, 8)
        tn_c, tf_c = slab(o[:, None, :], inv[:, None, :],
                          small[:, None, :], nb[..., 0:3], nb[..., 3:6])
        lim = tfar if any_hit else torch.minimum(tfar, bt)
        hit = ((tn_c <= tf_c) & (tf_c >= tnear[:, None])
               & (tn_c <= lim[:, None]) & ((mask[:, None] & bits) != 0)
               & (nm != 0) & live[:, None])
        entry = torch.where(hit, tn_c, _INF)
        cbest = torch.argmin(entry, dim=-1)
        found = hit.any(-1)

        # the reduced mask goes back to the top (the junk slot on a pop)
        newmask = mask & ~(1 << cbest.to(torch.int32))
        wb = torch.where(found & live, top, depth)
        smask[rows, wb] = torch.where(found, newmask, 0)
        sp1 = torch.where(live & ~found, sp - 1, sp)

        cmeta = nm.gather(1, cbest[:, None])[:, 0]
        is_int = found & (cmeta > 0)
        is_leaf = found & (cmeta < 0)
        enc = -cmeta - 1
        pstart = enc >> _CNT_BITS
        pcnt = enc & _CNT_MASK
        for k in range(bvh.max_leaf):
            pok = is_leaf & (k < pcnt)
            prim = torch.clamp(pstart + k, 0, n_prims - 1)
            pl = prim.long()
            t, u, v, ok = _mt(o, d, v0[pl], e1[pl], e2[pl])
            ok &= pok & (t >= tnear) & (t <= tfar) & (t < bt)
            bt = torch.where(ok, t, bt)
            bu = torch.where(ok, u, bu)
            bv = torch.where(ok, v, bv)
            btri = torch.where(ok, prim, btri)

        # push the internal child (the junk slot when not pushing)
        pidx = torch.where(is_int, sp1, depth).long()
        snode[rows, pidx] = torch.where(is_int, cmeta, 0)
        smask[rows, pidx] = torch.where(is_int, 0xFF, 0).to(torch.int32)
        sp = torch.where(is_int, sp1 + 1, sp1)
    return bt, bu, bv, btri


def bvh8_closest(bvh: BVH8Arrays, v0, e1, e2, o, d, tnear, tfar):
    """Closest hit of flat rays -> (t, u, v, tri int32); t = inf, tri =
    -1 on a miss. No graph is recorded."""
    with torch.no_grad():
        return _traverse8(o, d, tnear, tfar, bvh, v0, e1, e2, any_hit=False)


def bvh8_any(bvh: BVH8Arrays, v0, e1, e2, o, d, tnear, tfar):
    """Any hit (occlusion) of flat rays -> (R,) bool."""
    with torch.no_grad():
        btri = _traverse8(o, d, tnear, tfar, bvh, v0, e1, e2,
                          any_hit=True)[3]
    return btri >= 0
