"""BVH2 stack traversal (counterpart of `tpu_restir.accel.traverse`): the
classic per-ray walk of a binary BVH, a correctness oracle beside the
backends.

The JAX package vmaps a per-ray `while_loop`; here the rays of a flat
batch step together, each on its own stack, and a ray whose stack is
empty (or, for any hit, that is occluded) keeps its state, as the vmapped
loop keeps it, so every ray visits its nodes in the JAX order and keeps
the same winner. The loop's condition is read on the host, one sync a
step (`sync.bvh2`, `tracing.count`). The box test is the wide BVH's
(`accel.wide.slab`), with the exit rule that keeps a ray lying in a box's
max-face plane.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_restir_torch import tracing
from tpu_restir_torch.accel.wide import safe_inv, slab

_INF = float("inf")


@dataclasses.dataclass
class BVHArrays:
    node_min: torch.Tensor   # (M, 3)
    node_max: torch.Tensor   # (M, 3)
    left: torch.Tensor       # (M,) int32; < 0 on a leaf
    right: torch.Tensor      # (M,) int32
    start: torch.Tensor      # (M,) int32
    count: torch.Tensor      # (M,) int32
    order: torch.Tensor      # (N,) int32 primitive permutation
    max_depth: int = 64
    leaf_size: int = 4


def bvh_to_device(bvh, device, leaf_size: int = 4) -> BVHArrays:
    """A host BVH2 (`accel.bvh.BVH2`) -> BVHArrays on device."""
    def dev(a):
        return torch.tensor(a, device=device)

    return BVHArrays(node_min=dev(bvh.node_min), node_max=dev(bvh.node_max),
                     left=dev(bvh.left), right=dev(bvh.right),
                     start=dev(bvh.start), count=dev(bvh.count),
                     order=dev(bvh.order), max_depth=int(bvh.max_depth),
                     leaf_size=leaf_size)


def _traverse(o, d, tnear, tfar, bvh: BVHArrays, v0, e1, e2, any_hit: bool):
    """Flat rays (R, 3), tnear, tfar (R,) -> (t, u, v, tri int32)
    (traverse.py:66-113): pop a node; test its box against [tnear,
    min(tfar, best t)]; a leaf tests its triangles (through `order`),
    an internal node pushes left, then right (so right is popped
    first)."""
    from tpu_restir_torch.render.intersect import _mt

    r = o.shape[0]
    dev = o.device
    rows = torch.arange(r, device=dev)
    depth = bvh.max_depth + 2
    n_prims = v0.shape[0]
    inv, small = safe_inv(d)
    stack = torch.zeros((r, depth), dtype=torch.int32, device=dev)
    sp = torch.ones((r,), dtype=torch.int32, device=dev)
    bt = torch.full((r,), _INF, device=dev)
    bu = torch.zeros((r,), device=dev)
    bv = torch.zeros((r,), device=dev)
    btri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    while True:
        live = sp > 0
        if any_hit:
            live &= btri < 0
        tracing.count("sync.bvh2", 1)
        if not bool(live.any()):
            break
        spd = torch.where(live, sp - 1, sp)
        node = stack[rows, torch.clamp(spd, min=0).long()].long()
        tn_b, tf_b = slab(o, inv, small, bvh.node_min[node],
                          bvh.node_max[node])
        box_hit = ((tn_b <= tf_b) & (tf_b >= tnear)
                   & (tn_b <= torch.minimum(tfar, bt)) & live)
        lft = bvh.left[node]
        rgt = bvh.right[node]
        is_leaf = lft < 0
        for k in range(bvh.leaf_size):
            in_leaf = is_leaf & box_hit & (k < bvh.count[node])
            prim = bvh.order[torch.clamp(bvh.start[node] + k, 0,
                                         n_prims - 1).long()]
            pl = prim.long()
            t, u, v, ok = _mt(o, d, v0[pl], e1[pl], e2[pl])
            ok &= in_leaf & (t >= tnear) & (t <= tfar) & (t < bt)
            bt = torch.where(ok, t, bt)
            bu = torch.where(ok, u, bu)
            bv = torch.where(ok, v, bv)
            btri = torch.where(ok, prim, btri)
        push = ~is_leaf & box_hit
        at = torch.clamp(spd, min=0).long()
        stack[rows, at] = torch.where(push, lft, stack[rows, at])
        at1 = torch.clamp(spd + 1, max=depth - 1).long()
        stack[rows, at1] = torch.where(push, rgt, stack[rows, at1])
        sp = spd + torch.where(push, 2, 0).to(torch.int32)
    return bt, bu, bv, btri


def bvh_closest(bvh: BVHArrays, v0, e1, e2, o, d, tnear, tfar):
    """Closest hit of flat rays -> (t, u, v, tri int32); t = inf, tri =
    -1 on a miss. No graph is recorded."""
    with torch.no_grad():
        return _traverse(o, d, tnear, tfar, bvh, v0, e1, e2, any_hit=False)


def bvh_any(bvh: BVHArrays, v0, e1, e2, o, d, tnear, tfar):
    """Any hit (occlusion) of flat rays -> (R,) bool."""
    with torch.no_grad():
        btri = _traverse(o, d, tnear, tfar, bvh, v0, e1, e2,
                         any_hit=True)[3]
    return btri >= 0
