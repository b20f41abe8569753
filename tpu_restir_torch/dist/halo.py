"""Halo exchange of row-sharded screen buffers (counterpart of
`tpu_restir.dist.halo`).

Spatial reuse reads neighbours within a bounded pixel radius and temporal
reuse reads reprojected pixels; with rows sharded over ranks those taps
cross shard borders. Each rank receives `halo` border rows from both row
neighbours and gathers from the extended buffer. Where the halo is taller
than a shard, every rank gathers all rows instead (`gather_rows`).

Both are autograd functions, since the exchanged G-buffer and reservoirs
depend on the material parameters: the backward of `extend_rows` sends
the cotangents of the received rows back to their owners, who add them
to their border rows (what JAX's AD of ppermute does); the backward of
`gather_rows` sums the cotangent over the ranks and keeps the rank's own
rows.
"""

from __future__ import annotations

import math

import torch

from tpu_restir_torch.dist import mesh as mesh_mod


def halo_width(spatial_radius: float) -> int:
    """Rows of halo that spatial reuse needs: disk offsets are bounded by
    sqrt(radius) (the reference's r = sqrt(U(0, R)) quirk)."""
    return int(math.ceil(math.sqrt(max(spatial_radius, 0.0)))) + 1


def local_row(gy, ext_row0: int, ext_h: int):
    """Clamped GLOBAL rows -> rows of an extended buffer that starts at
    global row ext_row0 (0 for one device or all-gathered rows, row0 -
    halo for a halo-extended shard)."""
    return torch.clamp(gy - ext_row0, 0, ext_h - 1)


def _pack(tensors, rows):
    """The rows of each (n, ...) tensor as bytes, side by side: (r, B)
    uint8."""
    return torch.cat([t[rows].contiguous().view(torch.uint8)
                      .reshape(t[rows].shape[0], -1) for t in tensors], 1)


def _unpack(buf, like):
    """Inverse of _pack: (r, B) uint8 -> tensors shaped (r,) + t.shape[1:]
    with the dtypes of `like`."""
    out, at = [], 0
    for t in like:
        nb = t[:1].numel() * t.element_size()
        part = buf[:, at:at + nb].contiguous().view(t.dtype)
        out.append(part.reshape((buf.shape[0],) + tuple(t.shape[1:])))
        at += nb
    return out


class _ExtendRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, halo, *tensors):
        ctx.mesh, ctx.halo = mesh, halo
        ctx.floats = [t.is_floating_point() for t in tensors]
        n = tensors[0].shape[0]
        above, below = mesh_mod.exchange(
            mesh, _pack(tensors, slice(0, halo)),
            _pack(tensors, slice(n - halo, n)))
        zeros = [t.new_zeros((halo,) + tuple(t.shape[1:])) for t in tensors]
        above = zeros if above is None else _unpack(above, tensors)
        below = zeros if below is None else _unpack(below, tensors)
        out = tuple(torch.cat([a, t, b]) for a, t, b
                    in zip(above, tensors, below))
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.floats)
                                      if not f])
        return out

    @staticmethod
    def backward(ctx, *grads):
        halo, mesh = ctx.halo, ctx.mesh
        gs = [g for g, f in zip(grads, ctx.floats) if f]
        # the first halo rows are rank - 1's last rows, the last halo rows
        # rank + 1's first rows: each goes back to its owner, and the
        # cotangents of this rank's border rows come back from its
        # neighbours
        from_prev, from_next = mesh_mod.exchange(
            mesh, _pack(gs, slice(0, halo)), _pack(gs, slice(-halo, None)))
        own = [g[halo:-halo].clone() for g in gs]
        n = own[0].shape[0]
        if from_prev is not None:   # rank - 1 read this rank's first rows
            for o, c in zip(own, _unpack(from_prev, gs)):
                o[:halo] += c
        if from_next is not None:   # rank + 1 read its last rows
            for o, c in zip(own, _unpack(from_next, gs)):
                o[n - halo:] += c
        it = iter(own)
        return (None, None) + tuple(next(it) if f else None
                                    for f in ctx.floats)


def extend_rows(tensors, halo: int, mesh):
    """Each (rows, W, ...) tensor with `halo` rows of both row neighbours
    above and below it: one message each way for all tensors. A global
    edge gets zero rows, never addressed, because global rows are clamped
    to the screen before `local_row` maps them. A list in, a list out."""
    if halo == 0 or mesh.size == 1:
        return list(tensors)
    if halo > tensors[0].shape[0]:
        raise ValueError(f"halo {halo} is taller than the shard "
                         f"({tensors[0].shape[0]} rows): use gather_rows")
    return list(_ExtendRows.apply(mesh, halo, *tensors))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        ctx.floats = [t.is_floating_point() for t in tensors]
        ctx.n = tensors[0].shape[0]
        full = mesh_mod.all_gather(mesh, _pack(tensors, slice(None)))
        out = tuple(_unpack(full, tensors))
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.floats)
                                      if not f])
        return out

    @staticmethod
    def backward(ctx, *grads):
        mesh, n = ctx.mesh, ctx.n
        gs = [g for g, f in zip(grads, ctx.floats) if f]
        rows = gs[0].shape[0]
        flat = mesh_mod.all_reduce(
            mesh, torch.cat([g.reshape(rows, -1) for g in gs], 1))
        mine = flat[mesh.rank * n:(mesh.rank + 1) * n]
        own, at = [], 0
        for g in gs:
            k = g[:1].numel()
            own.append(mine[:, at:at + k].reshape((n,) + tuple(g.shape[1:]))
                       .to(g.dtype))
            at += k
        it = iter(own)
        return (None,) + tuple(next(it) if f else None for f in ctx.floats)


def gather_rows(tensors, mesh):
    """The all-gather fallback for a halo taller than the shard: each
    (rows, W, ...) tensor -> all rows of the screen, on every rank."""
    if mesh.size == 1:
        return list(tensors)
    return list(_GatherRows.apply(mesh, *tensors))
