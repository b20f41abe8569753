"""Packet summaries for phase 1 of the clustered traversal: the two helpers
of `tpu_restir.accel.fcluster` that `kernels/cluster_trace.py` calls
(`_packet_bounds`, fcluster.py:48-88, and `_clamp_tfar_bbox`, :223-238),
in the same operation order (the clamp with a repaired exit on clamped
axes). The rest of that module (the XLA 'fcluster' backend) is not
ported (ROADMAP item 13)."""

from __future__ import annotations

import torch

_INF = float("inf")
_N_SLICES = 8    # swept sub-box count per packet


def _packet_bounds(o, d, tnear, tfar, p: int):
    """(R, 3) rays -> per-packet interval summaries; R must be Rp * p.

    Dead rays (tfar < tnear: padding, degenerate shadow segments) and rays
    with a non-finite origin or direction stay out of the hull, so one bad
    ray can neither blow a packet's interval open nor NaN-poison it (which
    would cull the whole packet). Returns omin, omax, dmin, dmax (Rp, 3),
    tn, tf (Rp,), bounded (Rp,) bool, and the swept sub-box hulls emin,
    emax (Rp, 8, 3): each live ray's [tnear, tfar] span cut into 8 equal
    t-fractions, the packet hull of each slice."""
    rp = o.shape[0] // p
    op = o.reshape(rp, p, 3)
    dp = d.reshape(rp, p, 3)
    live = ((tfar >= tnear).reshape(rp, p)
            & torch.isfinite(op).all(-1)
            & torch.isfinite(dp).all(-1))[..., None]
    omin = torch.where(live, op, _INF).amin(1)
    omax = torch.where(live, op, -_INF).amax(1)
    dmin = torch.where(live, dp, _INF).amin(1)
    dmax = torch.where(live, dp, -_INF).amax(1)
    live1 = live[..., 0]
    tn = torch.where(live1, tnear.reshape(rp, p), _INF).amin(1)
    tf = torch.where(live1, tfar.reshape(rp, p), -_INF).amax(1)
    tnp = tnear.reshape(rp, p, 1)
    tfp = tfar.reshape(rp, p, 1)
    fracs = torch.linspace(0.0, 1.0, _N_SLICES + 1, device=o.device)
    pts = op[:, :, None, :] + dp[:, :, None, :] * (
        tnp + (tfp - tnp) * fracs[None, None, :])[..., None]  # (Rp,P,S+1,3)
    live4 = live[:, :, None, :]
    pmin = torch.where(live4, pts, _INF).amin(1)               # (Rp, S+1, 3)
    pmax = torch.where(live4, pts, -_INF).amax(1)
    emin = torch.minimum(pmin[:, :-1], pmin[:, 1:])            # (Rp, S, 3)
    emax = torch.maximum(pmax[:, :-1], pmax[:, 1:])
    bounded = torch.where(live1, torch.isfinite(tfar).reshape(rp, p),
                          True).all(1)
    return omin, omax, dmin, dmax, tn, tf, bounded, emin, emax


def _clamp_tfar_bbox(o, d, tnear, tfar, lo, hi):
    """Clamp tfar to the exit of the scene's bounding box (nothing lies
    beyond it), so every ray becomes a bounded segment; rays that miss the
    box (sky) die up front (tfar = tnear - 1).

    A direction component of magnitude at most 1e-20 is clamped to +-1e20
    in the reciprocal. On such an axis the ray does not leave the slab
    unless it lies beyond it (both plane distances negative): the clamp
    alone would put a ray lying in the plane of the box's max face out of
    the box at t = 0 and kill it, although it hits the triangle edges in
    that plane. This departs from the JAX package's `_clamp_tfar_bbox`,
    which has that fault (tests/test_torch_clamp.py), with the exit rule
    of `slab_exit` in csrc/cluster_trace.cu; every other ray (a NaN
    component included) keeps the JAX package's tfar bit for bit."""
    small = torch.abs(d) <= 1e-20
    d_safe = torch.where(torch.abs(d) > 1e-20, d,
                         torch.where(d >= 0.0, 1e-20, -1e-20))
    inv = 1.0 / d_safe
    t1 = (lo[None, :] - o) * inv
    t2 = (hi[None, :] - o) * inv
    ten = torch.minimum(t1, t2).amax(-1)
    t_hi = torch.maximum(t1, t2)
    tex = torch.where(small & (t_hi >= 0.0), _INF, t_hi).amin(-1)
    # f32 slack so that the clamp cannot shave a true boundary hit
    tex = tex * (1.0 + 1e-5) + 1e-5
    alive = (ten <= tex) & (tex >= tnear)
    return torch.where(alive, torch.minimum(tfar, tex), tnear - 1.0)
