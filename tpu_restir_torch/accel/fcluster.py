"""Packet-cluster intersection, the 'fcluster' backend (counterpart of
`tpu_restir.accel.fcluster`, plain tensor code on either device).

  Phase 1, packet culling: rays are grouped into packets of p consecutive
  rays; each packet's interval hull (origin box, direction interval,
  [tnear, tfar] range, and the hulls of 8 swept slices of its segments)
  is tested conservatively against every cluster AABB (`_prep`).

  Phase 2, shortlist rounds: each packet takes its passing clusters in
  ascending index, k a round, gathers their triangle rows and runs the
  fused Moller-Trumbore test with a running minimum. Packets are sorted
  busiest first and run in shrinking prefixes with growing k
  (`_segment_sizes`), so a few grazing packets do not hold up the chunk;
  every passing cluster is tested, whatever k.

`_packet_bounds` and `_clamp_tfar_bbox` also serve phase 1 of the
clustered traversal K5-K8 (`kernels/cluster_trace.py`). Every function
keeps the JAX module's operation order, except the clamp's repaired exit
on clamped axes. Each round's loop condition is read on the host: one
sync a round (`sync.fcluster`, `tracing.count`).
"""

from __future__ import annotations

import torch

from tpu_restir_torch import tracing

_INF = float("inf")
_BIG = 3.0e38
_N_SLICES = 8    # swept sub-box count per packet
# most (ray, row) pairs a round's test materialises at once; the packets of
# a round are cut into groups of at most this many pairs, which changes no
# result (each packet's rays meet only its own rows)
_ROUND_PAIRS = 1 << 24


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


def _interval_pass(omin, omax, dmin, dmax, tnmin, tfmax, cmin, cmax):
    """Conservative packet-vs-cluster slab test (fcluster.py:91-143):
    packets (Rp, 3) interval bounds x clusters (C, 3) AABBs -> (Rp, C)
    bool, False only where no ray of the packet's hull can hit the cluster
    within [tnmin, tfmax]. A direction interval that spans zero (or comes
    within 1e-12 of it) leaves its axis unconstrained; otherwise the
    quotient bounds are the four corner products with the reciprocal
    interval."""
    rp = omin.shape[0]
    c = cmin.shape[0]
    dev = omin.device
    entry_lo = torch.full((rp, c), -_BIG, device=dev)
    exit_hi = torch.full((rp, c), _BIG, device=dev)
    for a in range(3):
        dlo = dmin[:, a:a + 1]
        dhi = dmax[:, a:a + 1]
        spans0 = (dlo <= 1e-12) & (dhi >= -1e-12)
        safe_lo = torch.where(spans0, 1.0, dlo)
        safe_hi = torch.where(spans0, 1.0, dhi)
        rlo = torch.minimum(1.0 / safe_lo, 1.0 / safe_hi)
        rhi = torch.maximum(1.0 / safe_lo, 1.0 / safe_hi)
        rlo = torch.clamp(rlo, -1e12, 1e12)
        rhi = torch.clamp(rhi, -1e12, 1e12)
        bounds = []
        for b in (cmin, cmax):
            blo_n = b[None, :, a] - omax[:, a:a + 1]
            bhi_n = b[None, :, a] - omin[:, a:a + 1]
            q1 = blo_n * rlo
            q2 = blo_n * rhi
            q3 = bhi_n * rlo
            q4 = bhi_n * rhi
            bounds.append((
                torch.minimum(torch.minimum(q1, q2), torch.minimum(q3, q4)),
                torch.maximum(torch.maximum(q1, q2), torch.maximum(q3, q4))))
        (t1lo, t1hi), (t2lo, t2hi) = bounds
        a_entry_lo = torch.where(spans0, -_BIG, torch.minimum(t1lo, t2lo))
        a_exit_hi = torch.where(spans0, _BIG, torch.maximum(t1hi, t2hi))
        entry_lo = torch.maximum(entry_lo, a_entry_lo)
        exit_hi = torch.minimum(exit_hi, a_exit_hi)
    return ((entry_lo <= exit_hi) & (exit_hi >= tnmin[:, None])
            & (entry_lo <= tfmax[:, None]))


def _mt_rows(o, d, v0, e1, e2, tnear, tfar):
    """Moller-Trumbore, packet-batched (fcluster.py:146-171): rays
    (Rp, P, 3) x gathered triangle rows (Rp, B, 3) -> t, u, v, ok, each
    (Rp, P, B), in the operation order of `render.intersect._mt_block`,
    so that a hit here is brute's hit bit for bit."""
    from tpu_restir_torch.render.intersect import _mt

    t, u, v, ok = _mt(o[:, :, None, :], d[:, :, None, :], v0[:, None],
                      e1[:, None], e2[:, None])
    ok &= (t >= tnear[..., None]) & (t <= tfar[..., None])
    return t, u, v, ok


def _round_select(passes, rank, done, k: int):
    """The next k unprocessed passing clusters of each packet (processed
    so far: done) -> (Rp, k) cluster indices (clamped) and a valid mask
    (fcluster.py:174-185). The k smallest keys in ascending order, as
    JAX's top_k of the negated keys gives them."""
    rp, c = passes.shape
    iota = torch.arange(c, device=passes.device).expand(rp, c)
    key = torch.where(passes & (rank >= done[:, None]), iota, c)
    sel = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return torch.clamp(sel, max=c - 1), sel < c


def _min_update_tri(carry, t, u, v, ok, cand_tri):
    """Fold (Rp, P, B) candidates into the (Rp, P) running minimum, the
    candidate triangle ids cand_tri (Rp, B) varying per packet
    (fcluster.py:188-204): the first candidate of least t, taken only
    where strictly closer."""
    bt, bu, bv, btri = carry
    tt = torch.where(ok, t, _INF)
    tmin = tt.amin(-1)
    jwin = torch.argmax((tt <= tmin[..., None]).to(torch.uint8), -1,
                        keepdim=True)
    mu = u.gather(-1, jwin)[..., 0]
    mv = v.gather(-1, jwin)[..., 0]
    mtri = cand_tri.gather(1, jwin[..., 0]).to(torch.int32)
    better = tmin < bt
    return (torch.where(better, tmin, bt), torch.where(better, mu, bu),
            torch.where(better, mv, bv), torch.where(better, mtri, btri))


def _prep(o, d, tnear, tfar, cmin, cmax, p: int):
    """Phase 1 (fcluster.py:207-220): packet bounds, the pass matrix
    (Rp, C), each passing cluster's rank among its packet's, and the
    passing count per packet."""
    (omin, omax, dmin, dmax, tn, tf,
     bounded, emin, emax) = _packet_bounds(o, d, tnear, tfar, p)
    passes = _interval_pass(omin, omax, dmin, dmax, tn, tf, cmin, cmax)
    box_ok = ((emin[:, None, :, :] <= cmax[None, :, None, :])
              & (emax[:, None, :, :] >= cmin[None, :, None, :])
              ).all(-1).any(-1)
    passes &= box_ok | ~bounded[:, None]
    pi = passes.to(torch.int32)
    rank = torch.cumsum(pi, 1, dtype=torch.int32) - pi
    n_pass = rank[:, -1] + pi[:, -1]
    return passes, rank, n_pass


def _bin_rays(o, d, lo, hi):
    """Stable binning permutation of a ray chunk (fcluster.py:241-259):
    origin cell (3 bits an axis over the scene box), then quantised
    direction (2 bits an axis); rays with a non-finite component go last.
    -> (order, inverse)."""
    ext = torch.clamp(hi - lo, min=1e-9)

    def cell(x, top):
        # clamped in float first: a conversion of inf is undefined in
        # PyTorch, where XLA saturates; NaN still ends in cell 0 as in XLA
        return torch.clamp(torch.clamp(x, 0.0, float(top)).to(torch.int32),
                           0, top)

    oc = cell((o - lo[None, :]) / ext[None, :] * 8.0, 7)
    dq = cell((d * 0.5 + 0.5) * 4.0, 3)
    key = ((((oc[:, 0] << 3) | oc[:, 1]) << 3 | oc[:, 2]) << 6) \
        | (dq[:, 0] << 4) | (dq[:, 1] << 2) | dq[:, 2]
    key = torch.where((torch.isfinite(o) & torch.isfinite(d)).all(-1), key,
                      1 << 16)
    order = torch.argsort(key, stable=True)
    return order, torch.argsort(order)


def _segment_sizes(rp: int, n_segments: int = 3, shrink: int = 8):
    """Prefix sizes of the cohort schedule, [Rp, Rp/8, Rp/64]
    (fcluster.py:262-279): segment i runs rounds over the busiest S_i
    packets until every packet outside the next prefix is done."""
    sizes = []
    s = rp
    for _ in range(n_segments):
        sizes.append(max(s, 1))
        s //= shrink
        if sizes[-1] == 1:
            break
    return sizes


def _round_step(passes, rank, op, dp, tn, tf, v0b, e1b, e2b, kk: int,
                done, fold):
    """One shortlist round over a packet prefix (fcluster.py:282-296):
    select the next kk unprocessed clusters of each packet, gather their
    triangle rows and run the fused test; fold(rows, t, u, v, ok, cand)
    takes each group of packets' candidates."""
    rp, p = op.shape[0], op.shape[1]
    block = v0b.shape[1]
    sel, valid = _round_select(passes, rank, done, kk)
    loc = torch.arange(block, device=op.device)
    cand = (sel[:, :, None] * block + loc).reshape(rp, kk * block)
    g = max(1, _ROUND_PAIRS // (p * kk * block))
    for s in range(0, rp, g):
        e = min(rp, s + g)
        sl = sel[s:e]
        t, u, v, ok = _mt_rows(
            op[s:e], dp[s:e], v0b[sl].reshape(e - s, kk * block, 3),
            e1b[sl].reshape(e - s, kk * block, 3),
            e2b[sl].reshape(e - s, kk * block, 3), tn[s:e], tf[s:e])
        ok &= valid[s:e].repeat_interleave(block, 1)[:, None, :]
        fold(slice(s, e), t, u, v, ok, cand[s:e])


def _chunk_prep(o, d, tnear, tfar, cmin, cmax, p: int, bin_rays: bool):
    """The common start of both queries (fcluster.py:305-330): the scene
    box clamp, binning, phase 1 and the cohort sort -> (rays in packets,
    sorted busiest first, and what undoes both permutations)."""
    lo = cmin.amin(0)
    hi = cmax.amax(0)
    tfar = _clamp_tfar_bbox(o, d, tnear, tfar, lo, hi)
    binv = None
    if bin_rays:
        border, binv = _bin_rays(o, d, lo, hi)
        o, d, tnear, tfar = o[border], d[border], tnear[border], tfar[border]
    passes, rank, n_pass = _prep(o, d, tnear, tfar, cmin, cmax, p)
    # busiest packets first. The order among equal counts cannot change a
    # result: a packet's rounds take its clusters in ascending index, a
    # later round replaces a hit only where strictly closer, so ties go to
    # the lowest triangle id whichever way packets are ordered.
    order = torch.argsort(-n_pass, stable=True)
    rp = n_pass.shape[0]
    return (passes[order], rank[order], n_pass[order],
            o.reshape(rp, p, 3)[order], d.reshape(rp, p, 3)[order],
            tnear.reshape(rp, p)[order], tfar.reshape(rp, p)[order],
            torch.argsort(order), binv)


def _unpermute(x, inv, binv):
    x = x[inv].reshape(-1)
    return x if binv is None else x[binv]


def _pad_packets(o, d, tnear, tfar, p: int):
    """Flat rays padded with dead rays (o = d = 0, tnear 0, tfar -1, as
    `render.intersect._run_chunked` pads a chunk) to a multiple of p.
    The JAX package's reshape to (R / p, p, 3) refuses any other count;
    a dead ray stays out of every packet hull, so no result changes."""
    r = o.shape[0]
    tnear = tnear.expand(r)
    tfar = tfar.expand(r)
    pad = -r % p
    if not pad:
        return o, d, tnear, tfar
    z3 = o.new_zeros((pad, 3))
    return (torch.cat([o, z3]), torch.cat([d, z3]),
            torch.cat([tnear, tnear.new_zeros((pad,))]),
            torch.cat([tfar, tfar.new_full((pad,), -1.0)]))


def fcluster_closest(o, d, tnear, tfar, v0b, e1b, e2b, cmin, cmax,
                     p: int = 256, k: int = 8, bin_rays: bool = False):
    """Closest hit over one ray chunk (fcluster.py:299-365). o, d (R, 3),
    tnear, tfar (R,) or (); R need not be a multiple of p
    (`_pad_packets`). v0b, e1b, e2b: (C, B, 3) triangle rows blocked per
    cluster (`render.intersect._pad_tris`). -> (t, u, v, tri int32), each
    (R,); t = inf and tri = -1 on a miss; triangle ids are cluster * B +
    row. No graph is recorded."""
    r = o.shape[0]
    c = cmin.shape[0]
    kk = min(k, c)
    (passes, rank, n_pass, op, dp, tn, tf, inv, binv) = _chunk_prep(
        *_pad_packets(o, d, tnear, tfar, p), cmin, cmax, p, bin_rays)
    rp = op.shape[0]
    dev = o.device
    carry = [torch.full((rp, p), _INF, device=dev),
             torch.zeros((rp, p), device=dev),
             torch.zeros((rp, p), device=dev),
             torch.full((rp, p), -1, dtype=torch.int32, device=dev)]
    done = torch.zeros((rp,), dtype=torch.int32, device=dev)
    sizes = _segment_sizes(rp)
    for i, s in enumerate(sizes):
        kseg = min(kk * 4 ** i, c)
        s_next = sizes[i + 1] if i + 1 < len(sizes) else 0

        def fold(rows, t, u, v, ok, cand, s=s):
            part = [x[:s][rows] for x in carry]
            for x, y in zip(carry, _min_update_tri(part, t, u, v, ok, cand)):
                x[:s][rows] = y

        while _more(n_pass[s_next:s], done[s_next:s]):
            _round_step(passes[:s], rank[:s], op[:s], dp[:s], tn[:s], tf[:s],
                        v0b, e1b, e2b, kseg, done[:s], fold)
            done[:s] += kseg
    return tuple(_unpermute(x, inv, binv)[:r] for x in carry)


def fcluster_any(o, d, tnear, tfar, v0b, e1b, e2b, cmin, cmax,
                 p: int = 256, k: int = 8, bin_rays: bool = False):
    """Any hit (occlusion) over one ray chunk -> (R,) bool
    (fcluster.py:368-430); a packet whose rays are all occluded is done."""
    r = o.shape[0]
    c = cmin.shape[0]
    kk = min(k, c)
    (passes, rank, n_pass, op, dp, tn, tf, inv, binv) = _chunk_prep(
        *_pad_packets(o, d, tnear, tfar, p), cmin, cmax, p, bin_rays)
    rp = op.shape[0]
    occ = torch.zeros((rp, p), dtype=torch.bool, device=o.device)
    done = torch.zeros((rp,), dtype=torch.int32, device=o.device)
    sizes = _segment_sizes(rp)
    for i, s in enumerate(sizes):
        kseg = min(kk * 4 ** i, c)
        s_next = sizes[i + 1] if i + 1 < len(sizes) else 0

        def fold(rows, _t, _u, _v, ok, _cand, s=s):
            occ[:s][rows] |= ok.any(-1)

        while _more(n_pass[s_next:s], done[s_next:s]):
            _round_step(passes[:s], rank[:s], op[:s], dp[:s], tn[:s], tf[:s],
                        v0b, e1b, e2b, kseg, done[:s], fold)
            done[:s] = torch.maximum(
                done[:s] + kseg,
                torch.where(occ[:s].all(-1), n_pass[:s], 0))
    return _unpermute(occ, inv, binv)[:r]


def _more(n_pass, done) -> bool:
    """The round loop's condition, read on the host."""
    tracing.count("sync.fcluster", 1)
    return bool((n_pass > done).any())
