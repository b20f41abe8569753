"""The reference's ray-scene intersection: plain tensor code with no
kernel, no packet and no BVH of the program.

Small scenes (at most FUSED_MAX triangles) test every ray against every
triangle by the Woop affine test; larger ones by the Moller-Trumbore test,
on the triangles of the clusters whose boxes each ray itself crosses
(clusters of CLUSTER triangles in the order of their centroids' Morton
codes, and boxes of GROUP consecutive clusters over them, built by
`scene.scene.build_ref_scene`), nearest boxes first. Both tests keep the
operation order of the program's plain versions, so a hit's t, u and v
are the same floats. The winner of a closest-hit query is the hit of
least t, ties to the lower triangle index of the scene as given.
A closest hit is differentiable in the ray origins and directions by
the winning triangle's Woop test evaluated again with autograd (the
winner is data); an occlusion query is a detached bool.
"""

from __future__ import annotations

import dataclasses

import torch

from perfbench.refrender import mathx

FUSED_MAX = 512     # the most triangles of a scene tested exhaustively
CLUSTER = 64        # triangles of one reference cluster
GROUP = 16          # clusters under one box of the first box test
_INF = float("inf")
_BARY_EPS = 1e-5
_CHUNK = 1 << 14          # rays per exhaustive broadcast
_BOX_ELEMS = 1 << 26      # (ray, cluster) pairs per box test
_PAIR_CHUNK = 1 << 17     # (ray, cluster) pairs per triangle test
_NEAR = 4                 # boxes a ray tests first, nearest entry first


@dataclasses.dataclass
class Hit:
    t: torch.Tensor     # (...,) distance along the ray (0 on a miss)
    u: torch.Tensor     # (...,) barycentric (vertex 1 weight)
    v: torch.Tensor     # (...,) barycentric (vertex 2 weight)
    tri: torch.Tensor   # (...,) int32 triangle index (-1 on a miss)
    hit: torch.Tensor   # (...,) bool


@dataclasses.dataclass
class HitInfo:
    """Interpolated hit payload (reference pg/HitInfo.h:4-23)."""

    did_hit: torch.Tensor
    point: torch.Tensor
    normal: torch.Tensor
    uv: torch.Tensor
    tangent: torch.Tensor
    from_inside: torch.Tensor
    dst: torch.Tensor
    tri: torch.Tensor
    mat_id: torch.Tensor


def woop_tuvok(o, d, tn, tf, w):
    """(t, u, v, ok), each (R, T), for rays (R, 3) against Woop rows
    (T, 12): ((o_x w0 + o_y w1) + o_z w2) + w3, t = -ow / dw."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]

    def aff(c):
        return ox * w[:, 4 * c] + oy * w[:, 4 * c + 1] \
            + oz * w[:, 4 * c + 2] + w[:, 4 * c + 3]

    def lin(c):
        return dx * w[:, 4 * c] + dy * w[:, 4 * c + 1] + dz * w[:, 4 * c + 2]

    ow, dw = aff(2), lin(2)
    ok_dw = torch.abs(dw) > 1e-18
    t = torch.where(ok_dw, -ow / torch.where(ok_dw, dw, 1.0), torch.inf)
    u = aff(0) + t * lin(0)
    v = aff(1) + t * lin(1)
    ok = ((u >= -_BARY_EPS) & (v >= -_BARY_EPS)
          & (u + v <= 1.0 + _BARY_EPS) & torch.isfinite(t)
          & (t >= tn[:, None]) & (t <= tf[:, None]))
    return t, u, v, ok


def mt_tuvok(tr, o, d, tn, tf):
    """Moller-Trumbore of triangle rows tr (A, B, 9: v0, e1, e2) against
    one ray each (A, 3) -> t, u, v, ok of shape (A, B)."""
    v0x, v0y, v0z = tr[..., 0], tr[..., 1], tr[..., 2]
    e1x, e1y, e1z = tr[..., 3], tr[..., 4], tr[..., 5]
    e2x, e2y, e2z = tr[..., 6], tr[..., 7], tr[..., 8]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
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
    ok &= (t >= tn[:, None]) & (t <= tf[:, None])
    return t, u, v, ok


def closest_woop(w, o, d, tn, tf):
    """Every ray against every Woop row -> (t, u, v, tri int32); the
    first triangle of least t; t = inf and tri = -1 on a miss."""
    n = o.shape[0]
    t_out = torch.full((n,), _INF, device=o.device)
    u_out = torch.zeros((n,), device=o.device)
    v_out = torch.zeros((n,), device=o.device)
    tri_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for s in range(0, n, _CHUNK):
        e = min(n, s + _CHUNK)
        t, u, v, ok = woop_tuvok(o[s:e], d[s:e], tn[s:e], tf[s:e], w)
        tt = torch.where(ok, t, _INF)
        j = torch.argmin(tt, dim=1, keepdim=True)
        hit = torch.any(ok, dim=1)
        t_out[s:e] = torch.where(hit, tt.gather(1, j)[:, 0], _INF)
        u_out[s:e] = torch.where(hit, u.gather(1, j)[:, 0], 0.0)
        v_out[s:e] = torch.where(hit, v.gather(1, j)[:, 0], 0.0)
        tri_out[s:e] = torch.where(hit, j[:, 0].to(torch.int32), -1)
    return t_out, u_out, v_out, tri_out


def closest_rows(w, o, d, tn, tf):
    """`closest_woop` of flat rays against Woop rows w (T, 12), with the
    winner's derivative in o and d."""
    with torch.no_grad():
        bt, bu, bv, btri = closest_woop(w, o.detach(), d.detach(), tn, tf)
    if o.requires_grad or d.requires_grad:
        bt, bu, bv = _with_grad(w, o, d, bt, bu, bv, btri)
    return bt, bu, bv, btri


def _any_woop(w, o, d, tn, tf):
    n = o.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for s in range(0, n, _CHUNK):
        e = min(n, s + _CHUNK)
        occ[s:e] = woop_tuvok(o[s:e], d[s:e], tn[s:e], tf[s:e], w)[3].any(1)
    return occ


def _slab(bmin, bmax, o, inv, tn, tf):
    """Entry distance and overlap of rays with boxes (broadcast), within
    a relative 1e-4 and an absolute 1e-5 so that rounding never drops a
    triangle's hit."""
    t1 = (bmin - o) * inv
    t2 = (bmax - o) * inv
    tent = torch.maximum(torch.minimum(t1, t2).amax(-1), tn)
    texit = torch.minimum(torch.maximum(t1, t2).amin(-1), tf)
    return tent, tent <= texit + (1e-4 * (tent.abs() + texit.abs()) + 1e-5)


def _box_pairs(cl, o, d, tn, tf):
    """(ray, cluster, entry) of every (ray, cluster) pair whose box the ray
    crosses within [tn, tf], found through the boxes of GROUP clusters,
    ordered by ray and, within a ray, by the box's entry distance."""
    inv = 1.0 / torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
    n_super = cl.smin.shape[0]
    none = torch.zeros((0,), dtype=torch.int64, device=o.device)
    sr, ss = [none], [none]
    step = max(1, _BOX_ELEMS // n_super)
    for s in range(0, o.shape[0], step):
        e = min(o.shape[0], s + step)
        _t, hit = _slab(cl.smin[None], cl.smax[None], o[s:e, None],
                        inv[s:e, None], tn[s:e, None], tf[s:e, None])
        r, c = torch.nonzero(hit, as_tuple=True)
        sr.append(r + s)
        ss.append(c)
    sr, ss = torch.cat(sr), torch.cat(ss)
    n_cl = cl.cmin.shape[0]
    lanes = torch.arange(GROUP, device=o.device)
    rays, clus, ents = [none], [none], [o.new_zeros((0,))]
    step = max(1, _BOX_ELEMS // GROUP)
    for s in range(0, sr.shape[0], step):
        r = sr[s:s + step].repeat_interleave(GROUP)
        c = (ss[s:s + step, None] * GROUP + lanes).reshape(-1)
        keep = c < n_cl
        r, c = r[keep], c[keep]
        ent, hit = _slab(cl.cmin[c], cl.cmax[c], o[r], inv[r], tn[r], tf[r])
        rays.append(r[hit])
        clus.append(c[hit])
        ents.append(ent[hit])
    r, c, ent = torch.cat(rays), torch.cat(clus), torch.cat(ents)
    order = torch.argsort(ent, stable=True)
    r, c, ent = r[order], c[order], ent[order]
    order = torch.argsort(r, stable=True)
    return r[order], c[order], ent[order]


def _near_first(r):
    """For pairs ordered by ray: True on each ray's _NEAR first pairs."""
    if r.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=r.device)
    _u, counts = torch.unique_consecutive(r, return_counts=True)
    starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts,
                                     counts)
    return torch.arange(r.shape[0], device=r.device) - starts < _NEAR


def _winners(cl, r_all, c_all, o, d, tn, tf):
    """The hit of least t of each listed pair (ties to the lower triangle
    index) -> [(ray, t, u, v, tri)] of the pairs with a hit, by chunk."""
    cand = []
    for s in range(0, r_all.shape[0], _PAIR_CHUNK):
        r = r_all[s:s + _PAIR_CHUNK]
        c = c_all[s:s + _PAIR_CHUNK]
        t, u, v, ok = mt_tuvok(cl.tris[c], o[r], d[r], tn[r], tf[r])
        ids = cl.ids[c]
        tt = torch.where(ok, t, _INF)
        tmin = tt.amin(1, keepdim=True)
        first = torch.where(tt <= tmin, ids, torch.iinfo(torch.int32).max)
        j = first.argmin(1, keepdim=True)
        keep = torch.isfinite(tmin[:, 0])
        cand.append((r[keep], tmin[keep, 0], u.gather(1, j)[keep, 0],
                     v.gather(1, j)[keep, 0], ids.gather(1, j)[keep, 0]))
    return cand


def _reduce(n, cand, dev):
    """Per ray, the candidate of least t, ties to the lower triangle."""
    t_out = torch.full((n,), _INF, device=dev)
    u_out = torch.zeros((n,), device=dev)
    v_out = torch.zeros((n,), device=dev)
    tri_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if not cand:
        return t_out, u_out, v_out, tri_out
    r, t, u, v, tri = (torch.cat(x) for x in zip(*cand))
    t_out.scatter_reduce_(0, r, t, "amin")
    big = torch.iinfo(torch.int32).max
    best = torch.full((n,), big, dtype=torch.int32, device=dev)
    best.scatter_reduce_(0, r, torch.where(t == t_out[r], tri, big), "amin")
    win = (t == t_out[r]) & (tri == best[r])
    u_out[r[win]] = u[win]
    v_out[r[win]] = v[win]
    tri_out[r[win]] = tri[win]
    return t_out, u_out, v_out, tri_out


def _closest_clustered(cl, o, d, tn, tf):
    """Each ray's _NEAR nearest boxes first; then only the boxes it
    enters no later than its best hit so far (a triangle in a box is hit
    no nearer than the box's entry; the slack keeps ties)."""
    n = o.shape[0]
    r, c, ent = _box_pairs(cl, o, d, tn, tf)
    near = _near_first(r)
    cand = _winners(cl, r[near], c[near], o, d, tn, tf)
    best = _reduce(n, cand, o.device)[0]
    bt = best[r]
    rest = ~near & (ent <= bt + 1e-4 * bt.abs() + 1e-5)
    cand += _winners(cl, r[rest], c[rest], o, d, tn, tf)
    return _reduce(n, cand, o.device)


def _any_clustered(cl, o, d, tn, tf):
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    r, c, _ent = _box_pairs(cl, o, d, tn, tf)
    near = _near_first(r)
    for sel in (near, ~near):
        rs, cs = r[sel], c[sel]
        live = ~occ[rs]
        rs, cs = rs[live], cs[live]
        for s in range(0, rs.shape[0], _PAIR_CHUNK):
            rr = rs[s:s + _PAIR_CHUNK]
            cc = cs[s:s + _PAIR_CHUNK]
            ok = mt_tuvok(cl.tris[cc], o[rr], d[rr], tn[rr], tf[rr])[3].any(1)
            occ[rr[ok]] = True
    return occ


def _flat(o, d, tnear, tfar):
    shape = o.shape[:-1]
    n = o[..., 0].numel()

    def ray_scalar(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=o.device)
        return x.expand(shape).reshape(n).contiguous()

    return (shape, o.detach().reshape(n, 3), d.detach().reshape(n, 3),
            ray_scalar(tnear).detach(), ray_scalar(tfar).detach())


def _with_grad(rows, o, d, bt, bu, bv, btri):
    """t, u, v with the derivative of the winner's Woop test (rows (T, 12))
    in o and d, and their values unchanged."""
    w = rows[torch.clamp(btri, min=0).long()]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    def aff(c):
        return ox * w[:, 4 * c] + oy * w[:, 4 * c + 1] \
            + oz * w[:, 4 * c + 2] + w[:, 4 * c + 3]

    def lin(c):
        return dx * w[:, 4 * c] + dy * w[:, 4 * c + 1] + dz * w[:, 4 * c + 2]

    hit = btri >= 0
    dw = lin(2)
    t = -aff(2) / torch.where(hit & (dw.abs() > 1e-18), dw, 1.0)
    u = aff(0) + t * lin(0)
    v = aff(1) + t * lin(1)
    out = []
    for val, g in ((bt, t), (bu, u), (bv, v)):
        g = torch.where(hit, g, 0.0)
        out.append(val + (g - g.detach()))
    return out


def intersect_closest(scene, o, d, tnear, tfar, cfg=None) -> Hit:
    """Closest-hit query; cfg (the program's intersector settings) is not
    read."""
    shape, of, df, tn, tf = _flat(o, d, tnear, tfar)
    with torch.no_grad():
        if scene.clusters is None:
            bt, bu, bv, btri = closest_woop(scene.woop.reshape(-1, 12), of,
                                            df, tn, tf)
        else:
            bt, bu, bv, btri = _closest_clustered(scene.clusters, of, df,
                                                  tn, tf)
    if o.requires_grad or d.requires_grad:
        bt, bu, bv = _with_grad(scene.woop.reshape(-1, 12), o.reshape(-1, 3),
                                d.reshape(-1, 3), bt, bu, bv, btri)
    hit = (btri >= 0).reshape(shape)
    return Hit(t=torch.where(hit, bt.reshape(shape), 0.0),
               u=bu.reshape(shape), v=bv.reshape(shape),
               tri=btri.reshape(shape), hit=hit)


def intersect_any(scene, o, d, tnear, tfar, cfg=None):
    """Any-hit (shadow) query -> bool."""
    shape, of, df, tn, tf = _flat(o, d, tnear, tfar)
    with torch.no_grad():
        if scene.clusters is None:
            occ = _any_woop(scene.woop.reshape(-1, 12), of, df, tn, tf)
        else:
            occ = _any_clustered(scene.clusters, of, df, tn, tf)
    return occ.reshape(shape)


def test_occlusion(scene, from_p, to_p, params, cfg=None):
    """Shadow test between two points: tnear = tnear_offset, tfar = dist -
    tfar_offset (pg/Intersection.h:42-60). True where occluded."""
    seg = to_p - from_p
    dist = mathx.length(seg)
    return intersect_any(scene, from_p, mathx.normalize(seg),
                         torch.full_like(dist, params.tnear_offset),
                         dist - params.tfar_offset)


def hit_attributes(scene, o, d, hit: Hit) -> HitInfo:
    """Barycentric interpolation of the vertex attributes at hits, the
    normal flipped toward the viewer (pg/Intersection.h:8-113)."""
    tri = torch.clamp(hit.tri, min=0)
    w = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    nt = scene.num_tris
    attr = torch.cat([
        scene.vtx_normal.reshape(nt, 9), scene.vtx_uv.reshape(nt, 6),
        scene.vtx_tangent.reshape(nt, 9),
        scene.tri_mat.to(torch.float32)[:, None]], dim=1)
    rows = mathx.take_rows(attr, tri)
    n = mathx.normalize(mathx.bary_interp(rows[..., 0:9], w))
    from_inside = (mathx.dot(-d, n) <= 0.0) & hit.hit
    n = torch.where(from_inside[..., None], -n, n)
    return HitInfo(
        did_hit=hit.hit, point=o + d * hit.t[..., None], normal=n,
        uv=mathx.bary_interp(rows[..., 9:15], w),
        tangent=mathx.bary_interp(rows[..., 15:24], w),
        from_inside=from_inside, dst=hit.t, tri=hit.tri,
        mat_id=torch.where(hit.hit, rows[..., 24].to(torch.int32), 0))
