"""Ray-scene intersection (counterpart of `tpu_restir.render.intersect`),
with every backend of the JAX package:

* "fused": the ray/triangle kernels K1 and K2 (`kernels/ray_tri.py`), for
  scenes of at most `fused_max_tris` triangles;
* "ptrace": the packet-shortlist traversal K5 and K6
  (`kernels/cluster_trace.py`) on clustered scenes, in chunks of
  `ptrace_chunk` rays; with `ptrace_mxu` the scene's Woop blocks go along,
  and the traversal takes its Woop variant K7/K8 where it applies (scenes
  built at cluster_size 128, factor 1);
* "brute": the exhaustive Moller-Trumbore test over blocks of `tri_block`
  triangles, the correctness baseline (intersect.py:70-156);
* "woop_mxu": the exhaustive Woop test (`kernels/woop.intersect_block`,
  intersect.py:219-266);
* "cluster": the cluster AABBs culled per chunk of `ray_chunk` rays, each
  cluster that some ray of the chunk reaches tested by the Woop test
  (intersect.py:554-611);
* "fcluster": packet-cluster culling and shortlist rounds
  (`accel/fcluster.py`);
* "bvh": the wide BVH's lockstep walk (`accel/wide.py`), on clustered
  scenes of at most 50,000 triangles.

"auto" picks as the JAX package does off the CPU (intersect.py:673-689):
fused, then ptrace on clustered scenes; "fcluster", "cluster" and
"woop_mxu" follow for scenes that lack the kernels' arrays. The last five
are the JAX package's XLA programs in plain tensor code, the same on CPU
and CUDA tensors; none goes through a kernel. Rays of a 2-D pixel grid
are swizzled into 8x32-tile packets for "ptrace" and "fcluster", and the
other backends take queries in chunks of `ray_chunk` rays, the last
padded with dead rays as the JAX package pads it.

Gradients in the ray origins and directions: the closest-hit queries of
fused, ptrace, fcluster and bvh carry the detached-winner derivative of
`ray_tri.closest_hit_bwd` (the JAX package's custom VJPs); brute,
woop_mxu and cluster are differentiated by autograd through their
operations, as JAX differentiates them. Occlusion is a detached bool.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpu_restir_torch import mathx, tracing
from tpu_restir_torch.accel import fcluster, wide
from tpu_restir_torch.config import IntersectorConfig
from tpu_restir_torch.kernels import cluster_trace, ray_tri, woop

_INF = float("inf")
_DET_EPS = 1e-18
BACKENDS = ("auto", "fused", "ptrace", "brute", "woop_mxu", "cluster",
            "fcluster", "bvh")
# the wide BVH's lockstep walk is fenced to scenes of this size, as in the
# JAX package (intersect.py:654-662)
BVH_MAX_TRIS = 50_000
# most (ray, triangle) pairs one block test of brute and woop_mxu holds at
# once; a chunk's rays are cut into parts of at most this many pairs, which
# changes no result (each ray meets every block in order)
_BLOCK_PAIRS = 1 << 24


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

    did_hit: torch.Tensor      # (...,) bool
    point: torch.Tensor        # (..., 3)
    normal: torch.Tensor       # (..., 3) shading normal, toward the viewer
    uv: torch.Tensor           # (..., 2)
    tangent: torch.Tensor      # (..., 3)
    from_inside: torch.Tensor  # (...,) bool
    dst: torch.Tensor          # (...,)
    tri: torch.Tensor          # (...,) int32
    mat_id: torch.Tensor       # (...,) int32


def _backend(scene, cfg: IntersectorConfig) -> str:
    """The backend of a query (intersect.py:647-689): a backend asked for
    by name, refused where the scene lacks what it needs, or "auto", which
    reads the chain as the JAX package does off the CPU. The port refuses
    "fused" above `fused_max_tris` triangles, and an unknown name."""
    backend = cfg.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown intersection backend {backend!r}; one of "
                         f"{BACKENDS}")
    if backend == "auto":
        if ray_tri.supports(scene, cfg.fused_max_tris):
            return "fused"
        if cluster_trace.supports(scene):
            return "ptrace"
        if scene.cluster_min is not None \
                and scene.num_tris > cfg.bvh_threshold:
            return "fcluster"
        if scene.cluster_min is not None:
            return "cluster"
        return "woop_mxu" if scene.woop is not None else "brute"
    if backend == "bvh" and scene.bvh is None:
        raise ValueError(
            "backend='bvh' requested but the scene has no wide BVH "
            f"(num_tris={scene.num_tris} <= cluster threshold; "
            "build_scene only builds one for larger scenes)")
    if backend == "bvh" and scene.num_tris > BVH_MAX_TRIS:
        raise ValueError(
            f"backend='bvh' is fenced to scenes <= {BVH_MAX_TRIS} "
            f"triangles (got {scene.num_tris}); use 'ptrace' or 'fcluster' "
            "at scale")
    if backend in ("fcluster", "cluster") and scene.cluster_min is None:
        raise ValueError(
            f"backend={backend!r} requested but the scene has no cluster "
            "arrays (scene too small; use 'fused'/'woop_mxu')")
    if backend == "ptrace" and scene.cluster_tris is None:
        raise ValueError(
            "backend='ptrace' requested but the scene has no cluster "
            "blocks (scene too small; use 'fused'/'woop_mxu')")
    if backend == "fused" and not ray_tri.supports(scene, cfg.fused_max_tris):
        raise ValueError(
            f"backend 'fused' needs at most fused_max_tris="
            f"{cfg.fused_max_tris} triangles (got {scene.num_tris})")
    return backend


def _flat_rays(o, d, tnear, tfar):
    shape = o.shape[:-1]

    def flat(x):
        return torch.as_tensor(x, dtype=torch.float32, device=o.device) \
            .expand(shape).reshape(-1).contiguous()

    return (shape, o.reshape(-1, 3).contiguous(),
            d.reshape(-1, 3).contiguous(), flat(tnear), flat(tfar))


_TILE_H, _TILE_W = 8, 32   # 8 x 32 pixels == one packet of 256 rays


def _swizzle_applicable(backend: str, shape) -> bool:
    """2-D pixel grids and batched (Q, ..., H, W) query stacks of the
    packet backends fold per image into 8x32-tile packets
    (intersect.py:640-644); other shapes run unswizzled, which is as
    exact and only slower."""
    return (backend in ("fcluster", "ptrace") and len(shape) >= 2
            and shape[-2] % _TILE_H == 0 and shape[-1] % _TILE_W == 0)


def _tile_fold(x, h, w, q):
    """Row-major flat (q*h*w, ...) -> packet-major 8x32-tile order per
    image (intersect.py:159-167)."""
    rest = x.shape[1:]
    xr = x.reshape(q, h // _TILE_H, _TILE_H, w // _TILE_W, _TILE_W, *rest)
    return xr.transpose(2, 3).reshape((q * h * w,) + rest)


def _tile_unfold(x, h, w, q):
    """Inverse of _tile_fold (intersect.py:170-175)."""
    rest = x.shape[1:]
    xr = x.reshape(q, h // _TILE_H, w // _TILE_W, _TILE_H, _TILE_W, *rest)
    return xr.transpose(2, 3).reshape((q * h * w,) + rest)


def _tile_perm(h: int, w: int, device=None) -> torch.Tensor:
    """Packet-major -> row-major pixel index (intersect.py:617-627): packet
    j covers an 8x32 pixel tile."""
    j = torch.arange(h * w, device=device)
    tpr = w // _TILE_W
    tile, within = j // (_TILE_H * _TILE_W), j % (_TILE_H * _TILE_W)
    ty, tx = within // _TILE_W, within % _TILE_W
    t_y, t_x = tile // tpr, tile % tpr
    return (t_y * _TILE_H + ty) * w + (t_x * _TILE_W + tx)


def _tile_perm_inv(h: int, w: int, device=None) -> torch.Tensor:
    """Row-major pixel index -> packet-major position
    (intersect.py:630-637)."""
    src = torch.arange(h * w, device=device)
    y, x = src // w, src % w
    tile = (y // _TILE_H) * (w // _TILE_W) + x // _TILE_W
    return tile * (_TILE_H * _TILE_W) + (y % _TILE_H) * _TILE_W \
        + (x % _TILE_W)


def _run_chunked(fn, shape, of, df, tn, tf, chunk: int, swizzle: bool,
                 pad: bool = True):
    """fn(o, d, tnear, tfar) over flat rays in chunks of `chunk` rays
    (intersect.py:178-211), in 8x32-tile order where `swizzle`. A query of
    more than `chunk` rays has its last chunk padded to `chunk` rays with
    dead rays (o = d = 0, tnear 0, tfar -1), as JAX's lax.map pads it;
    "cluster" needs that padding, since a chunk's rays decide together
    which clusters it skips. `pad` False leaves the last chunk short
    (ptrace, whose traversal pads to a packet multiple with the same dead
    rays). fn returns a tensor or a tuple of tensors."""
    r = of.shape[0]
    if swizzle:
        h, w = shape[-2], shape[-1]
        q = int(np.prod(shape[:-2], dtype=np.int64))
        of, df, tn, tf = (_tile_fold(x, h, w, q) for x in (of, df, tn, tf))
    if r > chunk and pad and r % chunk:
        n = -r % chunk
        of = torch.cat([of, of.new_zeros((n, 3))])
        df = torch.cat([df, df.new_zeros((n, 3))])
        tn = torch.cat([tn, tn.new_zeros((n,))])
        tf = torch.cat([tf, tf.new_full((n,), -1.0)])
    parts = [fn(of[s:s + chunk], df[s:s + chunk], tn[s:s + chunk],
                tf[s:s + chunk])
             for s in range(0, max(of.shape[0], 1), chunk)]
    single = not isinstance(parts[0], tuple)
    if single:
        parts = [(x,) for x in parts]
    out = [torch.cat(x)[:r] for x in zip(*parts)]
    if swizzle:
        out = [_tile_unfold(x, h, w, q) for x in out]
    return out[0] if single else tuple(out)


# ---------------------------------------------------------------------------
# The exhaustive backends: brute (Moller-Trumbore) and woop_mxu (Woop)
# ---------------------------------------------------------------------------

def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore on broadcast (..., 3) rays and triangles -> t, u, v,
    ok (...) in the operation order of the JAX package's `_mt_block`
    (jnp.cross, sums over the last axis in order); no slack; the
    reciprocal of det is safe under autograd."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = torch.abs(det) > _DET_EPS
    inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    tvx = o[..., 0] - v0[..., 0]
    tvy = o[..., 1] - v0[..., 1]
    tvz = o[..., 2] - v0[..., 2]
    u = (tvx * px + tvy * py + tvz * pz) * inv
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def _mt_block(o, d, v0, e1, e2):
    """Rays (C, 3) x triangles (B, 3) -> t, u, v, ok (C, B)
    (intersect.py:70-84)."""
    return _mt(o[:, None, :], d[:, None, :], v0[None], e1[None], e2[None])


def _min_update(carry, t, u, v, ok, base: int):
    """Fold a (C, B) block of candidates into the per-ray running minimum
    (t, u, v, tri) (intersect.py:87-104): the first candidate of least t
    in the block, taken only where strictly closer than the carry, so
    ties go to the lowest triangle id. amin passes a tie's gradient in
    equal shares, as JAX's min does."""
    bt, bu, bv, btri = carry
    tt = torch.where(ok, t, _INF)
    tmin = tt.amin(1)
    jwin = torch.argmax((tt <= tmin[:, None]).to(torch.uint8), 1,
                        keepdim=True)
    mu = u.gather(1, jwin)[:, 0]
    mv = v.gather(1, jwin)[:, 0]
    better = tmin < bt
    return (torch.where(better, tmin, bt), torch.where(better, mu, bu),
            torch.where(better, mv, bv),
            torch.where(better, base + jwin[:, 0].to(torch.int32), btri))


def _pad_tris(scene, block: int):
    """Triangle rows (nb, block, 3) each of v0, e1, e2, the tail padded
    with v0 = 1e30 and zero edges (det = 0: never a hit)
    (intersect.py:107-124)."""
    n = scene.num_tris
    nb = -(-n // block)
    pad = nb * block - n

    def padded(x, fill):
        if pad:
            x = torch.cat([x, x.new_full((pad, 3), fill)])
        return x.reshape(nb, block, 3)

    return (padded(scene.tri_v0, 1e30), padded(scene.tri_e1, 0.0),
            padded(scene.tri_e2, 0.0))


def _pad_woop(scene, block: int):
    """The Woop maps packed per block of triangles -> (nb, 4, 3 block)
    operands of `woop.intersect_block`; padding maps send u and v to inf
    (intersect.py:219-234)."""
    m = scene.woop
    n = m.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        filler = m.new_zeros((pad, 3, 4))
        filler[:, 0, 3] = _INF
        filler[:, 1, 3] = _INF
        m = torch.cat([m, filler])
    return m.reshape(nb, block * 3, 4).transpose(1, 2)


def _ray_parts(c: int, block: int):
    """Ray ranges of a chunk of c rays for blocks of `block` triangles,
    at most _BLOCK_PAIRS pairs each."""
    step = max(1, _BLOCK_PAIRS // block)
    return [slice(s, min(c, s + step)) for s in range(0, max(c, 1), step)]


def _scan_closest(test, blocks, o, d, tnear, tfar, block: int):
    """Closest hit of a ray chunk over triangle blocks in order, each
    test(o, d, tn, tf, blk) -> (t, u, v, ok) (C, block), folded by
    _min_update (intersect.py:127-143, :237-253)."""
    parts = []
    for rs in _ray_parts(o.shape[0], block):
        c = rs.stop - rs.start
        dev = o.device
        carry = (torch.full((c,), _INF, device=dev),
                 torch.zeros((c,), device=dev), torch.zeros((c,), device=dev),
                 torch.full((c,), -1, dtype=torch.int32, device=dev))
        for i, blk in enumerate(blocks):
            carry = _min_update(carry, *test(o[rs], d[rs], tnear[rs],
                                             tfar[rs], blk), i * block)
        parts.append(carry)
    return tuple(torch.cat(x) for x in zip(*parts))


def _scan_any(test, blocks, o, d, tnear, tfar, block: int):
    """Occlusion of a ray chunk over triangle blocks
    (intersect.py:146-156, :256-266)."""
    out = []
    for rs in _ray_parts(o.shape[0], block):
        occ = torch.zeros((rs.stop - rs.start,), dtype=torch.bool,
                          device=o.device)
        for blk in blocks:
            occ = occ | test(o[rs], d[rs], tnear[rs], tfar[rs], blk)[3] \
                .any(1)
        out.append(occ)
    return torch.cat(out)


def _mt_test(o, d, tnear, tfar, blk):
    v0, e1, e2 = blk
    t, u, v, ok = _mt_block(o, d, v0, e1, e2)
    ok = ok & (t >= tnear[:, None]) & (t <= tfar[:, None])
    return t, u, v, ok


def _woop_test(o, d, tnear, tfar, w_packed):
    return woop.intersect_block(o, d, w_packed, tnear, tfar)


def _exhaustive(backend: str, scene, cfg: IntersectorConfig):
    """(test, blocks, block) of brute or woop_mxu."""
    block = min(cfg.tri_block, scene.num_tris)
    if backend == "woop_mxu":
        return _woop_test, _pad_woop(scene, block), block
    return _mt_test, list(zip(*_pad_tris(scene, block))), block


# ---------------------------------------------------------------------------
# cluster: cluster AABBs culled per ray chunk, visited clusters by Woop
# ---------------------------------------------------------------------------

def _aabb_hits(o, d, tnear, tfar, cmin, cmax):
    """Slab test rays (C, 3) x boxes (K, 3) -> (C, K) bool
    (intersect.py:554-564), with the repaired exit on clamped axes of
    `accel.wide.slab`: the JAX test misses a box whose max-face plane the
    ray lies in."""
    inv, small = wide.safe_inv(d)
    tn, tf = wide.slab(o[:, None, :], inv[:, None, :], small[:, None, :],
                       cmin[None], cmax[None])
    return (tn <= tf) & (tf >= tnear[:, None]) & (tn <= tfar[:, None])


def _visited(o, d, tnear, tfar, scene):
    """The clusters that some ray of the chunk reaches, on the host (one
    sync a chunk)."""
    tracing.count("sync.cluster", 1)
    hits = _aabb_hits(o, d, tnear, tfar, scene.cluster_min,
                      scene.cluster_max)
    return hits.any(0).tolist()


def _closest_chunk_cluster(o, d, tnear, tfar, scene, wb):
    """Closest hit of one ray chunk (intersect.py:567-589): every cluster
    that no ray of the chunk reaches is skipped; the others run the Woop
    test on every ray of the chunk. The Woop test's slack can hit a point
    just outside a cluster's box, so a ray's result can depend on the
    other rays of its chunk, as in the JAX package."""
    block = wb.shape[2] // 3
    c = o.shape[0]
    dev = o.device
    carry = (torch.full((c,), _INF, device=dev), torch.zeros((c,), device=dev),
             torch.zeros((c,), device=dev),
             torch.full((c,), -1, dtype=torch.int32, device=dev))
    for i, visit in enumerate(_visited(o, d, tnear, tfar, scene)):
        if visit:
            carry = _min_update(carry, *woop.intersect_block(
                o, d, wb[i], tnear, tfar), i * block)
    return carry


def _any_chunk_cluster(o, d, tnear, tfar, scene, wb):
    """Occlusion of one ray chunk (intersect.py:592-611): a cluster is
    skipped where no ray of the chunk reaches it, or where every ray of
    the chunk is already occluded (one host sync a visited cluster)."""
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for i, visit in enumerate(_visited(o, d, tnear, tfar, scene)):
        if not visit:
            continue
        tracing.count("sync.cluster", 1)
        if bool(occ.all()):
            continue
        occ = occ | woop.intersect_block(o, d, wb[i], tnear, tfar)[3].any(1)
    return occ


# ---------------------------------------------------------------------------
# The queries
# ---------------------------------------------------------------------------

def _count_query(kind: str, backend: str, shape) -> None:
    """Count a query's rays as `rays.<kind>.<backend>`: the per-frame ray
    totals behind the traced rays-per-pixel checks."""
    tracing.count(f"rays.{kind}.{backend}",
                  int(np.prod(shape, dtype=np.int64)))


def queries(recorded) -> list:
    """The queries among the entries of a `tracing.recording()`, in query
    order: one {"kind", "backend", "rays"} dict each."""
    return [dict(zip(("kind", "backend"), name.split(".")[1:]), rays=n)
            for name, n in recorded if name.startswith("rays.")]


def _query_fn(kind: str, backend: str, scene, cfg: IntersectorConfig):
    """The chunk function of a query kind ("closest" or "any") under a
    backend other than fused and ptrace: rays (C, 3), tnear, tfar (C,) ->
    (t, u, v, tri) or occlusion."""
    closest = kind == "closest"
    if backend in ("brute", "woop_mxu"):
        test, blocks, block = _exhaustive(backend, scene, cfg)
        return functools.partial(_scan_closest if closest else _scan_any,
                                 test, blocks, block=block)
    if backend == "cluster":
        wb = _pad_woop(scene, scene.cluster_size)
        return functools.partial(
            _closest_chunk_cluster if closest else _any_chunk_cluster,
            scene=scene, wb=wb)
    if backend == "fcluster":
        v0b, e1b, e2b = _pad_tris(scene, scene.cluster_size)
        fn = fcluster.fcluster_closest if closest else fcluster.fcluster_any
        return lambda o, d, tn, tf: fn(
            o, d, tn, tf, v0b, e1b, e2b, scene.cluster_min,
            scene.cluster_max, p=cfg.packet_size, k=cfg.shortlist_k,
            bin_rays=cfg.bin_rays)
    fn = wide.bvh8_closest if closest else wide.bvh8_any
    return lambda o, d, tn, tf: fn(scene.bvh, scene.tri_v0, scene.tri_e1,
                                   scene.tri_e2, o, d, tn, tf)


def _ptrace(fn, scene, cfg: IntersectorConfig, shape, of, df, tn, tf):
    """fn (cluster_trace.trace_closest or trace_any) over flat rays in
    chunks of `cfg.ptrace_chunk` (intersect.py:514-525), with the scene's
    Woop blocks where `cfg.ptrace_mxu` asks for them. The last chunk is
    not padded to the chunk size: the trace pads it to a packet multiple
    with the same dead rays, so every packet holds the rays it holds in
    the JAX package's padded chunk."""
    cwoop = scene.cluster_woop if cfg.ptrace_mxu else None
    return _run_chunked(
        lambda o, d, tnear, tfar: fn(scene.cluster_tris, scene.cluster_min,
                                     scene.cluster_max, o, d, tnear, tfar,
                                     cwoop=cwoop),
        shape, of, df, tn, tf, cfg.ptrace_chunk,
        _swizzle_applicable("ptrace", shape), pad=False)


def intersect_closest(scene, o, d, tnear, tfar,
                      cfg: IntersectorConfig = IntersectorConfig()) -> Hit:
    """Closest-hit query (reference Intersection::getClosestIntersection)."""
    backend = _backend(scene, cfg)
    _count_query("closest", backend, o.shape[:-1])
    shape, of, df, tn, tf = _flat_rays(o, d, tnear, tfar)
    if backend == "fused":
        bt, bu, bv, btri = ray_tri.closest_hit(scene, of, df, tn, tf)
    elif backend == "ptrace":
        bt, bu, bv, btri = ray_tri.ClosestHit.apply(
            functools.partial(_ptrace, cluster_trace.trace_closest, scene,
                              cfg, shape),
            ray_tri.woop_rows(scene), of, df, tn, tf)
    else:
        run = functools.partial(
            _run_chunked, _query_fn("closest", backend, scene, cfg), shape,
            chunk=cfg.ray_chunk,
            swizzle=_swizzle_applicable(backend, shape))
        if backend in ("fcluster", "bvh"):
            bt, bu, bv, btri = ray_tri.ClosestHit.apply(
                run, ray_tri.woop_rows(scene), of, df, tn, tf)
        else:
            bt, bu, bv, btri = run(of, df, tn, tf)
    hit = (btri >= 0).reshape(shape)
    return Hit(t=torch.where(hit, bt.reshape(shape), 0.0),
               u=bu.reshape(shape), v=bv.reshape(shape),
               tri=btri.reshape(shape), hit=hit)


def intersect_any(scene, o, d, tnear, tfar,
                  cfg: IntersectorConfig = IntersectorConfig()):
    """Any-hit (shadow) query (reference rtcOccluded1 path) -> bool."""
    backend = _backend(scene, cfg)
    _count_query("any", backend, o.shape[:-1])
    shape, of, df, tn, tf = _flat_rays(o, d, tnear, tfar)
    if backend == "fused":
        return ray_tri.any_hit(scene, of, df, tn, tf).reshape(shape)
    of, df, tn, tf = (x.detach() for x in (of, df, tn, tf))
    if backend == "ptrace":
        occ = _ptrace(cluster_trace.trace_any, scene, cfg, shape, of, df,
                      tn, tf)
    else:
        with torch.no_grad():
            occ = _run_chunked(_query_fn("any", backend, scene, cfg), shape,
                               of, df, tn, tf, cfg.ray_chunk,
                               _swizzle_applicable(backend, shape))
    return occ.reshape(shape)


def test_occlusion(scene, from_p, to_p, params,
                   cfg: IntersectorConfig = IntersectorConfig()):
    """Shadow test between two points with the reference's epsilon policy:
    tnear = tnear_offset, tfar = dist - tfar_offset
    (Intersection::testOcclusion, pg/Intersection.h:42-60). True where
    occluded."""
    seg = to_p - from_p
    dist = mathx.length(seg)
    return intersect_any(scene, from_p, mathx.normalize(seg),
                         torch.full_like(dist, params.tnear_offset),
                         dist - params.tfar_offset, cfg)


def hit_attributes(scene, o, d, hit: Hit) -> HitInfo:
    """Interpolate vertex attributes at hits (reference
    Intersection::getGeometryAttributes, pg/Intersection.h:8-113):
    barycentric interpolation, normal normalization, and the backface flip
    with from_inside tagging."""
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
