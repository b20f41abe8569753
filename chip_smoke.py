#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_restir_torch) on one GPU.

    python3 chip_smoke.py [--profile=PATH]

Phases; any failure raises, so the exit code is non-zero and the final
line is not printed:
  1. device: require CUDA; print the card and its power limit; TF32 off.
  2. build the CUDA kernels from csrc/ (five nvcc, sm_90a, started
     together) and the host BVH builder (g++); print times and registers.
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: exact ids, masks and copies; float error printed
     with the tolerance stated; kernel and plain times (CUDA events around
     runs enqueued back to back), the bound (the least time for the bytes
     and operations the inputs need, operations at the card's unfused
     float32 issue rate) and, for K3/K4, the time of one PyTorch call
     computing the same function. K2 and K3 also run on the main path's
     own inputs, captured from a Cornell bench frame: its first full-frame
     shadow query and its spatial pass's taps and payload.
     K5/K6 and their plain versions run on whole 1080p queries
     of a terrain100k and a lights1k bench frame, each any-hit kernel
     held on each scene to a query with occluded and visible rays;
     factor 4 (superclusters) must equal factor 1 on
     terrain_scene(20_000). K9, phase 1's keys, against its plain version
     `shortlist_keys` (keys as int32 bits, counts; `hold_keys`) on the
     G-buffer and shadow packets of each of those scenes, and later on
     terrain100k's NEE-MIS bounce-1 queries and terrain1M's at factor 4,
     timed beside the eager key build, with its bound from the operations
     its early exits leave (`key_work`). K7/K8 (the Woop variant) likewise on a
     terrain100k-128 bench frame under ptrace_mxu (terrain100k rebuilt at
     cluster size 128), with K5/K6 timed on the same scene and queries
     beside them. t/u/v of K1, K5 and K7 bit-identical. The bounds of
     the ray/triangle kernels count operations per (ray, row) from the
     plain test on the query's own rays: a row is charged the leading part
     of its test that rules it out (the t half, or the test through u),
     else the whole test; a closest-hit query of K5/K7 tests each live ray
     against the clusters its own min(t, tfar) reaches; an any-hit query
     of K6 or K8 in cull mode 5 pays a box test per listed (visible ray,
     cluster) pair and rows only where the ray's slab test leaves it
     live (K8: on the boxes grown by the Woop test's reach). Each line
     prints beside it the bound with the whole test on every pair (and
     for K5/K7 the pairs counted per packet, for K6/K8 in mode 5 the rows
     of every listed pair), and K6's and K8's lines in mode 5 the shares
     of listed pairs that are slab-live and that the kernel's warps and
     blocks test (the first such share also in the kernel's JSON entry).
     K4 must equal its plain version bit for bit on integer cotangents
     and, on normal ones, the sum in its own order (its sha256 printed).
     K10, calc_i_m's incomplete beta, against its plain version
     `_ibeta_value` on one 1080p call (`check_ibeta`): lanes that differ
     in float64 and in float32 (none expected; over 1 float32 ulp
     raises), kernel and plain ms, the bound of its FP64 instructions,
     and calc_i_m whole with K10 and with the plain chain.
  4. the main path: Renderer on the Cornell box at 1920x1080, the bench
     config (m_area=1, m_brdf=1, temporal, 5-neighbour pairwise spatial),
     8 frames; the traced rays per pixel must equal the analytic 28, every
     kernel must have launched, the image must be finite with a plausible
     mean; ms/frame, Mrays/s and a per-pass breakdown are printed.
     Then [integrators], the naive and NEE path tracers at 1920x1080
     through Renderer (PATH_RUNS: naive, NEE area/BRDF/MIS/RIS and the
     MIS weights on Cornell through K1/K2; NEE-RIS on lights1k, and
     naive and NEE-MIS on terrain100k from the terrain camera, through
     K5/K6), each after a warm-up frame: traced rays per pixel equal to
     path_rays_per_pixel (6 naive, 18 NEE-MIS), one kernel launch per
     logged query (K5/K6: per chunk) and no other kernel, finite frames,
     ms/frame, Mrays/s and peak memory; on terrain100k one more frame of
     each, the shortlist count of every query by bounce and role (mean,
     p50, p95, p99, max of C), and K5 on the bounce-1 path query and K6
     on the bounce-1 shadow query held to their plain versions (the
     whole query, or every 16th packet where the plain version would take
     over HOLD_BUDGET_S); the four strategies without GI agree on the
     1080p mean; the weights stay in [0, 1] off the emitters; 64x32
     naive and NEE-MIS frames, and a NEE-MIS frame of the clustered
     terrain_scene(5_000), on cuda and cpu allclose on at least 99% of
     the pixels.
     Then [demo], the demo asset (assets/demo: 78 triangles, all six Pc
     material classes, diffuse, specular and normal maps, the env.pfm
     sky) loaded on the card through the port's loader: 78 triangles
     through K1/K2, three 64x64 textures, a valid light CDF; 4 ReSTIR
     frames at 1920x1080 after a warm-up (the golden's flags: m_area 2,
     m_brdf 1, temporal, 5-neighbour pairwise spatial, the sky), 29
     traced rays per pixel, ms/frame, Mrays/s and K1/K2/K3 launches per
     frame, and the textures and sky alone (CUDA events); one NEE-MIS
     1080p frame; K1, K2 and K3 against their plain versions on one
     demo frame's own G-buffer query, first shadow query and spatial
     gather (ids, masks, t/u/v and taps bit-identical), as on Cornell;
     the CLI with the argv of tests/test_demo_asset.py on
     cuda (mean within 2%, 4x4 region means within 0.04 of its golden,
     decoded by the port's PNG reader) and on cpu (the [cross-device]
     tolerance); value_and_grad at 64x32 on cuda and cpu w.r.t. the
     demo's texels (one ReSTIR frame) and the TS panel's roughness (one
     NEE-MIS frame of tests/test_diff_glossy.py's setup_ts scene), and
     K4 against its plain versions on the cuda texel step's own
     cotangents; beyond the demo's path, the demo forced to the
     clustered backend, K5/K6 against their plain versions on its 1080p
     queries.
  5. the same port at 64x32 for 4 frames on cuda and on cpu (plain
     versions): image means within 3 combined standard errors, fewer than
     1% of reservoirs holding a different sample.
  6. the differentiable path: the JAX bench's forward+backward step,
     value_and_grad of mean(img^2) w.r.t. diffuse, specular, shininess and
     emission through one bench-config frame (seed 1, fresh state) at
     1920x1080; 28 traced rays/pixel, finite gradients, K1-K4 all
     launched; ms/step, Mrays/s fwd+bwd and peak device memory printed.
  7. value and gradients at 64x32 on cuda and on cpu, allclose.
  8. 3 Adam steps of optimize_materials at 1080p from a perturbed white
     albedo against the render with the true one: the loss must fall.
  9. the clustered scenes, terrain100k (terrain_scene(100_000), the JAX
     bench's terrain camera) and lights1k (many_lights_scene(1000)): phase
     5 for each (2 frames for these two), then the main path at 1920x1080
     for 4 frames after a warm-up, every scene query through K5/K6 (one
     launch per chunk of every logged query), K1 on the emissive subset;
     then phase 7 on terrain100k.
 10. the Woop variant (ptrace_mxu): phase 5 on terrain20k-128
     (terrain_scene(20_000) rebuilt at cluster size 128: the plain K7/K8
     on the CPU make terrain100k too slow there), then the main path on
     terrain100k-128 at 1920x1080 for 4 frames after a warm-up, every
     scene query through K7/K8 and none through K5/K6; then the same
     frames without ptrace_mxu (K5/K6) for comparison.
 11. the CLI frame loop in-process, `tpu_restir_torch.cli.main` on
     terrain100k at 1920x1080 with temporal and pairwise spatial reuse,
     --denoise and --profile-passes, 8 frames with a checkpoint, then 4
     more resumed from it: the PNG, the sidecar in the reference's layout
     with 12 iterations and the pass times, a finite denoised display
     that differs from the raw one; then ms/frame of the bench frame on
     terrain100k with and without the denoiser, and the SVGF temporal
     update and filter of one 1080p frame timed alone (CUDA events).
 12. [dist], row-sharded rendering (tpu_restir_torch.dist): the kernels
     built first, DIST_RANKS = 2 ranks spawned on the one card under gloo
     (NCCL refuses two ranks on one device), which stages every buffer
     through host memory; 3 sharded Cornell bench frames at 1920x1080
     (540-row shards, halo 7 at radius 30), the launch counts zeroed
     before them and read after (K1, K2, K3 each launched on each rank),
     equal bit for bit to the one-device frames on the same card; on
     each rank's own queries of those frames, the ranks in turn, K1 (its
     G-buffer query), K2 (its first shadow query), K3 at top = halo (its
     spatial payload and taps) and K3 on its first temporal tap into the
     halo-extended payload, each bit-identical to its plain version; a
     sharded fwd+bwd
     step against the one-device step (loss rtol 1e-5, gradients rtol
     2e-4 and atol 1e-6, as tests/test_sharded_diff.py); the all-gather
     fallback at 64x8 (4-row shards) and one lights1k frame (its shards
     unswizzled) equal to one device, with K5/K6 held to their plain
     versions on each rank's own packets of it; the backend, the bytes sent
     and staged a frame a rank, ms/frame a rank and of one device, and the
     fwd+bwd step's ms, labelled as ranks sharing one card, not a scaling
     figure; the CLI with --devices 2 where the machine has two cards.
 13. [backends], the JAX package's fallback intersection backends
     (render/intersect.py, plain tensor code; no kernel of theirs), each
     forced through IntersectorConfig(backend=...) in one 1920x1080 bench
     frame (28.0 traced rays per pixel): brute and woop_mxu on Cornell,
     cluster, fcluster and bvh on lights1k; each frame's G-buffer query and
     first shadow query held to the kernels on the same rays: woop_mxu to
     K1/K2 (masks equal, ids equal but for near ties, counted; t/u/v on
     equal ids bit-identical), brute to K1/K2 (its hits a subset of K1's;
     every difference a ray whose Woop winner, or every Woop hit, lies
     within the 1e-5 slack of an edge), cluster to K5/K6 (a superset, the
     differences likewise), fcluster and bvh to K5/K6 (masks equal, ids
     but for exact-t ties, t bit-identical to K5's and to brute's); at full
     scale fcluster on terrain100k's G-buffer and first shadow query and bvh
     on terrain_scene(20_000)'s G-buffer query, held to K5/K6; gradients
     of a 64x32 G-buffer query under brute (Cornell) and fcluster
     (lights1k), cuda against cpu within rtol 1e-4 + 1e-5 of the largest
     entry. Each run prints its ms (CUDA events after a synchronize), peak
     memory, host syncs (`sync.*` of tracing.COUNTS) and the query census of
     roofline.summarize_query_log (its recorded `rays.` counts); the
     collapse of terrain100k's wide BVH is timed on the host. Its kernel
     launches are not in the JSON line.
 14. [tools], the JAX system's profilers and scaling bench as the port
     has them (`tpu_restir_torch.tools`): profile_ptrace and
     profile_phase1 on terrain100k's 1080p primary-ray query (the phase
     split, the shortlist counts and rounds; phase 1's alternatives and
     how far their slots agree with `build_shortlists`), scaling_bench
     with 2 ranks sharing the card at 1920x1080 (t1 against tN, the halo
     bytes by the JAX formula and as sent).
 15. [bench], the port's measuring entry points: `tpu_restir_torch.bench`
     in this process (bench.py's configuration: 8 chained Cornell frames,
     3 fwd+bwd steps, 4 chained frames each of lights1k and terrain100k,
     and terrain1M, terrain_scene(1_000_000), in the bench's child
     process `tools.bench_terrain1m`), the launch counts zeroed before it
     and read after it (K1-K6 launched, K7/K8 not); its JSON line parsed:
     bench.py's keys and metric, 28.0 traced rays per pixel (the analytic
     count) on Cornell, lights1k, terrain100k and terrain1M, no "failed:"
     entry; finite frames and step; terrain1M at factor 4, cull mode 5 on
     per-cluster boxes, its child loading the kernels this process built;
     then terrain1M built here: K5 on its frame's G-buffer query and K6 on
     its first shadow query and on the G-buffer rays as occlusion rays
     held to their plain versions (0 mismatches, t/u/v bit-identical),
     with their bounds at factor 4 (each distinct (ray, cluster) pair of
     the supercluster expansion once, slab-aware in cull mode 5),
     and phase 1 (`cluster_trace.pack`) alone on those rays, its ms and
     transient memory; then `tools.roofline_frame` once (per-pass ms and
     model lines of cornell, lights1k and terrain100k).
 16. one JSON line of kernel results (K1-K8; K5/K6 launches are those of
     the two clustered paths, K7/K8's those of the Woop path; K1-K4 also
     carry demo_launches, per demo ReSTIR frame and, for K4, per 64x32
     texel step; every kernel dist_launches, rank 0's over the 3 sharded
     frames, K3 dist_ms, its time at top = halo on rank 0, and every
     kernel bench_launches, those of the [bench] run), then
     {"ok": true, "device": ...}.

--profile=PATH also profiles two 1080p frames, one 1080p fwd+bwd step
and one 1080p frame of each clustered scene, terrain100k-128 under
ptrace_mxu included (torch.profiler), and writes
the tables of device time by kernel to PATH and to PATH with _fwd_bwd,
_terrain100k, _lights1k and _terrain100k-128 before its extension; and
one NEE-MIS 1080p frame, its device time split into the threefry draws,
calc_i_m, K1/K2 and the rest (PATH with _nee).

The script imports nothing of JAX or of the JAX package (tpu_restir),
and checks so at its end, after the CLI has exported.
"""

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import socket
import statistics
import struct
import sys
import tempfile
import time

WIDTH, HEIGHT = 1920, 1080
N_FRAMES = 8
SMALL_W, SMALL_H, SMALL_FRAMES = 64, 32, 4
LARGE_FRAMES = 4          # timed frames per clustered scene, after 1 warm-up
CLUSTER_SMALL_FRAMES = 2  # 64x32 frames of a clustered scene, cuda and cpu
CLI_FRAMES, CLI_RESUMED = 8, 4   # CLI frames, then frames resumed from them

# the bench configuration, its cameras ((view_from, view_at): the Cornell
# camera and the terrain camera), scenes and forward+backward step, and the
# card's name and power limit: one place, tpu_restir_torch/bench.py
from tpu_restir_torch.bench import (  # noqa: E402
    CORNELL_VIEW, SCENES, TERRAIN_VIEW, bench_cfg, gpu_line)

# the card's ceilings and the per-test operation counts (H100 SXM, NVIDIA's
# data sheet at 700 W; the unfused float32 rate, as the ray/triangle
# kernels build with --fmad=false): one place, tpu_restir_torch/roofline.py
from tpu_restir_torch.roofline import (  # noqa: E402
    BOX_BYTES, FP64_OPS_PER_S, HBM_BYTES_PER_S, IBETA_LANE_BYTES,
    IBETA_LANE_OPS, KEY_AXIS_OPS, KEY_BYTES, KEY_PAIR_OPS, KEY_RAY_OPS,
    KEY_SLICE_OPS, KEY_SPAN0_AXIS_OPS, MT_OPS, MT_U_OPS, RAY_BYTES,
    SAFE_INV_OPS, SLAB_OPS, WOOP_OPS, WOOP_T_OPS, WOOP_TU_OPS, KernelSpec)

BARY_EPS = 1e-5   # the Woop test's slack (kernels/ray_tri.py)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by) of n_bytes moved and n_ops float32 operations,
    at the ceilings of roofline.py."""
    spec = KernelSpec("", float(n_ops), float(n_bytes))
    return spec.sol_time_s() * 1e3, spec.bound


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# The operations a query's data needs, counted per (ray, row) from the
# plain versions on the query's own inputs: a row's test is charged only as
# far as it must run before one of its parts rules the row out, as the
# kernels' warp skips stop it (K1, K5), and the whole test otherwise.

def woop_row_ops(t, u, ok, tn, tf, best=None):
    """Operations per (ray, row) of Woop tests, rows along dim 1 in their
    fold order (t, u, ok as `_woop_tuvok` gives them; tn, tf and best with
    a singleton there): the t half of every row; u where t is finite and
    within [tn, tf] (closest hit: also below the ray's least hit t so far,
    best before the first row); v and the rest where u alone does not rule
    a hit out (u >= -1e-5 and fl(u - 1e-5) <= 1 + 1e-5: with v >= -1e-5,
    fl(u + v) >= fl(u - 1e-5), as rounding is monotone)."""
    import torch
    keep = torch.isfinite(t) & (t >= tn) & (t <= tf)
    if best is not None:
        run = torch.cummin(torch.where(ok, t, math.inf), 1).values
        keep &= t < torch.minimum(
            best, torch.cat([torch.full_like(run[:, :1], math.inf),
                             run[:, :-1]], 1))
    u_ok = keep & (u >= -BARY_EPS) & (u - BARY_EPS <= 1.0 + BARY_EPS)
    return WOOP_T_OPS + (WOOP_TU_OPS - WOOP_T_OPS) * keep.long() \
        + (WOOP_OPS - WOOP_TU_OPS) * u_ok.long()


def mt_det(tr, dx, dy, dz):
    """det = e1 . (d x e2) of `cluster_trace._mt` in its operation order,
    triangles tr (A, B, 9) against ray directions (A, 1, P) -> (A, B, P)."""
    e1x, e1y, e1z = tr[..., 3:4], tr[..., 4:5], tr[..., 5:6]
    e2x, e2y, e2z = tr[..., 6:7], tr[..., 7:8], tr[..., 8:9]
    return e1x * (dy * e2z - dz * e2y) + e1y * (dz * e2x - dx * e2z) \
        + e1z * (dx * e2y - dy * e2x)


def mt_row_ops(u, det):
    """Operations per (ray, row) of Moller-Trumbore tests (`_mt`'s u and
    mt_det): the half through u of every row; q, v, t and the rest where
    |det| > 1e-18 and 0 <= u <= 1, which every hit needs (with v >= 0,
    fl(u + v) >= u)."""
    ok = (det.abs() > 1e-18) & (u >= 0.0) & (u <= 1.0)
    return MT_U_OPS + (MT_OPS - MT_U_OPS) * ok.long()


def ray_tri_ops(w, o, d, tn, tf, occ=None):
    """Operations per ray (R,) that K1's closest-hit query (occ None) or
    K2's any-hit query (occ: its result) needs against the Woop rows w in
    triangle order: a dead ray (tfar < tnear) none; an occluded ray one
    whole test; a live ray of closest hit, or a visible one of any hit,
    every row by woop_row_ops."""
    import torch

    from tpu_restir_torch.kernels import ray_tri
    n = o.shape[0]
    ops = torch.zeros((n,), dtype=torch.int64, device=o.device)
    need = tf >= tn if occ is None else (tf >= tn) & ~occ
    for s in range(0, n, ray_tri._REF_CHUNK):
        e = min(n, s + ray_tri._REF_CHUNK)
        t, u, _v, ok = ray_tri._woop_tuvok(o[s:e], d[s:e], tn[s:e],
                                           tf[s:e], w)
        best = None if occ is not None \
            else torch.full_like(t[:, :1], math.inf)
        rows = woop_row_ops(t, u, ok, tn[s:e, None], tf[s:e, None], best)
        ops[s:e] = torch.where(need[s:e], rows.sum(1), 0)
    if occ is not None:
        ops += WOOP_OPS * occ.long()
    return ops


def path_rays_per_pixel(cfg):
    """Traced rays per pixel of one naive or NEE frame: every bounce
    traces the whole wavefront, so the naive tracer's B + 1 closest-hit
    queries; NEE traces (B + 1 with GI, else 1) vertices of 1 closest hit
    and r direct-light rays each (r = 1 for area, BRDF and RIS, 2 for MIS,
    0 without direct light)."""
    b = cfg.params.max_bounce_count
    if cfg.integrator == "naive":
        return b + 1
    r = (2 if cfg.direct_strategy == "mis" else 1) if cfg.nee_calc_di else 0
    return (b + 1 if cfg.nee_calc_gi else 1) * (1 + r)


def cuda_ms(fn, reps, windows=3):
    """Milliseconds of one fn() on the device: after a warm-up run, reps
    runs enqueued back to back between two CUDA events, so the device does
    not wait on the host between them; the median over `windows` such
    windows of their mean."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def phase_device():
    import torch
    require(torch.cuda.is_available(),
            "CUDA is not available; this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = gpu_line()
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    return torch.device("cuda:0"), name, smi


def phase_build():
    """The five CUDA libraries (one nvcc each, all started together) and
    the host BVH builder of the clustered scenes (g++)."""
    from tpu_restir_torch.accel import bvh
    from tpu_restir_torch.kernels import build
    t0 = time.perf_counter()
    build.load_kernels()
    total = time.perf_counter() - t0
    t1 = time.perf_counter()
    bvh._lib()
    print(f"[build] BVH builder (g++ {' '.join(bvh.FLAGS)}): "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    for name, info in build.BUILD_INFO.items():
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln]
        print(f"[build] {name}: {info['seconds']:.1f} s; "
              + ("; ".join(regs) or "cached"), flush=True)
    print(f"[build] total {total:.1f} s", flush=True)


def _random_rays(gen, n, dev):
    import torch
    o = torch.rand((n, 3), generator=gen, device=dev) \
        * torch.tensor([2.0, 2.0, 2.0], device=dev) \
        - torch.tensor([1.0, 1.0, 0.0], device=dev)
    d = torch.randn((n, 3), generator=gen, device=dev)
    return o, d / d.norm(dim=-1, keepdim=True)


@contextlib.contextmanager
def capture_first(module, name, keep, got):
    """Wraps module.name for the block: the arguments of its first call
    that `keep` accepts are cloned into got[name]."""
    import torch
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        if name not in got and keep(*args):
            got[name] = tuple(a.detach().clone() if torch.is_tensor(a)
                              else a for a in args)
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield got
    finally:
        setattr(module, name, orig)


def capture_queries(scene, cfg, dev):
    """The inputs of K1, K2 and K3 on the main path, from one frame of
    cfg: the first full-frame closest-hit query (the G-buffer's primary
    rays) and shadow query, each (o, d, tnear, tfar), and the spatial
    pass's gather (payload, tys, txs, r) -> dict keyed "closest_hit",
    "any_hit", "gather_local"."""
    from tpu_restir_torch.kernels import local_gather as lg
    from tpu_restir_torch.kernels import ray_tri
    n = cfg.camera.width * cfg.camera.height
    k = cfg.restir.spatial_neighbor_count
    got = {}
    with capture_first(ray_tri, "closest_hit",
                       lambda sc, o, *_: o.shape[0] == n, got), \
            capture_first(ray_tri, "any_hit",
                          lambda sc, o, *_: o.shape[0] == n, got), \
            capture_first(lg, "gather_local",
                          lambda payload, tys, *_: tys.shape[0] == k, got):
        run_frames(scene, cfg, dev, 1)
    want = {"closest_hit", "any_hit", "gather_local"}
    require(set(got) == want, f"a {cfg.camera.width}x{cfg.camera.height} "
            f"frame made no full-frame query of kind {want - set(got)}")
    return {"closest_hit": got["closest_hit"][1:5],
            "any_hit": got["any_hit"][1:5],
            "gather_local": got["gather_local"][:4]}


def recorder(results):
    """record(name, err, ms, plain_ms, bnd, library_ms=None) into the
    kernels line's entries: the largest error over a kernel's checks,
    the times and bound of its first one."""
    def record(name, err, ms, plain_ms, bnd, library_ms=None):
        e = results.setdefault(name, {"max_abs_err": 0.0, "ms": ms,
                                      "plain_ms": plain_ms,
                                      "bound_ms": bnd[0], "bound_by": bnd[1],
                                      "library_ms": library_ms})
        e["max_abs_err"] = max(e["max_abs_err"], err)
    return record


def check_closest(label, sc, o, d, tn, tf, record):
    """K1 against closest_hit_ref on one query: 0 id mismatches, t/u/v
    bit-identical; times and the bound of what the query needs."""
    import torch

    from tpu_restir_torch.kernels import ray_tri
    w = ray_tri.woop_rows(sc)
    got = ray_tri.closest_hit(sc, o, d, tn, tf)
    want = ray_tri.closest_hit_ref(w, o, d, tn, tf)
    torch.cuda.synchronize()
    tri_mis = int((got[3] != want[3]).sum())
    hit = want[3] >= 0
    err = max(float((g[hit] - p[hit]).abs().max()) if hit.any() else 0.0
              for g, p in zip(got[:3], want[:3]))
    ms = cuda_ms(lambda: ray_tri.closest_hit(sc, o, d, tn, tf), 10)
    plain = cuda_ms(lambda: ray_tri.closest_hit_ref(w, o, d, tn, tf), 3)
    # for comparison, the whole test on every (live ray, triangle)
    n_live = int((tf >= tn).sum())
    n_bytes = o.shape[0] * (RAY_BYTES + 16) + w.shape[0] * 48
    bnd = bound(n_bytes, int(ray_tri_ops(w, o, d, tn, tf).sum()))
    whole = bound(n_bytes, n_live * w.shape[0] * WOOP_OPS)
    print(f"[K1 closest_hit] {label}: {o.shape[0]} rays x "
          f"{w.shape[0]} tris; tri mismatches {tri_mis} (must be 0); "
          f"hits {int(hit.sum())}; max |t,u,v err| {err:.3g} "
          f"(tolerance 0: bit-identical); kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}; operations "
          f"counted per (ray, row); {whole[0]:.3f} ms with the whole "
          f"test on every pair), bound/kernel {bnd[0] / ms:.2f}",
          flush=True)
    require(tri_mis == 0, f"K1 {label}: triangle ids differ")
    require(err == 0.0, f"K1 {label}: t/u/v differ by {err}")
    record("closest_hit", err, ms, plain, bnd)


def check_any(label, scene, o, d, tn, tf, record):
    """K2 against any_hit_ref on one query: 0 mask mismatches; times and
    the bound of what the query needs."""
    import torch

    from tpu_restir_torch.kernels import ray_tri
    n = o.shape[0]
    w = ray_tri.woop_rows(scene)
    got = ray_tri.any_hit(scene, o, d, tn, tf)
    want = ray_tri.any_hit_ref(w, o, d, tn, tf)
    torch.cuda.synchronize()
    mis = int((got != want).sum())
    ms = cuda_ms(lambda: ray_tri.any_hit(scene, o, d, tn, tf), 10)
    plain = cuda_ms(lambda: ray_tri.any_hit_ref(w, o, d, tn, tf), 3)
    # for comparison, the whole test: a visible live ray against every
    # triangle, an occluded one against one
    visible = int(((tf >= tn) & ~want).sum())
    n_bytes = n * (RAY_BYTES + 1) + w.shape[0] * 48
    bnd = bound(n_bytes, int(ray_tri_ops(w, o, d, tn, tf, want).sum()))
    whole = bound(n_bytes,
                  (visible * w.shape[0] + int(want.sum())) * WOOP_OPS)
    print(f"[K2 any_hit] {label}: {n} rays x {w.shape[0]} tris, "
          f"{int((tf < tn).sum())} dead; mask mismatches {mis} (must be 0); "
          f"occluded {int(want.sum())}, visible {visible}; kernel {ms:.3f} "
          f"ms, plain {plain:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}; "
          f"operations counted per (ray, row); {whole[0]:.3f} ms with the "
          f"whole test on every pair), kernel/bound {ms / bnd[0]:.2f}",
          flush=True)
    require(mis == 0, f"K2 {label}: occlusion masks differ")
    record("any_hit", float((got.float() - want.float()).abs().max()), ms,
           plain, bnd)


def check_gather(label, payload, ty, tx, r, record, top=0):
    """K3 against gather_local_ref: bit-identical; kernel, plain and
    PyTorch-indexing times and the bytes bound. top: the payload row of
    output row 0 (halo rows above a rank's strip)."""
    import torch

    from tpu_restir_torch.kernels import local_gather as lg
    (k, h, w), c = ty.shape, payload.shape[-1]
    got = lg.gather_local(payload, ty, tx, r, top=top)
    want = lg.gather_local_ref(payload, ty, tx)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    # the library call: advanced indexing (int64 indices made first)
    tyl, txl = ty.long(), tx.long()
    ms, library, plain = (
        cuda_ms(fn, 10) for fn in (
            lambda: lg.gather_local(payload, ty, tx, r, top=top),
            lambda: payload[tyl, txl],
            lambda: lg.gather_local_ref(payload, ty, tx)))
    bnd = bound(4 * (payload.numel() + 2 * k * h * w + k * h * w * c), 0)
    print(f"[K3 gather_local] {label}: K={k} r={r} top={top} C={c} "
          f"at {h}x{w} of {payload.shape[0]} payload rows; "
          f"bit-identical {equal}; kernel {ms:.3f} ms, PyTorch indexing "
          f"{library:.3f} ms, plain {plain:.3f} ms, bound {bnd[0]:.3f} ms "
          f"({bnd[1]}), kernel/bound {ms / bnd[0]:.2f}", flush=True)
    require(equal, f"K3 {label}: gather differs from the plain version")
    record("gather_local", err, ms, plain, bnd, library)


def phase_kernels(dev):
    """Kernel vs plain version on the card; returns the JSON entries."""
    import torch

    from tpu_restir_torch import cornell_box, rng
    from tpu_restir_torch.kernels import local_gather as lg
    from tpu_restir_torch.kernels import ray_tri
    from tpu_restir_torch.render import camera as cam_mod
    gen = torch.Generator(device=dev)
    gen.manual_seed(20260)
    scene = cornell_box(dev)
    cfg = bench_cfg(WIDTH, HEIGHT)
    n = WIDTH * HEIGHT
    results = {}
    record = recorder(results)

    # K1: primary rays of the bench camera, and the emissive subset
    ys, xs = torch.meshgrid(torch.arange(HEIGHT, device=dev),
                            torch.arange(WIDTH, device=dev), indexing="ij")
    cam = cam_mod.make_camera(cfg.camera, dev)
    o, d = cam_mod.generate_rays_at(cam, cfg.camera,
                                    rng.make_frame_seed(0, 0), ys, xs)
    o = o.reshape(-1, 3).contiguous()
    d = d.reshape(-1, 3).contiguous()
    tn = torch.full((n,), cfg.params.tnear_offset, device=dev)
    inf = torch.full((n,), float("inf"), device=dev)
    check_closest("primary rays, 36 tris", scene, o, d, tn, inf,
                  record)
    idx = scene.lights.tri_idx.long()
    sub = dataclasses.replace(scene, tri_v=scene.tri_v[idx],
                              woop=scene.woop[idx])
    ro, rd = _random_rays(gen, n, dev)
    check_closest("emissive subset, random rays, tfar=inf", sub, ro, rd, tn,
                  inf, record)

    # K2: random shadow segments; 10% zero-length (dead: tfar < tnear,
    # direction 0) as phat.py makes for pixels whose f is already 0; then
    # the main path's own query, the first full-frame shadow query of a
    # bench frame
    from tpu_restir_torch import mathx
    a, _ = _random_rays(gen, n, dev)
    b, _ = _random_rays(gen, n, dev)
    b = torch.where((torch.rand((n, 1), generator=gen, device=dev) < 0.1),
                    a, b)
    seg = b - a
    dist = mathx.length(seg)
    sd = mathx.normalize(seg).contiguous()
    tf = (dist - cfg.params.tfar_offset).contiguous()
    frame = capture_queries(scene, cfg, dev)
    for label, rays in (("random shadow segments", (a, sd, tn, tf)),
                        ("bench frame's first shadow query",
                         frame["any_hit"])):
        check_any(label, scene, *rays, record)

    # K3: spatial taps (K=5, r=5, C=24 slim and C=32 full), temporal
    # reprojection taps (K=1, r=8, C=24 and the C=3 position tap); then the
    # spatial pass's own taps and payload of a bench frame
    def taps(k, r):
        ty = ys[None] + torch.randint(-r, r + 1, (k, HEIGHT, WIDTH),
                                      generator=gen, device=dev)
        tx = xs[None] + torch.randint(-r, r + 1, (k, HEIGHT, WIDTH),
                                      generator=gen, device=dev)
        return (ty.clamp(0, HEIGHT - 1).to(torch.int32).contiguous(),
                tx.clamp(0, WIDTH - 1).to(torch.int32).contiguous())

    for label, k, r, c in (("spatial", 5, 5, 24), ("spatial full", 5, 5, 32),
                           ("temporal", 1, 8, 24), ("temporal pos", 1, 8, 3)):
        payload = torch.randn((HEIGHT, WIDTH, c), generator=gen, device=dev)
        check_gather(f"{label}, random taps", payload, *taps(k, r), r, record)
    check_gather("bench frame's spatial pass", *frame["gather_local"],
                 record)

    # K4: the backward of the spatial taps (K=5, r=5, disk_r2=30), taps
    # drawn from the pass's own disk-offset table and clamped to the screen
    from tpu_restir_torch.render.sampling import disk_int_from_uniform
    k4, r4, disk_r2 = 5, 5, 30
    off = disk_int_from_uniform(
        torch.rand((k4, HEIGHT, WIDTH), generator=gen, device=dev), 30.0)
    tys = (ys[None] + off[..., 1]).clamp(0, HEIGHT - 1).to(torch.int32)
    txs = (xs[None] + off[..., 0]).clamp(0, WIDTH - 1).to(torch.int32)
    for c in (24, 32):
        gi = torch.randint(-64, 65, (k4, HEIGHT, WIDTH, c), generator=gen,
                           device=dev).to(torch.float32)
        got = lg.scatter_local(gi, tys, txs, r4, disk_r2)
        want = lg.scatter_local_ref(gi, tys, txs)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        gn = torch.randn((k4, HEIGHT, WIDTH, c), generator=gen, device=dev)
        got = lg.scatter_local(gn, tys, txs, r4, disk_r2)
        want = lg.scatter_local_ref(gn, tys, txs)
        err = float((got - want).abs().max())
        ordered = bool(torch.equal(got, lg.scatter_local_ordered_ref(
            gn, tys, txs, r4, disk_r2)))
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        ms = cuda_ms(lambda: lg.scatter_local(gn, tys, txs, r4, disk_r2), 10)
        plain = cuda_ms(lambda: lg.scatter_local_ref(gn, tys, txs), 10)
        # the library call: index_add of the cotangents into a zero payload
        flat = (tys.long() * WIDTH + txs.long()).reshape(-1)
        zero = torch.zeros((HEIGHT * WIDTH, c), device=dev)
        src = gn.reshape(-1, c)
        library = cuda_ms(lambda: torch.index_add(zero, 0, flat, src), 10)
        bnd = bound(4 * (k4 * HEIGHT * WIDTH * c + 2 * k4 * HEIGHT * WIDTH
                         + HEIGHT * WIDTH * c), 0)
        print(f"[K4 scatter_local] spatial taps: K={k4} r={r4} "
              f"disk_r2={disk_r2} C={c} at {HEIGHT}x{WIDTH}; integer "
              f"cotangents bit-identical {equal}; normal cotangents max "
              f"|err| {err:.3g} (tolerance 1e-5: the plain index_add_ sums "
              f"in atomic order), bit-identical to the sum in the kernel's "
              f"order {ordered}, sha256 {digest}; kernel {ms:.3f} ms, plain "
              f"{plain:.3f} ms, "
              f"PyTorch index_add {library:.3f} ms, bound {bnd[0]:.3f} ms "
              f"({bnd[1]})", flush=True)
        require(equal, f"K4 C={c}: differs from the plain version on "
                "integer cotangents")
        require(err <= 1e-5, f"K4 C={c}: max error {err}")
        require(ordered, f"K4 C={c}: differs from the sum in its order")
        record("scatter_local", err, ms, plain, bnd, library)
    check_ibeta(gen, dev, record)
    return results


def check_ibeta(gen, dev, record):
    """K10 against `_ibeta_value` on one 1080p call: cos(theta) uniform in
    [0, 1), shininess uniform in [0, 128) (both sides of the symmetry
    swap), b = 1/2 broadcast, the operands as calc_i_m hands them over."""
    import torch

    from tpu_restir_torch import tracing
    from tpu_restir_torch.kernels import ibeta as k10
    from tpu_restir_torch.mathx import special
    n = WIDTH * HEIGHT
    cost = torch.rand((HEIGHT, WIDTH), generator=gen, device=dev)
    shin = torch.rand((HEIGHT, WIDTH), generator=gen, device=dev) * 128.0
    x, a, b = special.ibeta_operands(1.0 - cost * cost, 0.5 * shin, 0.5)
    before = tracing.COUNTS["launch.ibeta"]
    got = k10.ibeta(x, a, b)
    want = special._ibeta_value(x, a, b)
    torch.cuda.synchronize()
    require(tracing.COUNTS["launch.ibeta"] == before + 1,
            "K10: not one launch a call")

    def differ(g, w, ints):
        return int(((g.view(ints) != w.view(ints))
                    & ~(torch.isnan(g) & torch.isnan(w))).sum())

    d64 = differ(got, want, torch.int64)
    g32, w32 = got.to(torch.float32), want.to(torch.float32)
    d32 = differ(g32, w32, torch.int32)
    both_nan = torch.isnan(g32) & torch.isnan(w32)
    ulps = int(torch.where(both_nan, 0, (g32.view(torch.int32).long()
                                         - w32.view(torch.int32).long())
                           .abs()).max())
    err = float((g32 - w32).abs().max())
    ms = cuda_ms(lambda: k10.ibeta(x, a, b), 20)
    plain = cuda_ms(lambda: special._ibeta_value(x, a, b), 3)
    bnd_ops = n * IBETA_LANE_OPS / FP64_OPS_PER_S * 1e3
    bnd_bytes = n * IBETA_LANE_BYTES / HBM_BYTES_PER_S * 1e3
    bnd = (bnd_ops, "operations") if bnd_ops >= bnd_bytes \
        else (bnd_bytes, "bytes")
    i_m = cuda_ms(lambda: special.calc_i_m(cost, shin), 20)
    saved = k10.ibeta
    k10.ibeta = special._ibeta_value
    try:
        i_m_plain = cuda_ms(lambda: special.calc_i_m(cost, shin), 3)
    finally:
        k10.ibeta = saved
    print(f"[K10 ibeta] {HEIGHT}x{WIDTH} lanes, a = shininess / 2 in "
          f"[0, 64), b = 1/2 broadcast: lanes differing from the plain "
          f"version {d64} in float64, {d32} in float32 (max {ulps} ulp, "
          f"|err| {err:.3g}); kernel {ms:.3f} ms, plain {plain:.3f} ms, "
          f"bound {bnd[0]:.3f} ms ({bnd[1]}: {IBETA_LANE_OPS} FP64 "
          f"instructions a lane); calc_i_m whole {i_m:.3f} ms, with the "
          f"plain chain {i_m_plain:.3f} ms", flush=True)
    require(ulps <= 1, f"K10: {d32} float32 lanes differ, up to {ulps} ulp")
    record("ibeta", err, ms, plain, bnd)


_SCENES = {}


def _woop_rebuild(scene, device):
    """A clustered scene's triangles rebuilt at cluster size 128 (the Woop
    blocks of ptrace_mxu), as tests/test_ptrace.py rebuilds its terrain."""
    from tpu_restir_torch.scene.procedural import TERRAIN_SPECS
    from tpu_restir_torch.scene.scene import build_scene
    return build_scene(scene.tri_v.cpu().numpy(), scene.tri_mat.cpu().numpy(),
                       TERRAIN_SPECS, device, cluster_size=128)


def large_scene(label, dev):
    """terrain100k (terrain_scene(100_000), the bench's terrain camera),
    lights1k (many_lights_scene(1000), the Cornell camera), or the Woop
    variant's terrain100k-128 / terrain20k-128 (the terrain rebuilt at
    cluster size 128), built once per device -> (scene, camera view)."""
    import torch

    from tpu_restir_torch.scene.procedural import terrain_scene
    key = (label, str(torch.device(dev)))
    if key not in _SCENES:
        build, view = {
            "terrain100k": SCENES["terrain100k"],
            "lights1k": SCENES["lights1k"],
            "terrain100k-128": (lambda d: _woop_rebuild(
                large_scene("terrain100k", d)[0], d), TERRAIN_VIEW),
            "terrain20k-128": (lambda d: _woop_rebuild(
                terrain_scene("cpu", 20_000), d), TERRAIN_VIEW)}[label]
        t0 = time.perf_counter()
        scene = build(torch.device(dev))
        if key[1] != "cpu":
            print(f"[scene] {label}: {scene.num_tris} triangles, "
                  f"{scene.cluster_tris.shape[0]} clusters of "
                  f"{scene.cluster_size}, {scene.lights.count} lights; built "
                  f"in {time.perf_counter() - t0:.1f} s", flush=True)
        _SCENES[key] = (scene, view)
    return _SCENES[key]


@contextlib.contextmanager
def packets_of(n, mxu, got):
    """Wraps the clustered kernels' wrappers for the block: the packed
    rays of the first closest-hit and the first any-hit query of n rays
    into got["closest"] and got["any"]; with mxu, those of the Woop
    kernels' wrappers."""
    from tpu_restir_torch.kernels import cluster_trace as ct
    names = {"closest": "closest_packets", "any": "any_packets"}
    if mxu:
        names = {k: v + "_mxu" for k, v in names.items()}
    orig = {k: getattr(ct, v) for k, v in names.items()}

    def recorder(kind):
        def call(*args):
            pk = args[-1]
            if kind not in got and pk.n_rays == n:
                got[kind] = pk
            return orig[kind](*args)
        return call

    for kind, name in names.items():
        setattr(ct, name, recorder(kind))
    try:
        yield got
    finally:
        for kind, name in names.items():
            setattr(ct, name, orig[kind])


def capture_packets(scene, cfg, dev):
    """The packed rays of two queries of one bench frame: the first
    closest-hit query (the G-buffer's primary rays) and the first any-hit
    query of a whole frame (the area candidate's shadow rays); under
    ptrace_mxu those of the Woop kernels' wrappers."""
    got = {}
    with packets_of(cfg.camera.width * cfg.camera.height,
                    cfg.intersector.ptrace_mxu, got):
        run_frames(scene, cfg, dev, 1)
    require(set(got) == {"closest", "any"},
            f"a 1080p frame made no full-frame query of kind "
            f"{ {'closest', 'any'} - set(got)}")
    return got["closest"], got["any"]


def distinct_slots(pk, c):
    """The (packet, cluster) pairs that the shortlists of packets pk list
    in a scene of c clusters, slot by slot in order, at most
    `_REF_PACKETS` packets at a time: yields (packets (A,), shortlist
    position q, clusters (A,)). Slot j of a packet lists supercluster
    q = j // F and cluster min(sl[q] F + j % F, c - 1), as the kernels and
    `cluster_trace._slots` expand it; a slot that the clamp makes repeat
    the last cluster (where c is not a multiple of F) is left out, so each
    distinct pair comes once: the repeats are the kernels' overhead, not
    work the query needs. At factor 1, the listed slots themselves."""
    import torch

    from tpu_restir_torch.kernels import cluster_trace as ct
    f = pk.factor
    n_slots = int(pk.count.max()) * f if pk.count.numel() else 0
    for j in range(n_slots):
        q, r = divmod(j, f)
        act = pk.count > q
        if f > 1:
            act &= pk.shortlist[:, q] * f + r < c
        act = torch.nonzero(act)[:, 0]
        for k in range(0, act.shape[0], ct._REF_PACKETS):
            a = act[k:k + ct._REF_PACKETS]
            sc = pk.shortlist[a, q].long()
            yield a, q, sc if f == 1 else sc * f + r


def listed_clusters(pk, c):
    """(Rp, S) int64: the distinct clusters that each shortlist entry of
    packets pk lists in a scene of c clusters (F, fewer for the last
    supercluster where c is not a multiple of F; 1 at factor 1), 0 past a
    packet's count."""
    import torch
    f = pk.factor
    n = torch.clamp(c - pk.shortlist.long() * f, max=f)
    listed = torch.arange(pk.shortlist.shape[1], device=n.device)[None] \
        < pk.count[:, None]
    return torch.where(listed, n, 0)


def closest_pairs(pk, t, c):
    """(per ray, per packet): the (live ray, cluster) pairs that a
    closest-hit query of a scene of c clusters needs, whose result has
    the t given; a cluster's entry distance is that of its shortlist entry
    (its supercluster's at factor F > 1), and each distinct cluster counts
    once (`distinct_slots`). Per ray: each live ray against the listed
    clusters whose entry distance is at most its own min(t, tfar), the
    least any front-to-back traversal of these shortlists must test. Per
    packet: every live ray of a packet against the listed clusters whose
    entry is within the packet's largest min(t, tfar), the count of a
    traversal that stops per packet."""
    import torch

    from tpu_restir_torch.kernels import cluster_trace as ct
    rp = pk.count.shape[0]
    live = (pk.tfar >= pk.tnear).view(rp, ct.P)
    count = pk.count.long()
    reach = torch.minimum(t.view(rp, ct.P), pk.tfar.view(rp, ct.P))
    n = listed_clusters(pk, c)
    # entries ascend along a row (+inf past count): a searchsorted count
    # of the entries within reach, then the clusters those entries list
    within = torch.minimum(
        torch.searchsorted(pk.entry, reach.contiguous(), right=True),
        count[:, None])
    upto = torch.cat([n.new_zeros((rp, 1)), n.cumsum(1)], 1)
    per_ray = int(torch.where(live, upto.gather(1, within), 0).sum())
    top = torch.where(live, reach, -float("inf")).amax(1)
    needed = torch.where(pk.entry <= top[:, None], n, 0).sum(1)
    per_packet = int((live.sum(1) * needed).sum())
    return per_ray, per_packet


def trace_ops(kind, scene, pk, out, slab=False):
    """Operations per ray (Rp*P,) that a clustered query needs, from the
    plain test over the distinct listed clusters in shortlist order
    (`distinct_slots`; at factor F > 1 a cluster's entry distance is its
    supercluster's): closest hit, each live ray every row of the listed
    clusters whose entry is within its own min(t, tfar) at the end (as
    `closest_pairs` counts them); any hit, each visible live ray every row
    of every listed cluster, each occluded ray one whole test; a dead ray
    none. Rows by mt_row_ops, or woop_row_ops under ptrace_mxu (closest
    hit: the least hit t carried from slot to slot). slab (cull mode 5:
    K5, K6 and K8 above 64 clusters): a ray that would test a cluster pays its
    reciprocal direction once and one box test (SLAB_OPS) per such
    cluster, and the rows of only the clusters whose cull box
    `slab_live_ref` leaves it, since the slab test rules the others out
    (upper: tfar for any hit, min(t, tfar) for closest hit); the boxes are
    those the kernels cull on (`cull_boxes`)."""
    import torch

    from tpu_restir_torch.kernels import cluster_trace as ct
    woop = kind.endswith("_mxu")
    closest = kind.startswith("trace_closest")
    blocks = scene.cluster_woop if woop else scene.cluster_tris
    rp = pk.count.shape[0]
    *ray, tn, tf = ct._packet_rays(pk)                 # each (rp, 1, P)
    need = (pk.tfar >= pk.tnear).view(rp, 1, ct.P)
    if closest:
        reach = torch.minimum(out[0], pk.tfar).view(rp, 1, ct.P)
        best = torch.full((rp, 1, ct.P), math.inf, device=pk.o.device)
    else:
        need = need & ~out.view(rp, 1, ct.P)
    ops = torch.zeros((rp, ct.P), dtype=torch.int64, device=pk.o.device)
    if slab:
        o = pk.o.view(rp, 1, ct.P, 3)
        d = pk.d.view(rp, 1, ct.P, 3)
        bmin, bmax, per_cluster = cull_boxes(scene, woop, pk.factor)
        upper = reach if closest else tf
        ops += SAFE_INV_OPS * need.view(rp, ct.P).long()
    for a, q, cl in distinct_slots(pk, blocks.shape[0]):
        tr = blocks[cl]
        r = [x[a] for x in ray]
        slot = need[a]
        if closest:
            slot = slot & (pk.entry[a, q, None, None] <= reach[a])
        if slab:
            box = cl if per_cluster else pk.shortlist[a, q].long()
            ops[a] += SLAB_OPS * slot[:, 0].long()
            slot = slot & ct.slab_live_ref(
                o[a], d[a], tn[a], upper[a], bmin[box, None, None],
                bmax[box, None, None])
        if woop:
            t, u, _v, ok = ct._woop(tr, *r, tn[a], tf[a])
            rows = woop_row_ops(t, u, ok, tn[a], tf[a],
                                best[a] if closest else None)
            if closest:
                best[a] = torch.minimum(
                    best[a], torch.where(ok, t, math.inf).amin(
                        1, keepdim=True))
        else:
            u = ct._mt(tr, *r, tn[a], tf[a])[1]
            rows = mt_row_ops(u, mt_det(tr, *r[3:]))
        ops[a] += torch.where(slot, rows, 0).sum(1)
    if not closest:
        ops += (WOOP_OPS if woop else MT_OPS) * out.view(rp, ct.P).long()
    return ops.reshape(-1)


def cull_boxes(scene, woop, factor=1):
    """The boxes of the mode-5 cull -> (bmin, bmax, per_cluster): the
    cluster AABBs (K5 and K6) while the kernels cull per
    cluster, else the supercluster AABBs (`cluster_trace.cull_boxes`); or
    K8's, the cluster AABBs grown by the Woop test's reach
    (`cluster_trace.woop_cull_boxes`)."""
    from tpu_restir_torch.kernels import cluster_trace as ct
    if woop:
        return (*ct.woop_cull_boxes(scene.cluster_min, scene.cluster_max),
                True)
    return ct.cull_boxes(scene.cluster_min, scene.cluster_max, factor)


def trace_bound(kind, scene, pk, out, slab=False):
    """The bound of a clustered query, from what its data needs: the
    operations of `trace_ops` (slab: in cull mode 5, box tests and the
    rows of slab-live pairs). Bytes: the rays, the outputs, the listed
    shortlist entries (id and entry distance) and every cluster block
    once. -> ((bound_ms, bound_by), {what: (count, bound)}) where the
    second part holds for comparison the bound of the rows of every needed
    pair (with slab: "listed pairs") and the (ray, triangle) pairs that
    the listed count tests, with the whole test on each ("pairs"), and for
    closest hit the same counted per packet ("pairs per packet"). Each
    distinct (ray, cluster) pair counts once at any factor."""
    from tpu_restir_torch.kernels import cluster_trace as ct
    woop = kind.endswith("_mxu")
    if woop:
        rows, whole = ct.WOOP_BLOCK, WOOP_OPS
        block_bytes = scene.cluster_woop[0].numel() * 4
    else:
        rows, whole = scene.cluster_tris.shape[1], MT_OPS
        block_bytes = scene.cluster_tris[0].numel() * 4
    c = scene.cluster_tris.shape[0]
    rp = pk.count.shape[0]
    live = (pk.tfar >= pk.tnear).view(rp, ct.P)
    count = pk.count.long()
    if kind.startswith("trace_closest"):
        per_ray, per_packet = closest_pairs(pk, out[0], c)
        pairs = {"pairs": per_ray * rows, "pairs per packet": per_packet * rows}
        out_bytes = 16
    else:
        occ = out.view(rp, ct.P)
        visible = (live & ~occ).sum(1)
        pairs = {"pairs": int((visible * listed_clusters(pk, c).sum(1))
                              .sum()) * rows + int(occ.sum())}
        out_bytes = 1
    n = pk.o.shape[0]
    n_bytes = n * (RAY_BYTES + out_bytes) + int(count.sum()) * 8 \
        + c * block_bytes
    listed_ops = int(trace_ops(kind, scene, pk, out).sum())
    extra = {k: (v, bound(n_bytes, v * whole)) for k, v in pairs.items()}
    if not slab:
        return bound(n_bytes, listed_ops), extra
    slab_ops = int(trace_ops(kind, scene, pk, out, slab=True).sum())
    return (bound(n_bytes, slab_ops),
            {"listed pairs": (listed_ops, bound(n_bytes, listed_ops)),
             **extra})


def slab_live_share(scene, pk, occ, chunk=16, woop=False):
    """An any-hit query in cull mode 5: (listed (visible live ray,
    cluster) pairs, each distinct cluster once (`distinct_slots`), the
    share of them that the per-ray slab test (`slab_live_ref`, upper =
    tfar, on the boxes the kernel culls on: `cull_boxes`) leaves live, the
    share of them in warps (32 consecutive rays) of which some visible
    ray's test keeps the slot, whose rows K6 and K8 run, and the share in
    slots that some visible ray of the packet keeps, which a block vote
    alone would test whole)."""
    import torch

    from tpu_restir_torch.kernels import cluster_trace as ct
    rp = pk.count.shape[0]
    f = pk.factor
    c = scene.cluster_tris.shape[0]
    o = pk.o.view(rp, 1, ct.P, 3)
    d = pk.d.view(rp, 1, ct.P, 3)
    tn = pk.tnear.view(rp, 1, ct.P)
    tf = pk.tfar.view(rp, 1, ct.P)
    vis = ((pk.tfar >= pk.tnear) & ~occ).view(rp, 1, ct.P)
    bmin, bmax, per_cluster = cull_boxes(scene, woop, f)
    listed_n = live_n = warp_n = kept_n = 0
    n_slots = int(pk.count.max()) * f
    for j0 in range(0, n_slots, chunk):
        js = torch.arange(j0, min(j0 + chunk, n_slots),
                          device=pk.count.device)
        q = js // f
        sc = pk.shortlist[:, q].long()                          # (rp, J)
        cl = sc * f + js % f
        listed = (q[None] < pk.count[:, None]) & (cl < c)
        box = torch.clamp(cl, max=c - 1) if per_cluster else sc
        pairs = vis & listed[..., None]                         # (rp, J, P)
        live = pairs & ct.slab_live_ref(o, d, tn, tf, bmin[box][:, :, None],
                                        bmax[box][:, :, None])
        rp_, j_ = live.shape[:2]
        warp = live.view(rp_, j_, ct.P // 32, 32).any(3, keepdim=True)
        listed_n += int(pairs.sum())
        live_n += int(live.sum())
        warp_n += int((pairs.view(rp_, j_, ct.P // 32, 32) & warp).sum())
        kept_n += int((pairs & live.any(2, keepdim=True)).sum())
    n = max(listed_n, 1)
    return listed_n, live_n / n, warp_n / n, kept_n / n


def _trace_fns(kind, scene):
    """(kernel, plain version) of a clustered query kind, each pk -> out."""
    from tpu_restir_torch.kernels import cluster_trace as ct
    ctris, cmin, cmax = scene.cluster_tris, scene.cluster_min, \
        scene.cluster_max
    cw = scene.cluster_woop
    return {
        "trace_closest": (lambda pk: ct.closest_packets(ctris, cmin, cmax, pk),
                          lambda pk: ct.trace_closest_ref(ctris, pk)),
        "trace_any": (lambda pk: ct.any_packets(ctris, cmin, cmax, pk),
                      lambda pk: ct.trace_any_ref(ctris, pk)),
        "trace_closest_mxu": (lambda pk: ct.closest_packets_mxu(cw, pk),
                              lambda pk: ct.trace_closest_mxu_ref(cw, pk)),
        "trace_any_mxu": (lambda pk: ct.any_packets_mxu(cw, cmin, cmax, pk),
                          lambda pk: ct.trace_any_mxu_ref(cw, pk)),
    }[kind]


def hold_trace(name, scene, kind, label, pk, results):
    """One clustered query (packets pk of scene) through the kernel of
    kind and its plain version: ids and masks equal, t/u/v bit-identical
    (raises otherwise); kernel and plain ms; the bound from what the
    query's data needs (`trace_bound`, slab-aware in cull mode 5, each
    distinct (ray, cluster) pair once at any factor). Adds or updates the
    kernel's JSON entry in results. -> for an any-hit kind, whether the
    query held occluded and visible rays (None for closest hit)."""
    import torch

    from tpu_restir_torch.kernels import cluster_trace as ct
    rp = pk.count.shape[0]
    closest = kind.startswith("trace_closest")
    kernel, plain = _trace_fns(kind, scene)
    got = kernel(pk)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    want = plain(pk)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    live = pk.tfar >= pk.tnear
    if closest:
        mis = int((got[3] != want[3]).sum())
        hit = want[3] >= 0
        n_pos = int(hit.sum())
        err = max(float((g[hit] - w[hit]).abs().max()) if hit.any()
                  else 0.0 for g, w in zip(got[:3], want[:3]))
        what = f"tri mismatches {mis}; hits {n_pos}; max |t,u,v err| " \
            f"{err:.3g} (0 expected: both keep the test's operation " \
            f"order without contractions)"
    else:
        mis = int((got != want).sum())
        n_pos = int(want.sum())
        err = float((got.float() - want.float()).abs().max())
        what = f"mask mismatches {mis}; occluded {n_pos}, visible " \
            f"{int((live & ~want).sum())}"
    ms = cuda_ms(lambda: kernel(pk), 5)
    dead = int((~live[:pk.n_rays]).sum())
    mode = ct.launch_mode(kind, scene.cluster_tris.shape[0], pk.factor)
    slab = mode == 5
    bnd, whole = trace_bound(kind, scene, pk, got, slab=slab)
    extra = ""
    if slab:
        n_listed, b_listed = whole.pop("listed pairs")
        pair = "live ray, cluster within reach" if closest \
            else "visible ray, listed cluster"
        extra = f"; that bound is slab-aware (a box test of {SLAB_OPS} " \
            f"operations a ({pair}) pair, rows only where the ray is " \
            f"slab-live); with the rows of every such pair {n_listed} " \
            f"operations (bound {b_listed[0]:.3f} ms)"
    extra += "; the whole test on every pair: " + ", ".join(
        f"{n} {what} (bound {b[0]:.3f} ms)"
        for what, (n, b) in whole.items())
    if closest:
        staged = staged_slots(lambda: kernel(pk))
        extra += f"; slots staged a packet {staged:.2f} of " \
            f"{float(pk.count.float().mean()) * pk.factor:.2f} given"
    if slab and not closest:
        listed_n, live_share, warp_share, kept_share = slab_live_share(
            scene, pk, want, woop=kind.endswith("_mxu"))
        extra += f"; listed (visible ray, cluster) pairs " \
            f"{listed_n}: slab-live {live_share:.4f}, in warps that " \
            f"test the slot {warp_share:.4f}, in slots the block " \
            f"stages {kept_share:.4f}"
    bound_text = f"bound {bnd[0]:.3f} ms ({bnd[1]}; operations counted " \
        f"per (ray, row), each distinct (ray, cluster) pair once), " \
        f"bound/kernel {bnd[0] / ms:.2f}"
    if kind.endswith("_mxu"):
        # the fused Moller-Trumbore kernel on the same scene and packets
        other = kind[:-4]
        ms_mt = cuda_ms(lambda: _trace_fns(other, scene)[0](pk), 5)
        extra += f"; {other} (K5/K6) on the same packets {ms_mt:.3f} ms"
    print(f"[K5-K8 {kind}] {name} {label}: {pk.n_rays} rays in "
          f"{rp} packets, {dead} dead after the scene-box clamp; C="
          f"{scene.cluster_tris.shape[0]} clusters of "
          f"{scene.cluster_tris.shape[1]}, factor {pk.factor}, S="
          f"{pk.shortlist.shape[1]}, mean shortlist "
          f"{float(pk.count.float().mean()):.1f}, cull mode {mode}; "
          f"the whole query against the plain version: {what} (must be "
          f"0 mismatches); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"{bound_text}{extra}", flush=True)
    require(mis == 0, f"{kind} {name} {label}: kernel and plain version "
            f"differ on {mis} rays")
    if closest:
        require(n_pos > 0, f"{kind} {name} {label}: no ray hit")
    require(err == 0.0, f"{kind} {name} {label}: t/u/v differ by {err}, "
            f"not bit-identical")
    results.setdefault(kind, {"max_abs_err": 0.0, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bnd[0],
                              "bound_by": bnd[1], "library_ms": None})
    if slab and not closest:
        results[kind].setdefault("slab_live_share", live_share)
    results[kind]["max_abs_err"] = max(results[kind]["max_abs_err"], err)
    if not closest:
        return bool(n_pos) and bool((live & ~want).any())
    return None


def staged_slots(fn):
    """Run fn, closest-hit launches; -> the slots they staged a packet
    (the counters `phase2.staged` over `phase2.closest_packets`, recorded
    for the call)."""
    from tpu_restir_torch import tracing
    got = {"phase2.staged": 0.0, "phase2.closest_packets": 0.0}
    with tracing.recording() as rec:
        fn()
    for name, value in rec:
        if name in got:
            got[name] += float(value.sum()) if hasattr(value, "sum") \
                else float(value)
    return got["phase2.staged"] / max(got["phase2.closest_packets"], 1.0)


def key_work(o, d, tnear, tfar, cmin, cmax):
    """K9's run emulated on plain tensors, packed rays o, d (Rp*P, 3),
    tnear, tfar against the boxes cmin, cmax (C, 3): the interval test
    axis by axis up to the first axis after which a pair fails, the slice
    boxes only for a passing pair of a bounded packet and up to the first
    that overlaps -> (key (Rp, C), count (Rp,) int32, operations (Rp,)
    int64 a packet: KEY_AXIS_OPS or KEY_SPAN0_AXIS_OPS an axis tested,
    KEY_SLICE_OPS a slice box tested, KEY_PAIR_OPS a key, KEY_RAY_OPS a
    live ray). Key and count equal `shortlist_keys`' bit for bit
    (tests/test_torch_roofline.py), so the early exits are exact."""
    import torch

    from tpu_restir_torch.accel.fcluster import _packet_bounds
    from tpu_restir_torch.kernels import cluster_trace as ct
    (omin, omax, dmin, dmax, tn, tf, bounded, emin,
     emax) = _packet_bounds(o, d, tnear, tfar, ct.P)
    rp, c = omin.shape[0], cmin.shape[0]
    dev = o.device
    entry = torch.full((rp, c), -ct._BIG, device=dev)
    exit_ = torch.full((rp, c), ct._BIG, device=dev)
    alive = torch.ones((rp, c), dtype=torch.bool, device=dev)
    ops = torch.full((rp, c), KEY_PAIR_OPS, dtype=torch.int64, device=dev)
    for a in range(3):
        spans0, a_entry, a_exit = ct._interval_axis(a, omin, omax, dmin,
                                                    dmax, cmin, cmax)
        ops += torch.where(alive, torch.where(spans0, KEY_SPAN0_AXIS_OPS,
                                              KEY_AXIS_OPS), 0)
        entry = torch.where(alive, torch.maximum(entry, a_entry), entry)
        exit_ = torch.where(alive, torch.minimum(exit_, a_exit), exit_)
        alive &= (entry <= exit_) & (exit_ >= tn[:, None]) \
            & (entry <= tf[:, None])
    boxed = alive & bounded[:, None]
    found = torch.zeros_like(boxed)
    for s in range(emin.shape[1]):
        ops += torch.where(boxed & ~found, KEY_SLICE_OPS, 0)
        found |= ((emin[:, None, s, :] <= cmax[None]) &
                  (emax[:, None, s, :] >= cmin[None])).all(-1)
    passes = alive & (found | ~bounded[:, None])
    key = torch.where(passes, torch.maximum(entry, tn[:, None]), math.inf)
    live = ((tfar >= tnear) & torch.isfinite(o).all(-1)
            & torch.isfinite(d).all(-1)).reshape(rp, ct.P)
    return (key, passes.sum(1, dtype=torch.int32),
            ops.sum(1) + KEY_RAY_OPS * live.sum(1))


def hold_keys(name, scene, label, pk, results):
    """K9 on the rays of one clustered query (packets pk of scene, against
    its (super)cluster boxes) and its plain version `shortlist_keys` on the
    same CUDA tensors: keys equal as int32 bits, counts equal (raises
    otherwise); the kernel's ms, the eager key build's, and the bound from
    what the query's data needs: the operations `key_work` counts, the
    rays and boxes read once, the keys and counts written once. Adds the
    kernel's JSON entry to results on its first check."""
    import torch

    from tpu_restir_torch.kernels import cluster_trace as ct
    scmin, scmax = (x.contiguous() for x in ct._super_boxes(
        scene.cluster_min, scene.cluster_max, pk.factor))
    args = (pk.o, pk.d, pk.tnear, pk.tfar, scmin, scmax)
    key, cnt = ct.packet_keys(*args)
    want_key, want_cnt = ct.shortlist_keys(*args)
    torch.cuda.synchronize()
    key_mis = int((key.view(torch.int32) != want_key.view(torch.int32))
                  .sum())
    cnt_mis = int((cnt != want_cnt).sum())
    ms = cuda_ms(lambda: ct.packet_keys(*args), 5)
    plain_ms = cuda_ms(lambda: ct.shortlist_keys(*args), 1)
    ops = key_work(*args)[2]
    rp, c = key.shape
    n_ops = int(ops.sum())
    n_bytes = (pk.o.shape[0] * RAY_BYTES + rp * c * KEY_BYTES + rp * 4
               + c * BOX_BYTES)
    bnd = bound(n_bytes, n_ops)
    listed = int(want_cnt.sum())
    print(f"[K9 shortlist_keys] {name} {label}: {pk.n_rays} rays in {rp} "
          f"packets x C={c} boxes (factor {pk.factor}); against the plain "
          f"version: keys {key_mis} mismatches as int32 bits, counts "
          f"{cnt_mis} (must be 0 and 0); passing pairs {listed} "
          f"({listed / max(rp * c, 1):.4f}); kernel {ms:.3f} ms, the eager "
          f"key build {plain_ms:.3f} ms; {n_ops} operations "
          f"({n_ops / max(rp * c, 1):.1f} a pair: the interval test to the "
          f"first failing axis, the slice boxes to the first overlap, "
          f"{KEY_RAY_OPS} a live ray) and {n_bytes} bytes: bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}), bound/kernel {bnd[0] / ms:.3f}",
          flush=True)
    require(key_mis == 0 and cnt_mis == 0,
            f"shortlist_keys {name} {label}: kernel and plain version "
            f"differ on {key_mis} keys and {cnt_mis} counts")
    results.setdefault("shortlist_keys", {
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None})


def phase_ptrace_kernels(dev, results,
                         scenes=("terrain100k", "lights1k", "terrain100k-128")):
    """K5-K8 against their plain versions on the card, both on the whole
    of 1080p queries of a bench frame. terrain100k: the G-buffer query
    (K5), the area candidate's shadow query (K6) and the G-buffer rays as
    an occlusion query (K6, cull mode 5: every hit occluded, every sky
    pixel visible); lights1k: its G-buffer and shadow queries;
    terrain100k-128 under ptrace_mxu: the same three queries through K7
    and K8, bit-identical, and K5/K6 timed on the same packets of the same
    scene for comparison. The terrain's shadow queries have no occluded
    ray (the sun stands high above a terrain that cannot shadow itself
    from it), so each any-hit kernel must also be held, on each scene, to a
    query with occluded and visible rays. Then factor 4 against factor 1
    on terrain_scene(20_000). `scenes` picks the scenes whose queries are
    checked. Adds the JSON entries (the first check of each kernel) to
    results."""
    import torch

    from tpu_restir_torch.kernels import cluster_trace as ct
    from tpu_restir_torch.scene.procedural import terrain_scene
    checks = []
    for name in scenes:
        scene, view = large_scene(name, dev)
        mxu = name.endswith("-128")
        closest_pk, any_pk = capture_packets(
            scene, bench_cfg(WIDTH, HEIGHT, view, mxu=mxu), dev)
        sfx = "_mxu" if mxu else ""
        checks += [(name, scene, "trace_closest" + sfx,
                    "G-buffer primary rays", closest_pk),
                   (name, scene, "trace_any" + sfx,
                    "area-candidate shadow rays", any_pk)]
        hold_keys(name, scene, "G-buffer primary rays", closest_pk, results)
        hold_keys(name, scene, "area-candidate shadow rays", any_pk, results)
        if name.startswith("terrain100k"):
            checks.append((name, scene, "trace_any" + sfx,
                           "G-buffer rays as occlusion rays", closest_pk))
    both_sides = set()   # (scene, any-hit kind) held to occluded and visible
    for name, scene, kind, label, pk in checks:
        if hold_trace(name, scene, kind, label, pk, results):
            both_sides.add((name, kind))
    lacking = {(name, kind) for name, _s, kind, _l, _p in checks
               if kind.startswith("trace_any")} - both_sides
    require(not lacking, f"any-hit kernels not held to a query with both "
            f"occluded and visible rays: {sorted(lacking)}")

    # superclusters: factor 4 forced against factor 1 (the closest-hit
    # slab cull, mode 5, on cluster boxes at both; their slot loops
    # differ), and factor 1 held to the plain version on its first
    # packets; random rays, so no exact t ties between clusters, whose
    # order the grouping may change
    small = terrain_scene(dev, 20_000)
    gen = torch.Generator(device=dev)
    gen.manual_seed(35)
    n = 1 << 18
    o = (torch.rand((n, 3), generator=gen, device=dev) - 0.5) * 10.0
    d = torch.randn((n, 3), generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    tn = torch.full((n,), 1e-3, device=dev)
    args = (small.cluster_tris, small.cluster_min, small.cluster_max, o, d,
            tn)
    c1 = ct.trace_closest(*args, torch.full((n,), 1e4, device=dev), factor=1)
    c4 = ct.trace_closest(*args, torch.full((n,), 1e4, device=dev), factor=4)
    a1 = ct.trace_any(*args, torch.full((n,), 3.0, device=dev), factor=1)
    a4 = ct.trace_any(*args, torch.full((n,), 3.0, device=dev), factor=4)
    same_c = all(torch.equal(x, y) for x, y in zip(c1, c4))
    same_a = bool(torch.equal(a1, a4))
    m = 32 * ct.P
    pk = ct.pack(small.cluster_min, small.cluster_max, o[:m], d[:m], tn[:m],
                 torch.full((m,), 1e4, device=dev), 1)
    plain = ct.trace_closest_ref(small.cluster_tris, pk)
    same_ref = all(torch.equal(x[:m], y[:m]) for x, y in zip(c1, plain))
    c = small.cluster_tris.shape[0]
    print(f"[K5/K6 factor] terrain_scene(20_000), C={c}: {n} random rays, "
          f"closest hit in cull mode {ct._skip_for('closest', c, 1)} at "
          f"factor 1 and {ct._skip_for('closest', c, 4)} at factor 4; "
          f"factor 4 against factor 1: closest identical {same_c} "
          f"({int((c1[3] >= 0).sum())} hits), any identical {same_a} "
          f"({int(a1.sum())} occluded); factor 1 closest against the "
          f"plain version on its first {m} rays: identical {same_ref}",
          flush=True)
    require(same_c and same_a, "factor 4 differs from factor 1")
    require(same_ref, "factor 1 closest hit differs from trace_closest_ref")


def run_frames(scene, cfg, dev, n_frames, seed=0):
    from tpu_restir_torch import rng
    from tpu_restir_torch.render import camera as cam_mod
    from tpu_restir_torch.render.integrators.restir.pipeline import (
        init_restir_state, restir_step)
    cam = cam_mod.make_camera(cfg.camera, dev)
    h, w = cfg.camera.height, cfg.camera.width
    state = init_restir_state(h, w, dev)
    acc = None
    for f in range(n_frames):
        frame, state = restir_step(scene, cam, cfg,
                                   rng.make_frame_seed(seed, f), state, f)
        acc = frame if acc is None else acc + (frame - acc) / (f + 1.0)
    return acc, state


def timed_frames(scene, cfg, dev, n_frames, warm=True):
    """The frame yardstick: Renderer.run of n_frames frames after a
    one-frame warm-up on another Renderer (allocator, libraries; warm
    False: the caller ran one), the kernel launch counts zeroed and the
    counts recorded from just before it -> (renderer, image, seconds, its
    queries, `intersect.queries`). run ends in a synchronize."""
    import torch

    from tpu_restir_torch import tracing
    from tpu_restir_torch.render import intersect
    from tpu_restir_torch.renderer import Renderer
    if warm:
        Renderer(scene, cfg, device=dev).run(1)
    torch.cuda.synchronize()
    renderer = Renderer(scene, cfg, device=dev)
    _zero_launches()
    torch.cuda.synchronize()
    with tracing.recording() as rec:
        t0 = time.perf_counter()
        img = renderer.run(n_frames)
    return renderer, img, time.perf_counter() - t0, intersect.queries(rec)


def scene_and_view(label, dev):
    """(scene on dev, camera view) of "cornell" or a clustered scene."""
    if label == "cornell":
        build, view = SCENES["cornell"]
        return build(dev), view
    return large_scene(label, dev)


def phase_small(label="cornell", frames=SMALL_FRAMES):
    """The port at 64x32 on cuda and on cpu (ptrace_mxu on the -128
    scenes); returns (mean, stderr) of the cuda image."""
    import torch

    out = {}
    for dev in ("cuda", "cpu"):
        scene, view = scene_and_view(label, torch.device(dev))
        cfg = bench_cfg(SMALL_W, SMALL_H, view, mxu=label.endswith("-128"))
        img, state = run_frames(scene, cfg, torch.device(dev), frames)
        pix = img.mean(-1).cpu()
        out[dev] = (float(pix.mean()), float(pix.std() / pix.numel() ** 0.5),
                    state.res_prev.sample.point.cpu())
    (mc, sc, pc), (mp, sp, pp) = out["cuda"], out["cpu"]
    comb = (sc * sc + sp * sp) ** 0.5
    differ = float(((pc - pp).abs().amax(-1) > 1e-4).float().mean())
    print(f"[cross-device] {label} {SMALL_W}x{SMALL_H}, {frames} "
          f"frames: mean "
          f"cuda {mc:.6f} cpu {mp:.6f} (|diff| {abs(mc - mp):.3g}, allowed "
          f"3 x {comb:.3g}); reservoirs with a different sample "
          f"{differ:.4%} (allowed < 1%)", flush=True)
    require(abs(mc - mp) <= 3 * comb,
            f"{label}: cuda and cpu image means disagree")
    require(differ < 0.01, f"{label}: cuda and cpu reservoirs disagree")
    return mc, sc


def phase_main_path(dev, small_mean, small_se, smi):
    import torch

    from tpu_restir_torch import cornell_box, metrics

    cfg = bench_cfg(WIDTH, HEIGHT)
    renderer, img, dt, qlog = timed_frames(cornell_box(dev), cfg, dev,
                                           N_FRAMES)
    every = _launches()
    launches = {k: v for k, v in every.items()
                if k not in ("scatter_local", "shortlist_keys")
                and not k.startswith("trace_")}
    # (the forward has no backward; a 36-triangle scene no clusters)
    rays = sum(e["rays"] for e in qlog)
    traced_rpp = rays / float(WIDTH * HEIGHT * N_FRAMES)
    analytic = metrics.rays_per_pixel(cfg)
    mean, _var = renderer.stats()
    finite = bool(torch.isfinite(img).all())
    ms_frame = dt / N_FRAMES * 1e3
    mrays = rays / dt / 1e6
    print(f"[main path] {WIDTH}x{HEIGHT}, {N_FRAMES} frames: "
          f"{ms_frame:.2f} ms/frame, {mrays:.2f} Mrays/s (forward, "
          f"{smi}); traced rays/pixel {traced_rpp} (analytic {analytic}); "
          f"launches {launches}; image mean {mean:.6f}, finite {finite}",
          flush=True)
    require(tuple(img.shape) == (HEIGHT, WIDTH, 3), "wrong image shape")
    require(finite, "image has non-finite values")
    require(traced_rpp == float(analytic),
            f"traced {traced_rpp} rays/pixel, analytic {analytic}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path never launched: {launches}")
    require(every["shortlist_keys"] == 0,
            f"phase 1's K9 ran on the Cornell box: {every}")
    require(abs(mean - small_mean) <= 4 * small_se,
            f"1080p mean {mean} outside the small run's "
            f"{small_mean} +- 4 x {small_se}")
    return launches


def phase_passes(dev):
    """Per-pass device time by prefix timing: restir_step cut after each
    pass (cfg.profile_stop_after), difference of prefix times."""
    import torch

    from tpu_restir_torch import cornell_box, rng
    from tpu_restir_torch.render import camera as cam_mod
    from tpu_restir_torch.render.integrators.restir.pipeline import (
        restir_step)
    cfg = bench_cfg(WIDTH, HEIGHT)
    scene = cornell_box(dev)
    cam = cam_mod.make_camera(cfg.camera, dev)
    _img, state = run_frames(scene, cfg, dev, 2)
    prev = 0.0
    parts = []
    for stage in ("gbuffer", "initial", "temporal", "spatial", None):
        v = cfg.replace(profile_stop_after=stage)
        ms = cuda_ms(lambda: restir_step(scene, cam, v,
                                         rng.make_frame_seed(0, 2), state, 2),
                     7)
        parts.append(f"{stage or 'shade'} {ms - prev:.2f}")
        prev = ms
    print(f"[passes] ms per pass (prefix differences): {'; '.join(parts)}; "
          f"frame {prev:.2f}", flush=True)


def phase_large_path(dev, label, smi, small_mean):
    """The main path on a clustered scene: Renderer at 1920x1080 in the
    bench config, LARGE_FRAMES frames after a warm-up; on the -128 scenes
    with ptrace_mxu. 28 traced rays per pixel; every scene query through
    K5/K6, or K7/K8 under ptrace_mxu (one launch per ptrace_chunk of each
    logged query, so no query ran a plain version, and the other pair
    never), K1 launched on the emissive subset and K2 never; a finite image
    with a mean within a factor 4 of the 64x32 run's (another aspect, so
    not a tight match). Returns the launches."""
    import torch

    from tpu_restir_torch import metrics

    scene, view = large_scene(label, dev)
    mxu = label.endswith("-128")
    cfg = bench_cfg(WIDTH, HEIGHT, view, mxu=mxu)
    renderer, img, dt, qlog = timed_frames(scene, cfg, dev, LARGE_FRAMES)
    launches = _launches()
    rays = sum(e["rays"] for e in qlog)
    traced_rpp = rays / float(WIDTH * HEIGHT * LARGE_FRAMES)
    analytic = metrics.rays_per_pixel(cfg)
    chunk = cfg.intersector.ptrace_chunk
    sfx, other = ("_mxu", "") if mxu else ("", "_mxu")
    chunks = {f"trace_{kind}{sfx}": sum(-(-e["rays"] // chunk) for e in qlog
                                        if e["kind"] == kind)
              for kind in ("closest", "any")}
    backends = sorted({e["backend"] for e in qlog})
    mean, _var = renderer.stats()
    finite = bool(torch.isfinite(img).all())
    print(f"[large path] {label} {WIDTH}x{HEIGHT}"
          f"{' ptrace_mxu' if mxu else ''}, {LARGE_FRAMES} frames: "
          f"{dt / LARGE_FRAMES * 1e3:.2f} ms/frame, {rays / dt / 1e6:.2f} "
          f"Mrays/s (forward, {smi}); traced rays/pixel {traced_rpp} "
          f"(analytic {analytic}); query backends {backends}; launches "
          f"{launches} (chunks of the logged queries {chunks}); image "
          f"mean {mean:.6f} (64x32: {small_mean:.6f}), finite {finite}",
          flush=True)
    require(finite, f"{label}: image has non-finite values")
    require(traced_rpp == float(analytic),
            f"{label}: traced {traced_rpp} rays/pixel, analytic {analytic}")
    require(backends == ["ptrace"], f"{label}: queries went to {backends}")
    require(all(launches[k] == v and v > 0 for k, v in chunks.items()),
            f"{label}: launches {launches} do not cover every chunk of "
            f"every query {chunks}")
    require(launches[f"trace_closest{other}"] == 0
            and launches[f"trace_any{other}"] == 0,
            f"{label}: the other clustered kernels ran: {launches}")
    require(launches["closest_hit"] > 0 and launches["any_hit"] == 0,
            f"{label}: K1 must serve the emissive subset and K2 nothing: "
            f"{launches}")
    require(launches["gather_local"] > 0, f"{label}: K3 never launched")
    require(launches["shortlist_keys"] == sum(chunks.values()),
            f"{label}: K9 launched {launches['shortlist_keys']} times, not "
            f"once a clustered query's chunk {chunks}")
    require(0.25 * small_mean < mean < 4.0 * small_mean,
            f"{label}: implausible image mean {mean} (64x32: {small_mean})")
    if mxu:
        # the same scene through K5/K6 (ptrace_mxu off), for comparison
        r_mt, _img, dt_mt, _log = timed_frames(
            scene, bench_cfg(WIDTH, HEIGHT, view), dev, LARGE_FRAMES)
        print(f"[large path] {label} without ptrace_mxu (K5/K6), the same "
              f"scene and frames: {dt_mt / LARGE_FRAMES * 1e3:.2f} ms/frame "
              f"against {dt / LARGE_FRAMES * 1e3:.2f} through K7/K8; image "
              f"mean {r_mt.stats()[0]:.6f}", flush=True)
    return launches


# the [integrators] phase: (label, integrator, config keywords, timed
# frames) on the Cornell box at 1920x1080, default max_bounce_count 5; the
# show-weights frame is direct light only on a black background, so that
# only its emitters may leave R, G <= 1 (tests/test_features.py:127-140)
PATH_RUNS = (
    ("naive", "naive", {}, 2),
    ("nee-area", "nee", dict(direct_strategy="area"), 1),
    ("nee-brdf", "nee", dict(direct_strategy="brdf"), 1),
    ("nee-mis", "nee", dict(direct_strategy="mis"), 1),
    ("nee-ris", "nee", dict(direct_strategy="ris"), 1),
    ("nee-mis show_weights", "nee",
     dict(direct_strategy="mis", show_weights=True, nee_calc_gi=False,
          bg=(0.0, 0.0, 0.0)), 1),
)
LIGHTS_RUN = ("nee-ris", "nee", dict(direct_strategy="ris"), 2)
# terrain100k at 1920x1080 (the bench's terrain camera): every bounce and
# shadow query through K5/K6, incoherent packets from bounce 1 on
TERRAIN_PATH_RUNS = (
    ("naive", "naive", {}, 1),
    ("nee-mis", "nee", dict(direct_strategy="mis"), 1),
)
# the queries of one path vertex, in the order a frame makes them: the
# path's closest hit, then the direct strategy's (MIS: the BRDF sample's
# closest hit, then the light sample's shadow ray); and those whose
# bounce-1 query K5/K6 are held on
QUERY_ROLES = {"naive": ("path",), "nee-mis": ("path", "BRDF sample",
                                               "shadow")}
HELD_ROLES = {"naive": (), "nee-mis": ("path", "shadow")}
# the most seconds the plain K5/K6 may take on a whole bounce-1 query (its
# hold, the plain version and then the bound's counts, takes ~3x that),
# estimated from every ESTIMATE_STRIDE-th packet; beyond, every
# HOLD_STRIDE-th packet is held
HOLD_BUDGET_S = 20.0
ESTIMATE_STRIDE, HOLD_STRIDE = 128, 32
PATH_TOL = dict(rtol=1e-4, atol=1e-5)
PATH_MIN_SHARE = 0.99   # pixels that must agree, cuda against cpu


def path_cfg(width, height, integrator, view=CORNELL_VIEW,
             bg=(0.5, 0.5, 0.5), **kw):
    """A naive or NEE config: the bench camera, no skybox."""
    from tpu_restir_torch.config import (CameraConfig, RenderConfig,
                                         RenderParams)
    return RenderConfig(
        camera=CameraConfig(width=width, height=height, fov_y_deg=45.0,
                            view_from=view[0], view_at=view[1],
                            pixel_sampler="random"),
        params=RenderParams(use_skybox=False, bg_color=bg),
        integrator=integrator, **kw)


def _path_frame(scene, cfg, dev, frame=0):
    from tpu_restir_torch import rng
    from tpu_restir_torch.render import camera as cam_mod
    from tpu_restir_torch.renderer import _render_frame
    return _render_frame(scene, cam_mod.make_camera(cfg.camera, dev), cfg,
                         rng.frame_key(cfg.seed, frame))


def phase_integrators(dev, smi):
    """The naive and NEE path tracers at 1920x1080 through Renderer, each
    configuration timed after a one-frame warm-up: PATH_RUNS on the
    Cornell box (every query through K1/K2: one launch per logged query of
    each kind), NEE-RIS on lights1k and TERRAIN_PATH_RUNS (naive, NEE-MIS)
    on terrain100k (every query through K5/K6: one launch per ptrace chunk
    of each logged query); traced rays per pixel equal to
    path_rays_per_pixel, finite frames, no other kernel launched, ms/frame,
    Mrays/s and peak memory; on terrain100k the shortlist counts of every
    query and K5/K6 held on bounce-1 queries (`path_queries`, whose frame
    is the warm-up). Then the four strategies without GI must agree on the
    1080p mean, the show-weights frame keep R, G <= 1 off the emitters,
    and 64x32 naive and NEE-MIS frames on cuda and cpu agree pixel by
    pixel, and a 64x32 NEE-MIS frame of a clustered scene. Returns the
    launches of the K1/K2 and K5/K6 runs."""
    import torch

    from tpu_restir_torch import cornell_box
    lights, lview = large_scene("lights1k", dev)
    terrain, tview = large_scene("terrain100k", dev)
    runs = [("cornell", cornell_box(dev), CORNELL_VIEW, *r)
            for r in PATH_RUNS]
    runs.append(("lights1k", lights, lview, *LIGHTS_RUN))
    runs += [("terrain100k", terrain, tview, *r) for r in TERRAIN_PATH_RUNS]
    launches = {}
    for scene_label, scene, view, label, integ, kw, frames in runs:
        cfg = path_cfg(WIDTH, HEIGHT, integ, view, **kw)
        warm = scene_label != "terrain100k"
        if not warm:     # its frame of recorded queries is the warm-up
            path_queries(scene, cfg, label, dev)
        torch.cuda.reset_peak_memory_stats()
        renderer, img, dt, qlog = timed_frames(scene, cfg, dev, frames, warm)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = _launches()
        rays = sum(e["rays"] for e in qlog)
        rpp = rays / float(WIDTH * HEIGHT * frames)
        analytic = path_rays_per_pixel(cfg)
        backends = sorted({e["backend"] for e in qlog})
        if scene_label == "cornell":
            want_backend = ["fused"]
            want = {f"{k}_hit": sum(1 for e in qlog if e["kind"] == k)
                    for k in ("closest", "any")}
        else:
            want_backend = ["ptrace"]
            chunk = cfg.intersector.ptrace_chunk
            want = {f"trace_{k}": sum(-(-e["rays"] // chunk) for e in qlog
                                      if e["kind"] == k)
                    for k in ("closest", "any")}
            # phase 1's K9: once a clustered chunk
            want["shortlist_keys"] = sum(want.values())
        # K10: calc_i_m in every BSDF sample, beside the queries' kernels
        others = {k: v for k, v in got.items()
                  if k not in want and k != "ibeta" and v}
        finite = bool(torch.isfinite(img).all())
        mean = renderer.stats()[0]
        print(f"[integrators] {scene_label} {label} {WIDTH}x{HEIGHT}, "
              f"{frames} frame(s): {dt / frames * 1e3:.2f} ms/frame, "
              f"{rays / dt / 1e6:.2f} Mrays/s ({smi}); traced rays/pixel "
              f"{rpp} (analytic {analytic}); query backends {backends}; "
              f"launches {got} (logged queries {want}); image mean "
              f"{mean:.6f}, finite {finite}; peak memory {peak:.2f} GiB",
              flush=True)
        tag = f"{scene_label} {label}"
        require(tuple(img.shape) == (HEIGHT, WIDTH, 3) and finite,
                f"{tag}: wrong shape or non-finite values")
        require(rpp == float(analytic),
                f"{tag}: traced {rpp} rays/pixel, analytic {analytic}")
        require(backends == want_backend, f"{tag}: queries went to "
                f"{backends}, not {want_backend}")
        require(all(got[k] == v for k, v in want.items())
                and next(iter(want.values())) > 0,
                f"{tag}: launches {got} do not cover every logged query "
                f"{want}")
        require(got["ibeta"] > 0, f"{tag}: K10 never launched")
        require(not others, f"{tag}: other kernels launched: {others}")
        for k, v in want.items():
            launches[k] = launches.get(k, 0) + v
        if kw.get("show_weights"):
            off = img[..., 2] <= 3.0     # the emitters are (17, 12, 4)
            rg = img[off][:, :2]
            print(f"[integrators] show_weights: {int(off.sum())} pixels off "
                  f"the emitters, max R {float(rg[:, 0].max()):.6f}, max G "
                  f"{float(rg[:, 1].max()):.6f}, max B "
                  f"{float(img[off][:, 2].max()):.6f}", flush=True)
            require(float(rg.max()) <= 1.0 + 1e-5
                    and float(img[off][:, 2].abs().max()) == 0.0
                    and float(rg[:, 1].max()) > 0.05,
                    "show_weights: MIS weights outside [0, 1] off the "
                    "emitters, or none non-trivial")
    phase_strategy_means(dev)
    phase_path_cross_device()
    return launches


@contextlib.contextmanager
def all_packets(got):
    """Wraps K5's and K6's wrappers for the block: (kind, packets) of
    every call appended to got, in call order."""
    from tpu_restir_torch.kernels import cluster_trace as ct
    orig = {k: getattr(ct, f"{k}_packets") for k in ("closest", "any")}

    def recorder(kind):
        def call(*args):
            got.append((kind, args[-1]))
            return orig[kind](*args)
        return call

    for kind in orig:
        setattr(ct, f"{kind}_packets", recorder(kind))
    try:
        yield got
    finally:
        for kind, fn in orig.items():
            setattr(ct, f"{kind}_packets", fn)


def path_queries(scene, cfg, label, dev):
    """One path-tracer frame of cfg on a clustered scene, its packets
    recorded (`all_packets`): the shortlist count of every query
    (`Packets.count`, one entry a packet), by bounce and role
    (QUERY_ROLES), as mean, p50, p95, p99 and max out of the C clusters;
    then K5 and K6 held to their plain versions on the bounce-1 queries of
    HELD_ROLES (`hold_trace`: 0 mismatches, t/u/v bit-identical; the
    whole query where the plain version's time, estimated from every
    ESTIMATE_STRIDE-th packet, is within HOLD_BUDGET_S, else every
    HOLD_STRIDE-th packet, printed)."""
    import numpy as np
    import torch

    from tpu_restir_torch import tracing
    from tpu_restir_torch.kernels import cluster_trace as ct
    from tpu_restir_torch.render import intersect
    roles = QUERY_ROLES[label]
    chunk = cfg.intersector.ptrace_chunk
    calls = []
    with tracing.recording() as rec, all_packets(calls):
        _path_frame(scene, cfg, dev, 1)
    qlog = intersect.queries(rec)
    c = scene.cluster_tris.shape[0]
    require(len(calls) == sum(-(-e["rays"] // chunk) for e in qlog)
            and len(qlog) % len(roles) == 0,
            f"{label}: {len(calls)} packet calls for {len(qlog)} queries")
    held, at = {}, 0
    for i, e in enumerate(qlog):
        n_calls = -(-e["rays"] // chunk)
        part = calls[at:at + n_calls]
        at += n_calls
        bounce, role = divmod(i, len(roles))
        role = roles[role]
        require(all(k == e["kind"] for k, _pk in part),
                f"{label}: query {i} is {e['kind']}, its packets are not")
        cnt = torch.cat([pk.count for _k, pk in part]).cpu().numpy()
        print(f"[integrators] terrain100k {label} bounce {bounce} {role} "
              f"({e['kind']}, {e['rays']} rays in {cnt.size} packets, "
              f"factor {part[0][1].factor}): shortlist mean "
              f"{cnt.mean():.1f}, p50 {np.percentile(cnt, 50):.0f}, p95 "
              f"{np.percentile(cnt, 95):.0f}, p99 {np.percentile(cnt, 99):.0f}"
              f", max {cnt.max()} of C = {c}", flush=True)
        if bounce == 1 and role in HELD_ROLES[label]:
            held[role] = part[0][1]
    del calls
    require(set(held) == set(HELD_ROLES[label]),
            f"{label}: bounce-1 queries to hold {sorted(held)}")
    results = {}
    for role, pk in held.items():
        kind = "trace_closest" if role == "path" else "trace_any"
        kernel, plain = _trace_fns(kind, scene)
        n = pk.count.shape[0]
        # the split of the whole query: phase 1 (`pack`) and the kernel
        rays = (pk.o[:pk.n_rays], pk.d[:pk.n_rays], pk.tnear[:pk.n_rays],
                pk.tfar[:pk.n_rays])
        p1_ms = cuda_ms(lambda: ct.pack(scene.cluster_min, scene.cluster_max,
                                        *rays, pk.factor), 1, windows=1)
        k_ms = cuda_ms(lambda: kernel(pk), 1, windows=1)
        print(f"[integrators] terrain100k {label} bounce 1 {role}, the "
              f"whole query ({pk.n_rays} rays): phase 1 {p1_ms:.3f} ms, "
              f"{kind} {k_ms:.3f} ms ({k_ms / (p1_ms + k_ms):.1%} of the "
              f"two)", flush=True)
        sub = torch.arange(0, n, ESTIMATE_STRIDE, device=pk.count.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain(pk.take(sub))
        torch.cuda.synchronize()
        estimate = (time.perf_counter() - t0) * n / len(sub)
        what = f"bounce-1 {role} query of {label}"
        hold_keys("terrain100k", scene, what + " (whole)", pk, results)
        if estimate > HOLD_BUDGET_S:
            sub = torch.arange(0, n, HOLD_STRIDE, device=pk.count.device)
            what += (f", packets 0, {HOLD_STRIDE}, {2 * HOLD_STRIDE}, ... "
                     f"({len(sub)} of {n}; the plain version's estimate "
                     f"for the whole query {estimate:.0f} s)")
            pk = pk.take(sub)
        else:
            what += f" (whole; plain estimate {estimate:.1f} s)"
        hold_trace("terrain100k", scene, kind, what, pk, results)


def phase_strategy_means(dev):
    """The four NEE strategies without GI (direct light and directly seen
    emitters, frame key 0 each) estimate one image: their 1080p means
    within 3 combined standard errors of each other, and, paired pixel by
    pixel (the same camera rays), the mean difference within 3 standard
    errors of the difference (the JAX oracle of tests/test_restir.py:35-58,
    made stricter by the pairing)."""
    from tpu_restir_torch import cornell_box
    scene = cornell_box(dev)
    pix = {}
    for s in ("area", "brdf", "mis", "ris"):
        cfg = path_cfg(WIDTH, HEIGHT, "nee", direct_strategy=s,
                       nee_calc_gi=False)
        pix[s] = _path_frame(scene, cfg, dev).mean(-1).double()
    n = WIDTH * HEIGHT
    stats = {s: (float(p.mean()), float(p.std()) / math.sqrt(n))
             for s, p in pix.items()}
    worst, worst_pair = 0.0, 0.0
    names = list(pix)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (ma, sa), (mb, sb) = stats[a], stats[b]
            worst = max(worst, abs(ma - mb) / math.hypot(sa, sb))
            d = pix[a] - pix[b]
            se = float(d.std()) / math.sqrt(n)
            worst_pair = max(worst_pair, abs(float(d.mean())) / se
                             if se > 0 else 0.0)
    print(f"[integrators] strategy means without GI at {WIDTH}x{HEIGHT}: "
          + ", ".join(f"{s} {m:.6f} (se {e:.2g})"
                      for s, (m, e) in stats.items())
          + f"; largest |difference| / combined se {worst:.3f}, paired "
          f"{worst_pair:.3f} (allowed 3)", flush=True)
    require(worst <= 3.0 and worst_pair <= 3.0,
            "the NEE strategies disagree on the image mean")


def phase_path_cross_device():
    """64x32 naive and NEE-MIS frames (default bounces) on cuda and on cpu
    (the plain versions of K1/K2), and a NEE-MIS frame of the clustered
    terrain_scene(5_000) (79 clusters: K5, and K6 in cull mode 5, against
    their plain versions) from the terrain camera: allclose at PATH_TOL on
    at least PATH_MIN_SHARE of the pixels."""
    import torch

    from tpu_restir_torch import cornell_box
    from tpu_restir_torch.scene.procedural import terrain_scene
    runs = [(integ, cornell_box, path_cfg(SMALL_W, SMALL_H, integ))
            for integ in ("naive", "nee")]
    runs.append(("nee terrain_scene(5_000)",
                 lambda dev: terrain_scene(dev, 5_000),
                 path_cfg(SMALL_W, SMALL_H, "nee", TERRAIN_VIEW)))
    for integ, build, cfg in runs:
        imgs = [_path_frame(build(torch.device(d)), cfg,
                            torch.device(d), 3).cpu()
                for d in ("cuda", "cpu")]
        close = torch.isclose(imgs[0], imgs[1], **PATH_TOL).all(-1)
        share = float(close.float().mean())
        print(f"[integrators] cross-device {integ} {SMALL_W}x{SMALL_H}: "
              f"{int(close.sum())} of {close.numel()} pixels allclose "
              f"(rtol {PATH_TOL['rtol']}, atol {PATH_TOL['atol']}; "
              f"{share:.4%}, allowed >= {PATH_MIN_SHARE:.0%}); max |diff| "
              f"{float((imgs[0] - imgs[1]).abs().max()):.3g}", flush=True)
        require(bool(torch.isfinite(imgs[0]).all()),
                f"cross-device {integ}: non-finite frame")
        require(share >= PATH_MIN_SHARE,
                f"cross-device {integ}: cuda and cpu frames disagree")


def profile_integrator(dev, path):
    """One NEE-MIS 1080p Cornell frame under torch.profiler, its device
    time split into the threefry draws (rng.uniform), calc_i_m, K1/K2 and
    the rest: the two functions are wrapped in record_function ranges for
    this run only. Writes the table to path."""
    import torch
    from torch.autograd import DeviceType

    from tpu_restir_torch import cornell_box, rng
    from tpu_restir_torch.render import brdf
    scene = cornell_box(dev)
    cfg = path_cfg(WIDTH, HEIGHT, "nee", direct_strategy="mis")

    def ranged(name, fn):
        def call(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return call

    saved = rng.uniform, brdf.calc_i_m
    rng.uniform = ranged("threefry_uniform", saved[0])
    brdf.calc_i_m = ranged("calc_i_m", saved[1])
    try:
        _path_frame(scene, cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _path_frame(scene, cfg, dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _path_frame(scene, cfg, dev)
            torch.cuda.synchronize()
    finally:
        rng.uniform, brdf.calc_i_m = saved
    events = prof.key_averages()
    ranges = ("threefry_uniform", "calc_i_m")
    # (a range may also show as a device-side annotation: not a kernel)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in ranges]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    # a range's device time: its kernels' time, summed on the host-side
    # range (the device-side annotation's span where that reads 0)
    split = {name: (sum(e.device_time_total for e in events if e.key == name
                        and e.device_type == DeviceType.CPU)
                    or sum(e.self_device_time_total for e in events
                           if e.key == name
                           and e.device_type == DeviceType.CUDA)) / 1e3
             for name in ranges}
    split["K1/K2"] = sum(
        e.self_device_time_total for e in kernels
        if "(anonymous namespace)::closest_kernel" in e.key
        or "(anonymous namespace)::any_kernel" in e.key) / 1e3
    split["rest"] = device_ms - sum(split.values())
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))
    print(f"[profile] 1 NEE-MIS {WIDTH}x{HEIGHT} frame: wall "
          f"{wall_ms:.1f} ms without the profiler; device kernels "
          f"{device_ms:.1f} ms in {n_launch} launches, busy share "
          f"{device_ms / wall_ms:.3f}; device ms "
          + ", ".join(f"{k} {v:.2f} ({v / device_ms:.3f})"
                      for k, v in split.items())
          + f"; table in {path}", flush=True)


_SIDECAR_KEYS = ["Image name:", "", "Iteration count:", "Area samples:",
                 "BRDF samples:", "", "Spatial reuse:", "\tPass count:",
                 "\tNeighbor count:", "\tReuse radius:", "",
                 "Temporal reuse:", "", "Render time:", "Image mean:",
                 "Image variance:", "", "Camera position:", "Camera view at:",
                 "Camera vertical FOV:", "", "Pass times (ms):"]


def cli_main(argv):
    """`tpu_restir_torch.cli.main(argv)` in-process, which must return 0
    -> the Renderer it made."""
    from tpu_restir_torch import cli
    from tpu_restir_torch import renderer as renderer_mod
    made = []
    base = renderer_mod.Renderer

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    renderer_mod.Renderer = Recorded
    try:
        require(cli.main(argv) == 0, f"cli.main failed: {' '.join(argv)}")
    finally:
        renderer_mod.Renderer = base
    return made[-1]


def phase_cli(dev, smi):
    """The CLI frame loop in-process: `cli.main` on terrain100k at
    1920x1080 (the bench's terrain camera, temporal and 5-neighbour
    pairwise spatial reuse) with --denoise, --profile-passes and a
    checkpoint, CLI_FRAMES frames, then CLI_RESUMED more resumed from the
    checkpoint. The PNG (1920x1080 RGBA) and the sidecar (the reference's
    field layout, CLI_FRAMES + CLI_RESUMED iterations, the pass times)
    must be written; the resumed renderer's denoised display must be
    finite and differ from the raw one."""
    import numpy as np

    from tpu_restir_torch import renderer as renderer_mod
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        out = os.path.join(tmp, "terrain.png")
        argv = ["--scene", "terrain", "--size", f"{WIDTH}x{HEIGHT}",
                "--view-from", "0,-7,4", "--view-at", "0,0,0.5",
                "--temporal", "--spatial", "--spatial-mis", "pairwise",
                "--denoise", "--profile-passes", "--device", str(dev),
                "--checkpoint", os.path.join(tmp, "ck"), "--out", out]
        times = []
        for frames in (CLI_FRAMES, CLI_RESUMED):
            t0 = time.perf_counter()
            r = cli_main(argv + ["--frames", str(frames)])
            times.append(time.perf_counter() - t0)
        with open(out, "rb") as f:
            head = f.read(26)
        png_ok = (head[:8] == b"\x89PNG\r\n\x1a\n"
                  and struct.unpack(">II", head[16:24]) == (WIDTH, HEIGHT)
                  and head[24:26] == bytes([8, 6]))
        lines = open(out + ".txt").read().splitlines()
        layout = [ln.split(":")[0] + ":" if ":" in ln else ln
                  for ln in lines[:len(_SIDECAR_KEYS)]]
        iters = lines[2]
        passes = {ln.split(":")[0].strip(): float(ln.split(":")[1])
                  for ln in lines[len(_SIDECAR_KEYS):]}
        den = r.display()
        raw = renderer_mod.display_image(r.accumulator,
                                         r.cfg.params).cpu().numpy()
        finite = bool(np.isfinite(den).all())
        differs = float(np.abs(den - raw).mean())
        print(f"[cli] python -m tpu_restir_torch.cli {' '.join(argv[:-4])} "
              f"...: {CLI_FRAMES} frames in {times[0]:.1f} s (scene build, "
              f"profiled passes, denoise, export, checkpoint; "
              f"{times[0] / CLI_FRAMES * 1e3:.1f} ms/frame), then "
              f"{CLI_RESUMED} resumed in {times[1]:.1f} s; PNG {WIDTH}x"
              f"{HEIGHT} RGBA {png_ok}; sidecar layout "
              f"{layout == _SIDECAR_KEYS}, '{iters}', pass times (ms) "
              f"{passes}; denoised display finite {finite}, mean |denoised "
              f"- raw| {differs:.4f} ({smi})", flush=True)
        require(png_ok, "the CLI's PNG is not a 1920x1080 RGBA PNG")
        require(layout == _SIDECAR_KEYS, f"sidecar layout {layout}")
        require(iters == f"Iteration count: {CLI_FRAMES + CLI_RESUMED}",
                f"the resumed run ended at '{iters}'")
        require(set(passes) == {"gbuffer", "initial", "temporal", "spatial",
                                "shade"}, f"sidecar pass times {passes}")
        require(r.acc_ctr == CLI_FRAMES + CLI_RESUMED,
                "the resumed renderer did not carry the checkpoint")
        require(finite and differs > 1e-4,
                "the denoised display is not finite or equals the raw one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_denoise_cost(dev, smi):
    """ms/frame of the 1080p bench frame on terrain100k with and without
    the denoiser: Renderer.run over 3 frames after a warm-up (with it,
    each step adds the SVGF temporal update), and one display() each (with
    it, the 5-level a-trous filter). Then the two parts alone with CUDA
    events on the last frame's inputs: svgf_temporal_update of the frame
    into the renderer's history, and the filter (Renderer._denoised); the
    frame differences are only a cross-check."""
    import torch

    from tpu_restir_torch.config import replace
    from tpu_restir_torch.denoise import svgf_temporal_update
    from tpu_restir_torch.renderer import Renderer
    scene, view = large_scene("terrain100k", dev)
    out = {}
    for denoise in (False, True):
        cfg = bench_cfg(WIDTH, HEIGHT, view)
        cfg = cfg.replace(params=replace(cfg.params, denoise=denoise))
        r = Renderer(scene, cfg, device=dev)
        r.run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.run(3)
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        t0 = time.perf_counter()
        img = r.display()
        out[denoise] = (step_ms, (time.perf_counter() - t0) * 1e3)
        require(bool((img == img).all()), "display has NaN")
    (s0, d0), (s1, d1) = out[False], out[True]
    hist, gb = r._svgf_hist, r._restir_state.gb_prev
    update_ms = cuda_ms(
        lambda: svgf_temporal_update(hist, r.accumulator, gb), 5)
    filter_ms = cuda_ms(r._denoised, 5)
    print(f"[denoise cost] terrain100k {WIDTH}x{HEIGHT}: without --denoise "
          f"{s0:.2f} ms/frame, display {d0:.2f} ms; with --denoise "
          f"{s1:.2f} ms/frame, display {d1:.2f} ms; alone (CUDA events, "
          f"cuda_ms of 5 runs): SVGF temporal update {update_ms:.3f} ms, SVGF "
          f"filter {filter_ms:.3f} ms (frame differences: update "
          f"{s1 - s0:.2f} ms, filter {d1 - d0:.2f} ms) ({smi})", flush=True)


# the demo asset (assets/demo) and the golden of tests/test_demo_asset.py
# (48x32, 4 frames, seed 123, ReSTIR temporal + pairwise spatial,
# m_area 2, the env.pfm sky; 4x4 display-space region means)
DEMO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                        "demo")
DEMO_VIEW = ((0.0, -6.0, 2.1), (0.0, 0.4, 0.7))
DEMO_FRAMES = 4          # timed 1080p ReSTIR frames, after 1 warm-up
DEMO_GOLDEN_MEAN = 0.536838
DEMO_GOLDEN_REGIONS = [[0.7129, 0.5927, 0.5785, 0.7047],
                       [0.6801, 0.5566, 0.5822, 0.6730],
                       [0.3819, 0.3869, 0.4031, 0.4196],
                       [0.3443, 0.4356, 0.4319, 0.3574]]
DEMO_ARGV = ["--size", "48x32", "--fov", "50", "--view-from", "0,-6.0,2.1",
             "--view-at", "0,0.4,0.7", "--frames", "4", "--temporal",
             "--spatial", "--spatial-mis", "pairwise", "--m-area", "2"]
# gradients on cuda against cpu: rtol 1e-4 of each entry plus 1e-5 of the
# field's largest entry, about 25 times the largest gap read on an H100
# (3.84e-07 of the largest entry, roughness; texels 1.59e-07): the texel
# gradient's backward is an atomic index_put_(accumulate=True) on CUDA,
# which sums in another order than the CPU
GRAD_TOL = (1e-4, 1e-5)


def demo_scene(dev):
    """assets/demo/demo.obj with env.pfm as its sky, on dev, through the
    port's loader (clusters of 32, as the JAX package builds it)."""
    from tpu_restir_torch.scene.envmap import with_sky
    from tpu_restir_torch.scene.objloader import load_obj_scene
    return with_sky(load_obj_scene(os.path.join(DEMO_DIR, "demo.obj"), dev),
                    os.path.join(DEMO_DIR, "env.pfm"))


def demo_cfg(width, height, integrator="restir", backend="auto"):
    """The demo golden's camera and ReSTIR flags with the sky; NEE-MIS
    at 5 bounces for integrator "nee"."""
    from tpu_restir_torch.config import (CameraConfig, IntersectorConfig,
                                         RenderConfig, RenderParams,
                                         RestirParams)
    return RenderConfig(
        camera=CameraConfig(width=width, height=height, fov_y_deg=50.0,
                            view_from=DEMO_VIEW[0], view_at=DEMO_VIEW[1],
                            pixel_sampler="random"),
        params=RenderParams(use_skybox=True),
        restir=RestirParams(m_area=2, m_brdf=1, do_temporal_reuse=True,
                            do_spatial_reuse=True, spatial_neighbor_count=5,
                            spatial_mis="pairwise"),
        intersector=IntersectorConfig(backend=backend),
        integrator=integrator, direct_strategy="mis")


def ts_panel_scene(dev):
    """The `setup_ts` scene of tests/test_diff_glossy.py: a checker-
    textured floor, a Torrance-Sparrow panel (roughness 0.45) and an area
    light -> (scene, camera view, fov)."""
    import numpy as np

    from tpu_restir_torch.scene.materials import MaterialSpec, MatType
    from tpu_restir_torch.scene.scene import build_scene

    def quad(*p):
        p = [np.asarray(x, np.float32) for x in p]
        return [np.stack([p[0], p[1], p[2]]), np.stack([p[0], p[2], p[3]])]

    tris = (quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0))
            + quad((-1, 1, 0), (1, 1, 0), (1, 1, 2), (-1, 1, 2))
            + quad((-0.4, 0.4, 1.9), (0.4, 0.4, 1.9), (0.4, -0.4, 1.9),
                   (-0.4, -0.4, 1.9)))
    quv = [np.array([[0, 0], [1, 0], [1, 1]], np.float32),
           np.array([[0, 0], [1, 1], [0, 1]], np.float32)]
    checker = np.indices((8, 8)).sum(0) % 2
    tex = (0.25 + 0.6 * checker)[..., None].repeat(3, -1).astype(np.float32)
    specs = [MaterialSpec("floor", MatType.LAMBERT, diffuse=(0.6, 0.55, 0.5),
                          tex_diffuse=0),
             MaterialSpec("glossy", MatType.TS, diffuse=(0.25, 0.3, 0.45),
                          specular=(0.4, 0.4, 0.4), shininess=60.0,
                          roughness=0.45),
             MaterialSpec("light", MatType.LAMBERT,
                          diffuse=(0.78, 0.78, 0.78),
                          emission=(14.0, 11.0, 6.0))]
    scene = build_scene(np.stack(tris), np.array([0, 0, 1, 1, 2, 2]), specs,
                        dev, vertex_uvs=np.stack(quv * 3),
                        textures=tex[None])
    return scene, ((0.0, -2.6, 1.0), (0.0, 0.0, 0.8)), 55.0


def _demo_load(dev):
    """Load the demo on dev and check it: 78 triangles through the fused
    backend (K1/K2), three 64x64 textures, all six Pc classes, a valid
    light CDF, the 32x64 HDR sky."""
    import torch

    from tpu_restir_torch.render import intersect
    from tpu_restir_torch.scene.materials import MatType
    t0 = time.perf_counter()
    scene = demo_scene(dev)
    secs = time.perf_counter() - t0
    cfg = demo_cfg(WIDTH, HEIGHT)
    backend = intersect._backend(scene, cfg.intersector)
    classes = {MatType.NORMAL, MatType.LAMBERT, MatType.PHONG,
               MatType.MIRROR, MatType.DIELECTRIC, MatType.TRANSPARENT}
    tex = scene.textures
    cdf = scene.lights.cdf
    cdf_ok = bool(scene.lights.is_valid and float(cdf[-1]) == 1.0
                  and bool((cdf[1:] >= cdf[:-1]).all()))
    print(f"[demo] loaded assets/demo/demo.obj and env.pfm on {dev} in "
          f"{secs:.2f} s: {scene.num_tris} triangles (clusters of "
          f"{scene.cluster_size}), backend {backend}; {tex.num_textures} "
          f"textures, sizes {tex.sizes.tolist()}; material classes "
          f"{list(scene.materials.types_present)}; {scene.lights.count} "
          f"emissive triangles, CDF valid {cdf_ok}; sky "
          f"{tuple(scene.envmap.shape)}, peak {float(scene.envmap.max()):.3f}",
          flush=True)
    require(scene.num_tris == 78 and backend == "fused",
            f"demo: {scene.num_tris} triangles through {backend}")
    require(tex.num_textures == 3 and tex.sizes.tolist() == [[64, 64]] * 3,
            f"demo: texture stack {tex.sizes.tolist()}")
    require(classes <= set(scene.materials.types_present),
            f"demo: material classes {scene.materials.types_present}")
    require(cdf_ok, "demo: the light CDF is not valid")
    require(tuple(scene.envmap.shape) == (32, 64, 3)
            and float(scene.envmap.max()) > 5.0, "demo: the sky is wrong")
    require(scene.envmap.device.type == torch.device(dev).type
            and tex.data.device.type == torch.device(dev).type,
            "demo: the sky or the textures are not on the device")
    return scene


def _demo_restir(dev, scene, smi):
    """DEMO_FRAMES ReSTIR frames at 1080p after a warm-up: ms/frame,
    Mrays/s at the analytic count, K1/K2/K3/K10 launches per frame; every
    query through the fused backend, no clustered kernel launched."""
    import torch

    from tpu_restir_torch import metrics
    cfg = demo_cfg(WIDTH, HEIGHT)
    renderer, img, dt, qlog = timed_frames(scene, cfg, dev, DEMO_FRAMES)
    got = _launches()
    rays = sum(e["rays"] for e in qlog)
    rpp = rays / float(WIDTH * HEIGHT * DEMO_FRAMES)
    analytic = metrics.rays_per_pixel(cfg)
    backends = sorted({e["backend"] for e in qlog})
    finite = bool(torch.isfinite(img).all())
    mean = renderer.stats()[0]
    path = {k: got[k] for k in ("closest_hit", "any_hit", "gather_local",
                                "ibeta")}
    per_frame = {k: v / DEMO_FRAMES for k, v in path.items()}
    others = {k: v for k, v in got.items() if k not in path and v}
    print(f"[demo] ReSTIR {WIDTH}x{HEIGHT} (m_area 2, m_brdf 1, temporal, "
          f"5-neighbour pairwise spatial, sky), {DEMO_FRAMES} frames: "
          f"{dt / DEMO_FRAMES * 1e3:.2f} ms/frame, {rays / dt / 1e6:.2f} "
          f"Mrays/s at {analytic} rays/pixel ({smi}); traced rays/pixel "
          f"{rpp} (analytic {analytic}); query backends {backends}; "
          f"K1/K2/K3/K10 launches per frame {per_frame}; image mean "
          f"{mean:.6f}, finite {finite}", flush=True)
    require(tuple(img.shape) == (HEIGHT, WIDTH, 3) and finite,
            "demo: wrong shape or non-finite values")
    require(analytic == 29 and rpp == float(analytic),
            f"demo: traced {rpp} rays/pixel, analytic {analytic}")
    require(backends == ["fused"], f"demo: queries went to {backends}")
    require(all(v > 0 for v in path.values()),
            f"demo: a kernel of the path never launched: {path}")
    require(not others, f"demo: other kernels launched: {others}")
    _demo_texture_cost(dev, scene, dt / DEMO_FRAMES * 1e3)
    return path


def _demo_texture_cost(dev, scene, frame_ms):
    """The slice's own work alone, on the 1080p G-buffer's hit records
    (CUDA events, cuda_ms of 5 runs): apply_textures and apply_normal_map
    (4 sample_stack calls), and the sky lookup of every primary ray; its
    share of the ReSTIR frame, which runs it once, beside."""
    from tpu_restir_torch import rng
    from tpu_restir_torch.render import camera as cam_mod
    from tpu_restir_torch.render import intersect
    from tpu_restir_torch.scene.envmap import sky_radiance
    from tpu_restir_torch.scene.materials import (apply_normal_map,
                                                  apply_textures,
                                                  gather_materials)
    cfg = demo_cfg(WIDTH, HEIGHT)
    o, d = cam_mod.generate_rays(cam_mod.make_camera(cfg.camera, dev),
                                 cfg.camera, rng.frame_key(0, 0))
    hi = intersect.hit_attributes(scene, o, d, intersect.intersect_closest(
        scene, o, d, cfg.params.tnear_offset, float("inf")))
    m = gather_materials(scene.materials, hi.mat_id)

    def textures():
        mt = apply_textures(scene, m, hi.uv)
        return apply_normal_map(scene, mt, hi.normal, hi.tangent, hi.uv)

    tex_ms = cuda_ms(textures, 5)
    sky_ms = cuda_ms(lambda: sky_radiance(scene, cfg.params, d), 5)
    print(f"[demo] textures alone at {WIDTH}x{HEIGHT} (CUDA events, cuda_ms "
          f"of 5 runs): apply_textures + apply_normal_map {tex_ms:.3f} ms, "
          f"sky lookup {sky_ms:.3f} ms; together "
          f"{(tex_ms + sky_ms) / frame_ms:.4f} of the {frame_ms:.2f} ms "
          f"ReSTIR frame", flush=True)


def _demo_nee(dev, scene, smi):
    """One NEE-MIS 1080p frame after a warm-up: textures, the normal map
    and the sky at every bounce."""
    import torch
    cfg = demo_cfg(WIDTH, HEIGHT, "nee")
    renderer, img, dt, qlog = timed_frames(scene, cfg, dev, 1)
    got = _launches()
    rays = sum(e["rays"] for e in qlog)
    rpp = rays / float(WIDTH * HEIGHT)
    analytic = path_rays_per_pixel(cfg)
    want = {f"{k}_hit": sum(1 for e in qlog if e["kind"] == k)
            for k in ("closest", "any")}
    finite = bool(torch.isfinite(img).all())
    print(f"[demo] NEE-MIS {WIDTH}x{HEIGHT} (5 bounces, sky), 1 frame: "
          f"{dt * 1e3:.2f} ms/frame, {rays / dt / 1e6:.2f} Mrays/s ({smi}); "
          f"traced rays/pixel {rpp} (analytic {analytic}); launches "
          f"{ {k: got[k] for k in want} } (logged queries {want}); image "
          f"mean {renderer.stats()[0]:.6f}, finite {finite}", flush=True)
    require(finite and tuple(img.shape) == (HEIGHT, WIDTH, 3),
            "demo NEE-MIS: wrong shape or non-finite values")
    require(rpp == float(analytic),
            f"demo NEE-MIS: traced {rpp} rays/pixel, analytic {analytic}")
    require(all(got[k] == v > 0 for k, v in want.items()),
            f"demo NEE-MIS: launches {got}, logged queries {want}")


def _demo_golden():
    """The CLI with the demo golden's argv on cuda: the sidecar's mean
    within 2% and the 4x4 display-space region means (the port's PNG
    reader) within 0.04 of the golden; the same run on cpu: image means
    within 3 combined standard errors and fewer than 1% of reservoirs
    holding another sample (the [cross-device] tolerance), the share of
    pixels allclose at PATH_TOL printed."""
    import numpy as np
    import torch

    from tpu_restir_torch.io.png import read_png
    tmp = tempfile.mkdtemp(prefix="chip_smoke_demo_")
    try:
        out, runs = {}, {}
        for device in ("cuda", "cpu"):
            path = os.path.join(tmp, f"demo_{device}.png")
            runs[device] = cli_main(
                ["--scene", os.path.join(DEMO_DIR, "demo.obj")] + DEMO_ARGV
                + ["--skybox", os.path.join(DEMO_DIR, "env.pfm"), "--device",
                   device, "--out", path])
            side = open(path + ".txt").read()
            img = read_png(path)[..., :3].astype(np.float32) / 255.0
            out[device] = (float(side.split("Image mean:")[1].split()[0]),
                           img.reshape(4, 8, 4, 12, 3).mean(axis=(1, 3, 4)))
        mean, reg = out["cuda"]
        reg_err = float(np.abs(reg - np.asarray(DEMO_GOLDEN_REGIONS)).max())
        acc = {d: r.accumulator.cpu() for d, r in runs.items()}
        pix = {d: a.mean(-1) for d, a in acc.items()}
        comb = math.hypot(*(float(p.std()) / p.numel() ** 0.5
                            for p in pix.values()))
        diff = abs(float(pix["cuda"].mean()) - float(pix["cpu"].mean()))
        pts = {d: r._restir_state.res_prev.sample.point.cpu()
               for d, r in runs.items()}
        differ = float(((pts["cuda"] - pts["cpu"]).abs().amax(-1) > 1e-4)
                       .float().mean())
        close = float(torch.isclose(acc["cuda"], acc["cpu"], **PATH_TOL)
                      .all(-1).float().mean())
        print(f"[demo] golden: python -m tpu_restir_torch.cli --scene "
              f"assets/demo/demo.obj {' '.join(DEMO_ARGV)} --skybox "
              f"assets/demo/env.pfm --device cuda: image mean {mean:.6f} "
              f"(golden {DEMO_GOLDEN_MEAN}, |rel diff| "
              f"{abs(mean - DEMO_GOLDEN_MEAN) / DEMO_GOLDEN_MEAN:.4f}, "
              f"allowed 0.02); 4x4 region means {np.round(reg, 4).tolist()}, "
              f"max |diff| {reg_err:.4f} (allowed 0.04); --device cpu: mean "
              f"{out['cpu'][0]:.6f}, accumulator means differ by {diff:.3g} "
              f"(allowed 3 x {comb:.3g}), reservoirs with a different "
              f"sample {differ:.4%} (allowed < 1%), pixels allclose "
              f"(rtol {PATH_TOL['rtol']}, atol {PATH_TOL['atol']}) "
              f"{close:.4%}", flush=True)
        require(abs(mean - DEMO_GOLDEN_MEAN) < 0.02 * DEMO_GOLDEN_MEAN,
                f"demo golden: mean {mean}")
        require(reg_err <= 0.04, f"demo golden: region means {reg}")
        require(diff <= 3 * comb, "demo golden: cuda and cpu means disagree")
        require(differ < 0.01, "demo golden: cuda and cpu reservoirs "
                "disagree")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _grad_pair(field):
    """(loss, grads, launches) on cuda and cpu at 64x32: the texels
    through one demo ReSTIR frame (seed 1), or roughness through one
    NEE-MIS frame (2 bounces, seed 0) on the TS panel scene; for the
    texels also the arguments of the cuda step's scatter_local (K4)."""
    import torch

    from tpu_restir_torch.config import RenderParams
    from tpu_restir_torch.diff.params import extract_params
    from tpu_restir_torch.diff.render import make_value_and_grad
    from tpu_restir_torch.kernels import local_gather as lg
    from tpu_restir_torch.render import camera as cam_mod
    out = {}
    for device in ("cuda", "cpu"):
        dev = torch.device(device)
        if field == "tex_data":
            scene, cfg, seeds = demo_scene(dev), demo_cfg(SMALL_W,
                                                          SMALL_H), (1,)
        else:
            scene, view, fov = ts_panel_scene(dev)
            cfg = path_cfg(SMALL_W, SMALL_H, "nee", view,
                           direct_strategy="mis")
            cfg = cfg.replace(camera=dataclasses.replace(
                cfg.camera, fov_y_deg=fov), params=RenderParams(
                use_skybox=False, max_bounce_count=2))
            seeds = (0,)
        vg = make_value_and_grad(scene, cam_mod.make_camera(cfg.camera, dev),
                                 cfg, seeds, torch.zeros(
                                     (SMALL_H, SMALL_W, 3), device=dev))
        taps = {}
        with capture_first(lg, "scatter_local", lambda *_: True, taps):
            _zero_launches()
            loss, grads = vg(extract_params(scene, (field,)))
            out[device] = (float(loss), grads[field].cpu(), _launches())
        if device == "cuda" and field == "tex_data":
            out["scatter_local"] = taps["scatter_local"]
    return out


def _demo_grads(record):
    """value_and_grad on cuda and on cpu, w.r.t. the demo's texels (one
    ReSTIR frame) and the TS panel's roughness (one NEE-MIS frame):
    finite, loss at rtol 1e-4, gradients within GRAD_TOL; K4 held to its
    plain versions on the texel step's own cotangents. Returns the cuda
    launches of the texel step."""
    import torch
    launches = None
    for field in ("tex_data", "roughness"):
        out = _grad_pair(field)
        (lc, gc, la), (lp, gp, _l) = out["cuda"], out["cpu"]
        scale = float(gp.abs().max())
        excess = float(((gc - gp).abs() - (GRAD_TOL[0] * gp.abs()
                                           + GRAD_TOL[1] * scale)).max())
        rel = float((gc - gp).abs().max()) / scale if scale else 0.0
        nonzero = int((gp.abs() > 0).sum())
        print(f"[demo] gradient cross-device {field} {SMALL_W}x{SMALL_H}: "
              f"loss cuda {lc:.7f} cpu {lp:.7f}; {nonzero} nonzero entries "
              f"of {gp.numel()}; max |cuda - cpu| / max |cpu| {rel:.3g}; "
              f"within rtol {GRAD_TOL[0]} + {GRAD_TOL[1]} x field max: "
              f"{excess <= 0.0} (worst excess {excess:.3g}); cuda launches "
              f"{ {k: v for k, v in la.items() if v} }", flush=True)
        require(bool(torch.isfinite(gc).all()) and nonzero > 0,
                f"demo {field}: non-finite or all-zero gradient")
        require(abs(lc - lp) <= 1e-4 * abs(lp),
                f"demo {field}: cuda and cpu losses disagree")
        require(excess <= 0.0, f"demo {field}: cuda and cpu gradients "
                "disagree")
        if field == "tex_data":
            launches = la
            require(all(la[k] > 0 for k in ("closest_hit", "any_hit",
                                            "gather_local", "scatter_local")),
                    f"demo {field}: a kernel of the step never launched: {la}")
            check_scatter("demo texel step's spatial taps",
                          *out["scatter_local"], record)
    return launches


def check_scatter(label, g, tys, txs, r, disk_r2, record):
    """K4 against scatter_local_ref on one backward's own cotangents:
    within 1e-5 (index_add_ sums in atomic order) and bit-identical to
    the sum in the kernel's order; times and the bytes bound."""
    import torch

    from tpu_restir_torch.kernels import local_gather as lg
    (k, h, w), c = tys.shape, g.shape[-1]
    got = lg.scatter_local(g, tys, txs, r, disk_r2)
    want = lg.scatter_local_ref(g, tys, txs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ordered = bool(torch.equal(got, lg.scatter_local_ordered_ref(
        g, tys, txs, r, disk_r2)))
    ms = cuda_ms(lambda: lg.scatter_local(g, tys, txs, r, disk_r2), 10)
    plain = cuda_ms(lambda: lg.scatter_local_ref(g, tys, txs), 10)
    flat = (tys.long() * w + txs.long()).reshape(-1)
    zero = torch.zeros((h * w, c), device=g.device)
    src = g.reshape(-1, c)
    library = cuda_ms(lambda: torch.index_add(zero, 0, flat, src), 10)
    bnd = bound(4 * (k * h * w * c + 2 * k * h * w + h * w * c), 0)
    print(f"[K4 scatter_local] {label}: K={k} r={r} disk_r2={disk_r2} "
          f"C={c} at {h}x{w}; max |err| {err:.3g} (tolerance 1e-5), "
          f"bit-identical to the sum in the kernel's order {ordered}; "
          f"kernel {ms:.3f} ms, plain {plain:.3f} ms, PyTorch index_add "
          f"{library:.3f} ms, bound {bnd[0]:.3g} ms ({bnd[1]})", flush=True)
    require(err <= 1e-5, f"K4 {label}: max error {err}")
    require(ordered, f"K4 {label}: differs from the sum in its order")
    record("scatter_local", err, ms, plain, bnd, library)


def _demo_kernels(dev, scene, record):
    """K1, K2 and K3 held to their plain versions on the demo's own 1080p
    queries under backend "auto" (the fused one): one ReSTIR frame's
    G-buffer query and first shadow query against its 78 triangles (a
    partial group of 4 rows), and its spatial pass's gather."""
    q = capture_queries(scene, demo_cfg(WIDTH, HEIGHT), dev)
    check_closest("demo frame's G-buffer query", scene, *q["closest_hit"],
                  record)
    check_any("demo frame's first shadow query", scene, *q["any_hit"],
              record)
    check_gather("demo frame's spatial pass", *q["gather_local"], record)


def hold_packets(label, scene, closest_pk, any_pk):
    """K5 and K6 against their plain versions on the packets of a
    G-buffer query and a shadow query: 0 mismatches (ids, t/u/v and masks
    bit for bit) -> a summary of each query."""
    import torch
    res = []
    for kind, pk in (("trace_closest", closest_pk), ("trace_any", any_pk)):
        kernel, plain = _trace_fns(kind, scene)
        got, want = kernel(pk), plain(pk)
        if kind == "trace_closest":
            mis = int((got[3] != want[3]).sum()) + sum(
                int((g != w).sum()) for g, w in zip(got[:3], want[:3]))
            what = f"{int((want[3] >= 0).sum())} hits"
        else:
            mis = int((got != want).sum())
            what = f"{int(want.sum())} occluded"
        res.append(f"{kind} {pk.n_rays} rays, {what}, mismatches {mis}")
        require(mis == 0, f"{label} {kind}: kernel and plain differ")
    torch.cuda.synchronize()
    return res


def _demo_forced_ptrace(dev):
    """Beyond the demo's path: the demo forced to the clustered backend
    (3 clusters of 32), its 1080p G-buffer and shadow queries through
    K5/K6 against their plain versions, 0 mismatches."""
    scene = demo_scene(dev)
    cfg = demo_cfg(WIDTH, HEIGHT, backend="ptrace")
    res = hold_packets("demo ptrace", scene,
                       *capture_packets(scene, cfg, dev))
    print(f"[demo] forced ptrace (C={scene.cluster_tris.shape[0]} clusters "
          f"of {scene.cluster_size}), K5/K6 against their plain versions: "
          + "; ".join(res), flush=True)


def phase_demo(dev, smi, results):
    """The demo asset on the card: load and check it, time 1080p ReSTIR
    and NEE-MIS frames, hold K1-K4 to their plain versions on the demo's
    own queries (errors folded into `results`), the CLI golden on cuda
    (and cpu), the texel and roughness gradients across devices, and the
    demo forced through K5/K6. Returns the K1-K4 and K10 launches:
    K1/K2/K3/K10 of the ReSTIR frames, per frame, and K4's of the 64x32
    texel step."""
    record = recorder(results)
    scene = _demo_load(dev)
    path = _demo_restir(dev, scene, smi)
    _demo_nee(dev, scene, smi)
    _demo_kernels(dev, scene, record)
    _demo_golden()
    step = _demo_grads(record)
    _demo_forced_ptrace(dev)
    out = {k: v // DEMO_FRAMES for k, v in path.items()}
    out["scatter_local"] = step["scatter_local"]
    return out


def _zero_launches():
    from tpu_restir_torch import tracing
    for key in tracing.counted("launch."):
        tracing.COUNTS[key] = 0


def _launches():
    """Each kernel wrapper's launches (`launch.<wrapper>` of
    tracing.COUNTS, 0 from its module's import), by wrapper."""
    from tpu_restir_torch import tracing
    return {k[len("launch."):]: v
            for k, v in tracing.counted("launch.").items()}


def bench_step(dev, width, height, label="cornell"):
    """The bench's forward+backward step (`bench.fwd_bwd_step`) on a scene
    at width x height: a callable params -> (loss, grads) and the
    parameters at the scene's values."""
    from tpu_restir_torch import bench
    scene, view = scene_and_view(label, dev)
    return bench.fwd_bwd_step(scene, bench_cfg(width, height, view), dev)


def phase_fwd_bwd(dev, smi):
    """value_and_grad through one 1080p bench frame: warm-up, then the
    median of 3 timed steps; the launches and traced rays of the last."""
    import torch

    from tpu_restir_torch import metrics, tracing
    from tpu_restir_torch.render import intersect
    vg, params = bench_step(dev, WIDTH, HEIGHT)
    vg(params)                                   # warm-up
    torch.cuda.synchronize()
    times = []
    for i in range(3):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
            _zero_launches()
        with tracing.recording() as rec:     # the last step's is kept
            t0 = time.perf_counter()
            loss, grads = vg(params)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    qlog = intersect.queries(rec)
    launches = {k: v for k, v in _launches().items()
                if k != "shortlist_keys" and not k.startswith("trace_")}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rays = sum(e["rays"] for e in qlog)
    rpp = rays / float(WIDTH * HEIGHT)
    dt = statistics.median(times)
    finite = {k: bool(torch.isfinite(g).all()) for k, g in grads.items()}
    print(f"[fwd+bwd] {WIDTH}x{HEIGHT}, value_and_grad w.r.t. "
          f"{sorted(grads)}: {dt * 1e3:.2f} ms/step (median of "
          f"{[round(t * 1e3, 2) for t in times]}), {rays / dt / 1e6:.2f} "
          f"Mrays/s fwd+bwd, peak memory {peak_gib:.2f} GiB ({smi}); "
          f"traced rays/pixel {rpp} (analytic "
          f"{metrics.rays_per_pixel(bench_cfg(WIDTH, HEIGHT))}), {rays} "
          f"rays; loss {float(loss):.6f}; gradients finite {finite}; "
          f"launches {launches}", flush=True)
    require(rays == 28 * WIDTH * HEIGHT,
            f"traced {rays} rays, want 28/pixel = {28 * WIDTH * HEIGHT}")
    require(all(finite.values()), f"non-finite gradients: {finite}")
    require(math.isfinite(float(loss)), "non-finite loss")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path never launched: {launches}")
    return launches


def phase_grad_small(label="cornell"):
    """Value and gradients at 64x32 on cuda and on cpu (plain versions)."""
    import torch
    out = {}
    for dev in ("cuda", "cpu"):
        vg, params = bench_step(torch.device(dev), SMALL_W, SMALL_H, label)
        loss, grads = vg(params)
        out[dev] = (float(loss), {k: g.cpu() for k, g in grads.items()})
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    worst = 0.0
    for k in gp:
        # rtol 1e-3 of each entry plus 1e-3 of the field's largest entry:
        # CUDA and CPU round sin, pow and exp differently, which can move
        # a reservoir decision of a pixel or two
        scale = float(gp[k].abs().max())
        bad = (gc[k] - gp[k]).abs() - (1e-3 * gp[k].abs() + 1e-3 * scale)
        worst = max(worst, float(bad.max()))
    print(f"[grad cross-device] {label} {SMALL_W}x{SMALL_H}, 1 frame: loss "
          f"cuda "
          f"{lc:.7f} cpu {lp:.7f}; gradients within rtol 1e-3 + 1e-3 x "
          f"field max: {worst <= 0.0} (worst excess {worst:.3g})",
          flush=True)
    require(abs(lc - lp) <= 1e-4 * abs(lp),
            f"{label}: cuda and cpu losses disagree")
    require(worst <= 0.0, f"{label}: cuda and cpu gradients disagree")


def phase_optimize(dev):
    """3 Adam steps of optimize_materials at 1080p from a perturbed white
    albedo, against the render with the true albedo. Each step renders
    with a fresh seed, so its loss carries that frame's noise; the loss is
    compared at the target's own seed (common random numbers, 0 at the
    true albedo) before and after the steps."""
    import torch

    from tpu_restir_torch import cornell_box
    from tpu_restir_torch.diff.optimize import optimize_materials
    from tpu_restir_torch.diff.params import apply_params, extract_params
    from tpu_restir_torch.diff.render import loss_fn, render_with_params
    from tpu_restir_torch.render import camera as cam_mod
    cfg = bench_cfg(WIDTH, HEIGHT)
    scene = cornell_box(dev)
    cam = cam_mod.make_camera(cfg.camera, dev)
    seeds = (5,)
    with torch.no_grad():
        target = render_with_params(extract_params(scene, ("diffuse",)),
                                    scene, cam, cfg, seeds)
        wrong = scene.materials.diffuse.clone()
        wrong[0] = torch.tensor([0.3, 0.5, 0.4], device=dev)
        scene_wrong = apply_params(scene, {"diffuse": wrong})
        before = float(loss_fn({"diffuse": wrong}, scene, cam, cfg, seeds,
                               target))
    t0 = time.perf_counter()
    params, hist = optimize_materials(scene_wrong, cam, cfg, target,
                                      fields=("diffuse",), n_steps=3,
                                      lr=0.06, seed0=seeds[0])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    with torch.no_grad():
        after = float(loss_fn(params, scene, cam, cfg, seeds, target))
    white = [round(v, 4) for v in params["diffuse"][0].tolist()]
    print(f"[optimize] {WIDTH}x{HEIGHT}, 3 Adam steps (lr 0.06) in "
          f"{dt:.2f} s: step losses {[round(h, 6) for h in hist]}; loss at "
          f"the target's seed {before:.6f} -> {after:.6f}; white albedo "
          f"(0.3, 0.5, 0.4) -> {white} (true 0.73)", flush=True)
    require(all(math.isfinite(h) for h in hist + [after]), "non-finite loss")
    require(after < before, f"the loss did not fall: {before} -> {after}")


def _profile(label, fn, path):
    """fn() under torch.profiler, after a warm-up and a timed run without
    it: device time summed over the CUDA kernels only (operator rows
    repeat their kernels' time), the share of K1-K4, and the busy share
    against the wall time of the run without the profiler. Writes the
    table of device time by kernel to path."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # the kernels of csrc/ live in anonymous namespaces (PyTorch's own
    # vectorized_gather_kernel must not match)
    ours = {name: sum(e.self_device_time_total for e in kernels
                      if f"(anonymous namespace)::{tag}" in e.key) / 1e3
            for name, tag in (("closest_hit", "closest_kernel"),
                              ("any_hit", "any_kernel"),
                              ("gather_local", "gather_kernel"),
                              ("scatter_local", "scatter_"),
                              ("trace_closest", "trace_kernel<true, false>"),
                              ("trace_any", "trace_kernel<false, false>"),
                              ("trace_closest_mxu",
                               "trace_kernel<true, true>"),
                              ("trace_any_mxu", "trace_kernel<false, true>"))}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))
    print(f"[profile] {label}: wall {wall_ms:.1f} ms without the profiler; "
          f"device kernels {device_ms:.1f} ms in "
          f"{sum(e.count for e in kernels)} launches, busy share "
          f"{device_ms / wall_ms:.3f}; K1-K8 ms "
          f"{ {k: round(v, 3) for k, v in ours.items()} } "
          f"({sum(ours.values()) / device_ms:.3f} of device time); table in "
          f"{path}", flush=True)


def phase_profile(dev, path):
    """Two 1080p forward frames, one 1080p fwd+bwd step and one 1080p
    frame of each clustered scene under torch.profiler; the tables go to
    PATH and to PATH with _fwd_bwd, _terrain100k, _lights1k or
    _terrain100k-128 before the
    extension."""
    from tpu_restir_torch import cornell_box
    cfg = bench_cfg(WIDTH, HEIGHT)
    scene = cornell_box(dev)
    _profile("2 forward frames", lambda: run_frames(scene, cfg, dev, 2),
             path)
    vg, params = bench_step(dev, WIDTH, HEIGHT)
    root, ext = os.path.splitext(path)
    _profile("1 fwd+bwd step", lambda: vg(params), f"{root}_fwd_bwd{ext}")
    for label in ("terrain100k", "lights1k", "terrain100k-128"):
        big, view = large_scene(label, dev)
        bcfg = bench_cfg(WIDTH, HEIGHT, view, mxu=label.endswith("-128"))
        _profile(f"1 {label} frame",
                 lambda: run_frames(big, bcfg, dev, 1),
                 f"{root}_{label}{ext}")


# ---------------------------------------------------------------------------
# [backends]: the JAX package's fallback intersection backends, plain tensor
# code on the card (render/intersect.py), held to the kernels on the same rays
# ---------------------------------------------------------------------------

BACKEND_RUNS = (("cornell", ("brute", "woop_mxu")),
                ("lights1k", ("cluster", "fcluster", "bvh")))
BACKEND_GRADS = (("cornell", "brute"), ("lights1k", "fcluster"))
REL_T_TIE = 1e-6   # winners this close in t are a near tie (woop_mxu vs K1)


@contextlib.contextmanager
def queries_of(n, got):
    """Wraps intersect.intersect_closest and intersect_any for the block:
    the flat rays (o, d, tnear, tfar) of the first closest-hit and the
    first any-hit query of n rays into got["closest"] and got["any"]."""
    from tpu_restir_torch.render import intersect
    names = {"closest": "intersect_closest", "any": "intersect_any"}
    orig = {k: getattr(intersect, v) for k, v in names.items()}

    def wrap(kind):
        def call(scene, o, d, tnear, tfar, *args, **kwargs):
            if kind not in got and o[..., 0].numel() == n:
                got[kind] = tuple(x.detach().clone() for x in
                                  intersect._flat_rays(o, d, tnear, tfar)[1:])
            return orig[kind](scene, o, d, tnear, tfar, *args, **kwargs)
        return call

    for kind, name in names.items():
        setattr(intersect, name, wrap(kind))
    try:
        yield got
    finally:
        for kind, name in names.items():
            setattr(intersect, name, orig[kind])


def _backend_cfg(view, backend):
    """The 1080p bench config with every scene query under backend."""
    from tpu_restir_torch.config import IntersectorConfig
    return bench_cfg(WIDTH, HEIGHT, view).replace(
        intersector=IntersectorConfig(backend=backend))


def _closest(scene, rays, backend):
    """A closest-hit query of flat rays under `backend` -> (t, u, v, tri)
    with t = inf on a miss."""
    import torch

    from tpu_restir_torch.config import IntersectorConfig
    from tpu_restir_torch.render import intersect
    h = intersect.intersect_closest(scene, *rays,
                                    IntersectorConfig(backend=backend))
    return torch.where(h.hit, h.t, math.inf), h.u, h.v, h.tri


def _occluded(scene, rays, backend):
    from tpu_restir_torch.config import IntersectorConfig
    from tpu_restir_torch.render import intersect
    return intersect.intersect_any(scene, *rays,
                                   IntersectorConfig(backend=backend))


def slack_edge(u, v):
    """Woop barycentrics within the test's 1e-5 slack of an edge."""
    return (u < BARY_EPS) | (v < BARY_EPS) | (1.0 - u - v < BARY_EPS)


# float32 roundings that a test's value may carry, per unit of the summed
# magnitudes of its terms (the maps' own rounding from float64 included)
ERR_ULPS = 8
EPS32 = 2.0 ** -24


def _pairs64(scene, rays, idx):
    """float64 copies of the rays idx and of every triangle, for pair-wise
    error bounds: (o, d, tn, tf) each (R, 1, ...), Woop rows (1, T, 12),
    v0, e1, e2 (1, T, 3)."""
    from tpu_restir_torch.kernels import ray_tri
    o, d, tn, tf = (x[idx].double() for x in rays)
    return (o[:, None], d[:, None], tn[:, None], tf[:, None],
            ray_tri.woop_rows(scene).double()[None],
            scene.tri_v0.double()[None], scene.tri_e1.double()[None],
            scene.tri_e2.double()[None])


def woop_uncertain(scene, rays, idx):
    """(accept, uncertain) of the Woop test, as K1/K2 compute it, for the
    rays idx against every triangle: could float32 rounding move any of
    its values (t, u, v) across a bound of the test (tnear, tfar, the
    slack edges)? The forward error bounds: o'_c and d'_c within
    ERR_ULPS ulps of the sum of their terms' magnitudes, t = -o'_w / d'_w
    within (err o'_w + |t| err d'_w) / |d'_w|, u = o'_u + t d'_u within err
    o'_u + |t| err d'_u + |d'_u| err t. A grazing ray to a small triangle
    (a ceiling point's shadow ray to a light of lights1k) can carry an
    error of 1e-3 in t."""
    import torch

    from tpu_restir_torch.kernels import ray_tri
    o, d, tn, tf, w, _v0, _e1, _e2 = _pairs64(scene, rays, idx)
    o32, d32, tn32, tf32 = (x[idx] for x in rays)
    t, u, v, ok = ray_tri._woop_tuvok(o32, d32, tn32, tf32,
                                      ray_tri.woop_rows(scene))
    t, u, v = t.double(), u.double(), v.double()

    def mags(c):
        mo = sum((w[..., 4 * c + i] * o[..., i]).abs() for i in range(3)) \
            + w[..., 4 * c + 3].abs()
        md = sum((w[..., 4 * c + i] * d[..., i]).abs() for i in range(3))
        lin = sum(w[..., 4 * c + i] * d[..., i] for i in range(3))
        return ERR_ULPS * EPS32 * mo, ERR_ULPS * EPS32 * md, lin

    eo_w, ed_w, dw = mags(2)
    tt = torch.where(torch.isfinite(t), t, 0.0)
    et = (eo_w + tt.abs() * ed_w) / dw.abs()
    eu, ev = ((eo + tt.abs() * ed + lin.abs() * et)
              for eo, ed, lin in (mags(0), mags(1)))
    s = BARY_EPS
    unsure = (((u + s).abs() <= eu) | ((v + s).abs() <= ev)
              | ((1.0 + s - u - v).abs() <= eu + ev)
              | ((t - tn).abs() <= et)
              | ((t - tf).abs() <= et))
    return ok, unsure & torch.isfinite(t)


def mt_uncertain(scene, rays, idx):
    """(accept, uncertain, slack) of the Moller-Trumbore test, as K5/K6
    compute it, for the rays idx against every triangle: uncertain where
    float32 rounding could move t, u or v across a bound of the test
    (errors within ERR_ULPS ulps of the magnitudes |e1||d||e2| of det,
    |tv||d||e2| of u det, |d||tv||e1| of v det, |e2||tv||e1| of t det);
    slack where the float64 values lie within the Woop test's 1e-5 slack
    outside an edge, with t in [tnear, tfar] (what the Woop test accepts
    and this one does not)."""
    import torch

    from tpu_restir_torch.render import intersect
    o, d, tn, tf, _w, v0, e1, e2 = _pairs64(scene, rays, idx)
    o32, d32, tn32, tf32 = (x[idx] for x in rays)
    t, u, v, ok = intersect._mt_block(o32, d32, scene.tri_v0, scene.tri_e1,
                                      scene.tri_e2)
    ok = ok & (t >= tn32[:, None]) & (t <= tf32[:, None])
    n = lambda x: x.norm(dim=-1)   # noqa: E731
    tv = o - v0
    p = torch.linalg.cross(d, e2, dim=-1)
    det = (e1 * p).sum(-1)
    q = torch.linalg.cross(tv, e1, dim=-1)
    u64, v64 = (tv * p).sum(-1) / det, (d * q).sum(-1) / det
    t64 = (e2 * q).sum(-1) / det
    c = ERR_ULPS * EPS32
    edet = c * n(e1) * n(d) * n(e2)
    t, u, v = t.double(), u.double(), v.double()
    eu = (c * n(tv) * n(d) * n(e2) + u.abs() * edet) / det.abs()
    ev = (c * n(d) * n(tv) * n(e1) + v.abs() * edet) / det.abs()
    et = (c * n(e2) * n(tv) * n(e1) + t.abs() * edet) / det.abs()
    unsure = ((u.abs() <= eu) | (v.abs() <= ev)
              | ((1.0 - u - v).abs() <= eu + ev)
              | ((t - tn).abs() <= et)
              | ((t - tf).abs() <= et))
    edge = torch.minimum(torch.minimum(u64, v64), 1.0 - u64 - v64)
    slack = ((edge >= -BARY_EPS) & (edge < 0.0) & (t64 >= tn)
             & (t64 <= tf))
    return ok, unsure & torch.isfinite(det) & (det != 0), slack


def unexplained(scene, rays, idx, woop_side):
    """Of the rays idx, whose occlusion the Woop test and Moller-Trumbore
    decide apart, the count not explained. Both tests are recomputed on
    the rays: the occluding side's test (the Woop test where woop_side)
    must accept some pair of the ray, and each pair that either test
    accepts must be one that float32 rounding could flip in either test,
    or one within the slack band."""
    if not idx.numel():
        return 0
    w_ok, w_unsure = woop_uncertain(scene, rays, idx)
    m_ok, m_unsure, slack = mt_uncertain(scene, rays, idx)
    fine = w_unsure | m_unsure | slack
    occluder = (w_ok if woop_side else m_ok).any(1)
    return int((((w_ok | m_ok) & ~fine).any(1) | ~occluder).sum())


def hold_to_woop_kernel(label, scene, rays, got, want):
    """A Woop-test backend's closest hits (got) against a Woop kernel's
    (want, K1) on the same rays: masks equal; ids equal except near ties
    (winners' t within REL_T_TIE, counted); the largest t/u/v difference on
    equal ids, which must be 0 (K1's plain test in its operation order)."""
    hit = want[3] >= 0
    masks = int(((got[3] >= 0) != hit).sum())
    diff = hit & (got[3] != want[3])
    near = diff & ((got[0] - want[0]).abs()
                   <= REL_T_TIE * want[0].abs())
    same = hit & ~diff
    err = max(float((g[same] - w[same]).abs().max()) if same.any() else 0.0
              for g, w in zip(got[:3], want[:3]))
    print(f"[backends] {label}: {int(hit.sum())} hits of "
          f"{hit.numel()} rays; mask mismatches {masks} (must be 0); id "
          f"mismatches {int(diff.sum())}, of them near ties (t within "
          f"{REL_T_TIE} t) {int(near.sum())} (all must be); max |t,u,v "
          f"err| on equal ids {err:.3g} (bound 0: the products summed in "
          f"K1's order)", flush=True)
    require(masks == 0, f"{label}: hit masks differ")
    require(bool((near == diff).all()), f"{label}: ids differ beyond ties")
    require(err == 0.0, f"{label}: t/u/v differ by {err}")


def hold_mt_to_woop(label, scene, rays, got, want):
    """A Moller-Trumbore backend (no slack; got) against a Woop test with
    the 1e-5 slack (want): the hits of got are a subset of want's, and
    every ray that want hits and got misses, or whose ids differ, has its
    Woop winner within the slack of an edge. Returns the counts."""
    hit_g, hit_w = got[3] >= 0, want[3] >= 0
    extra = int((hit_g & ~hit_w).sum())
    missed = hit_w & ~hit_g
    diff = hit_g & hit_w & (got[3] != want[3])
    edge = slack_edge(want[1], want[2])
    bad = int(((missed | diff) & ~edge).sum())
    same = hit_g & hit_w & ~diff
    rel = float(((got[0] - want[0]).abs() / want[0].abs())[same].max()) \
        if same.any() else 0.0
    print(f"[backends] {label}: hits {int(hit_g.sum())} against "
          f"{int(hit_w.sum())} of the Woop test; outside its hits {extra} "
          f"(must be 0); missed {int(missed.sum())} and id mismatches "
          f"{int(diff.sum())}, of them with the Woop winner off the slack "
          f"edge band {bad} (must be 0); max |t| rel diff on equal ids "
          f"{rel:.3g} (Moller-Trumbore and Woop t round apart)", flush=True)
    require(extra == 0, f"{label}: hits outside the Woop test's")
    require(bad == 0, f"{label}: differences away from the slack band")


def hold_occlusion(label, scene, rays, got, want, woop_got):
    """Occlusion of a backend (got) against a kernel's (want): equal when
    both tests are alike (woop_got None); a Woop backend against a
    Moller-Trumbore kernel (woop_got True), or the reverse (False), may
    differ only on rays whose occluders all sit within float32 rounding
    of a bound of either test, or within the slack band (`unexplained`)."""
    import torch
    if woop_got is None:
        mis = int((got != want).sum())
        print(f"[backends] {label}: occluded {int(want.sum())} of "
              f"{want.numel()}; mask mismatches {mis} (must be 0)",
              flush=True)
        require(mis == 0, f"{label}: occlusion masks differ")
        return
    woop, mt = (got, want) if woop_got else (want, got)
    w_only = torch.nonzero(woop & ~mt)[:, 0]
    m_only = torch.nonzero(mt & ~woop)[:, 0]
    bad = unexplained(scene, rays, w_only, True) \
        + unexplained(scene, rays, m_only, False)
    print(f"[backends] {label}: occluded {int(got.sum())} against "
          f"{int(want.sum())}; occluded by the Woop test only "
          f"{w_only.numel()}, by Moller-Trumbore only {m_only.numel()}, of "
          f"them with an occluder that neither float32 rounding nor the "
          f"slack explains {bad} (must be 0)", flush=True)
    require(bad == 0, f"{label}: occlusion differs beyond rounding and "
            "slack")


def hold_mt_to_k5(label, scene, rays, got, brute=None):
    """A Moller-Trumbore backend (fcluster, bvh; got) against K5 on the
    same flat rays: masks equal, ids equal but for exact-t ties (counted),
    t bit-identical (and to brute's where given)."""
    from tpu_restir_torch.kernels import cluster_trace as ct
    want = ct.trace_closest(scene.cluster_tris, scene.cluster_min,
                            scene.cluster_max, *rays)
    hit = want[3] >= 0
    masks = int(((got[3] >= 0) != hit).sum())
    diff = hit & (got[3] != want[3])
    t_same = bool((got[0][hit] == want[0][hit]).all())
    same = hit & ~diff
    uv = max(float((g[same] - w[same]).abs().max()) if same.any() else 0.0
             for g, w in zip(got[1:3], want[1:3]))
    line = (f"[backends] {label}: {int(hit.sum())} hits of {hit.numel()} "
            f"rays against K5; mask mismatches {masks} (must be 0); exact-t "
            f"ties with another id {int(diff.sum())}; t bit-identical "
            f"{t_same}; max |u,v err| on equal ids {uv:.3g} (0 expected)")
    if brute is not None:
        bt = bool(((got[0] == brute[0]) | ~hit).all()
                  and ((brute[3] >= 0) == hit).all())
        line += f"; t bit-identical to brute {bt}"
        require(bt, f"{label}: t differs from brute's")
    print(line, flush=True)
    require(masks == 0, f"{label}: hit masks differ from K5's")
    require(t_same and uv == 0.0, f"{label}: t/u/v differ from K5's")


def hold_cluster_to_k5(label, scene, rays, got):
    """The cluster backend (Woop, slack; got) against K5 (Moller-Trumbore)
    on the same rays: got's hits a superset of K5's, and every difference
    a ray whose cluster winner lies within the slack of an edge."""
    from tpu_restir_torch.kernels import cluster_trace as ct
    want = ct.trace_closest(scene.cluster_tris, scene.cluster_min,
                            scene.cluster_max, *rays)
    hit_g, hit_k = got[3] >= 0, want[3] >= 0
    lost = int((hit_k & ~hit_g).sum())
    differ = hit_g & (~hit_k | (got[3] != want[3]))
    bad = int((differ & ~slack_edge(got[1], got[2])).sum())
    print(f"[backends] {label}: hits {int(hit_g.sum())} against K5's "
          f"{int(hit_k.sum())}; K5 hits missed {lost} (must be 0); rays "
          f"that differ {int(differ.sum())}, of them off the slack band "
          f"{bad} (must be 0)", flush=True)
    require(lost == 0, f"{label}: K5 hits missed")
    require(bad == 0, f"{label}: differences away from the slack band")


def _backend_frame(scene, view, backend, dev, smi):
    """One 1080p bench frame under backend: traced rays per pixel 28.0, a
    finite image; ms (CUDA events after a synchronize), peak memory, host
    syncs and the query census printed -> the frame's first full-frame
    closest and any queries (flat rays)."""
    import torch

    from tpu_restir_torch import metrics, roofline, tracing
    from tpu_restir_torch.render import intersect
    cfg = _backend_cfg(view, backend)
    got = {}
    syncs = tracing.counted("sync.")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with tracing.recording() as rec, queries_of(WIDTH * HEIGHT, got):
        a.record()
        img, _state = run_frames(scene, cfg, dev, 1)
        b.record()
        torch.cuda.synchronize()
    qlog = intersect.queries(rec)
    ms = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rpp = sum(e["rays"] for e in qlog) / float(WIDTH * HEIGHT)
    synced = {k[len("sync."):]: v - syncs.get(k, 0)
              for k, v in tracing.counted("sync.").items()
              if v != syncs.get(k, 0)}
    backends = sorted({e["backend"] for e in qlog})
    print(f"[backends] {backend} frame, {scene.num_tris} tris, "
          f"{WIDTH}x{HEIGHT}: {ms:.1f} ms ({smi}), peak memory {peak:.2f} "
          f"GiB, host syncs {synced}; traced rays/pixel {rpp} (analytic "
          f"{metrics.rays_per_pixel(cfg)}); queries "
          f"{roofline.summarize_query_log(rec)}", flush=True)
    require(tuple(img.shape) == (HEIGHT, WIDTH, 3)
            and bool(torch.isfinite(img).all()),
            f"{backend}: a bad image")
    require(rpp == 28.0, f"{backend}: traced {rpp} rays/pixel, not 28")
    require(backends == [backend], f"{backend}: queries went to {backends}")
    require(set(got) == {"closest", "any"},
            f"{backend}: no full-frame query of kind "
            f"{ {'closest', 'any'} - set(got)}")
    return got["closest"], got["any"]


def _timed_query(fn, label):
    """fn() once, its ms (CUDA events after a synchronize) and peak
    memory printed -> its result."""
    import torch

    from tpu_restir_torch import tracing
    syncs = tracing.counted("sync.")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    synced = {k[len("sync."):]: v - syncs.get(k, 0)
              for k, v in tracing.counted("sync.").items()
              if v != syncs.get(k, 0)}
    print(f"[backends] {label}: {a.elapsed_time(b):.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, host "
          f"syncs {synced}", flush=True)
    return out


def _backend_grads(dev):
    """d/d(o, d) of sum(t w0 + u w1 + v w2) over a 64x32 G-buffer query
    under brute (Cornell: autograd through its operations) and fcluster
    (lights1k: the detached-winner derivative), cuda against cpu, within
    the demo gradient's limit: rtol 1e-4 plus 1e-5 of the largest entry."""
    import torch

    from tpu_restir_torch.config import IntersectorConfig
    from tpu_restir_torch.render import intersect
    rtol, frac = GRAD_TOL
    for label, backend in BACKEND_GRADS:
        scene, view = scene_and_view(label, dev)
        rays = {}
        with queries_of(SMALL_W * SMALL_H, rays):
            run_frames(scene, bench_cfg(SMALL_W, SMALL_H, view), dev, 1)
        w = torch.randn((3, SMALL_W * SMALL_H), device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
        out = {}
        for device in (dev, torch.device("cpu")):
            sc = scene_and_view(label, device)[0]
            o, d, tn, tf = (x.to(device) for x in rays["closest"])
            o.requires_grad_(True)
            d.requires_grad_(True)
            h = intersect.intersect_closest(
                sc, o, d, tn, tf, IntersectorConfig(backend=backend))
            ww = w.to(device)
            loss = (torch.where(h.hit, h.t, 0.0) * ww[0] + h.u * ww[1]
                    + h.v * ww[2]).sum()
            out[device.type] = [g.cpu() for g in
                                torch.autograd.grad(loss, (o, d))]
        worst = 0.0
        for gc, gp in zip(out[dev.type], out["cpu"]):
            scale = float(gp.abs().max())
            require(scale > 0.0, f"{label} {backend}: a zero gradient")
            bad = (gc - gp).abs() - (rtol * gp.abs() + frac * scale)
            worst = max(worst, float(bad.max()))
        print(f"[backends] gradient cross-device {backend} on {label}, "
              f"{SMALL_W}x{SMALL_H} G-buffer query: within rtol {rtol} + "
              f"{frac} x largest entry {worst <= 0.0} (worst excess "
              f"{worst:.3g})", flush=True)
        require(worst <= 0.0, f"{label} {backend}: cuda and cpu gradients "
                "disagree")


def phase_backends(dev, smi):
    """The [backends] phase (module docstring, step 13)."""
    import torch

    from tpu_restir_torch.accel import bvh as bvh2_mod
    from tpu_restir_torch.accel import wide
    from tpu_restir_torch.kernels import cluster_trace as ct
    from tpu_restir_torch.kernels import ray_tri
    from tpu_restir_torch.scene.procedural import terrain_scene
    t0 = time.perf_counter()
    print(smi, flush=True)
    # the wide BVH's share of a clustered scene's build, on this host
    tv = large_scene("terrain100k", dev)[0].tri_v.cpu().numpy()
    b2 = bvh2_mod.build_bvh2(tv, leaf_size=4)
    t1 = time.perf_counter()
    w8 = wide.collapse_bvh8(b2)
    print(f"[backends] terrain100k: collapse_bvh8 {time.perf_counter() - t1:.2f}"
          f" s on the host ({w8.meta.shape[0]} wide nodes, depth "
          f"{w8.max_depth}), part of build_scene", flush=True)
    for label, backends in BACKEND_RUNS:
        scene, view = scene_and_view(label, dev)
        for backend in backends:
            closest, shadow = _backend_frame(scene, view, backend, dev, smi)
            got = _timed_query(lambda: _closest(scene, closest, backend),
                               f"{backend} {label} G-buffer query")
            occ = _timed_query(lambda: _occluded(scene, shadow, backend),
                               f"{backend} {label} first shadow query")
            tag = f"{backend} {label}"
            if backend == "woop_mxu":
                k1 = ray_tri.closest_hit(scene, *closest)
                hold_to_woop_kernel(f"{tag} G-buffer query vs K1", scene,
                                    closest, got, k1)
                hold_occlusion(f"{tag} shadow query vs K2", scene, shadow,
                               occ, ray_tri.any_hit(scene, *shadow), None)
            elif backend == "brute":
                k1 = ray_tri.closest_hit(scene, *closest)
                hold_mt_to_woop(f"{tag} G-buffer query vs K1", scene,
                                closest, got, k1)
                hold_occlusion(f"{tag} shadow query vs K2", scene, shadow,
                               occ, ray_tri.any_hit(scene, *shadow), False)
            else:
                k6 = ct.trace_any(scene.cluster_tris, scene.cluster_min,
                                  scene.cluster_max, *shadow)
                if backend == "cluster":
                    hold_cluster_to_k5(f"{tag} G-buffer query vs K5", scene,
                                       closest, got)
                    hold_occlusion(f"{tag} shadow query vs K6", scene,
                                   shadow, occ, k6, True)
                else:
                    brute = _closest(scene, closest, "brute")
                    hold_mt_to_k5(f"{tag} G-buffer query vs K5", scene,
                                  closest, got, brute)
                    hold_occlusion(f"{tag} shadow query vs K6", scene,
                                   shadow, occ, k6, None)
                    hold_occlusion(f"{tag} shadow query vs brute", scene,
                                   shadow, occ, _occluded(scene, shadow,
                                                          "brute"), None)
    # full scale: fcluster on terrain100k's queries (taken from a frame of
    # the default backend), bvh on terrain_scene(20_000)'s G-buffer query
    for label, backend in (("terrain100k", "fcluster"),
                           ("terrain20k", "bvh")):
        if label == "terrain20k":
            scene, view = terrain_scene(dev, 20_000), TERRAIN_VIEW
        else:
            scene, view = large_scene(label, dev)
        rays = {}
        with queries_of(WIDTH * HEIGHT, rays):
            run_frames(scene, bench_cfg(WIDTH, HEIGHT, view), dev, 1)
        got = _timed_query(lambda: _closest(scene, rays["closest"], backend),
                           f"{backend} {label} G-buffer query")
        hold_mt_to_k5(f"{backend} {label} G-buffer query vs K5", scene,
                      rays["closest"], got)
        if backend == "fcluster":
            occ = _timed_query(
                lambda: _occluded(scene, rays["any"], backend),
                f"{backend} {label} first shadow query")
            hold_occlusion(f"{backend} {label} shadow query vs K6", scene,
                           rays["any"], occ, ct.trace_any(
                               scene.cluster_tris, scene.cluster_min,
                               scene.cluster_max, *rays["any"]), None)
    _backend_grads(dev)
    print(f"[backends] phase {time.perf_counter() - t0:.1f} s", flush=True)


TOOLS_RANKS = 2       # scaling_bench's ranks, sharing cuda:0 under gloo
TOOLS_RADIUS = 4.0    # scaling_bench's spatial radius (the JAX tool's)
TOOLS_FRAMES = 4      # scaling_bench's chained frames a window (3 windows)


def phase_tools(dev, smi):
    """[tools]: the JAX system's profiling and scaling tools, as the port
    has them, at 1920x1080: `tools.profile_ptrace` and
    `tools.profile_phase1` on terrain100k's primary-ray query (the phase
    split of a clustered closest query, K5 launched; phase 1's
    alternatives, the full sort's slots equal to `build_shortlists`, top-k
    differing only on equal-key ties, the compaction listing the same
    clusters where it holds them all), then `tools.scaling_bench` with
    TOOLS_RANKS ranks sharing the card (its halo width the port's
    `halo_width`, bytes sent and staged). Each tool's lines and its JSON
    line are printed."""
    from tpu_restir_torch import tracing
    from tpu_restir_torch.dist.halo import halo_width
    from tpu_restir_torch.tools import (profile_phase1, profile_ptrace,
                                        scaling_bench)
    t0 = time.perf_counter()
    scene, _view = large_scene("terrain100k", dev)
    for tool in (profile_ptrace, profile_phase1):
        name = tool.__name__.rsplit(".", 1)[1]
        before = tracing.COUNTS["launch.trace_closest"]
        r = tool.measure(dev, width=WIDTH, height=HEIGHT, scene=scene)
        for line in tool.report(r).splitlines():
            print(f"[tools] {name} terrain100k {WIDTH}x{HEIGHT}: {line}",
                  flush=True)
        print(f"[tools] {name} {json.dumps(r)} ({smi})", flush=True)
        if tool is profile_ptrace:
            require(tracing.COUNTS["launch.trace_closest"] > before
                    and r["count"]["max"] > 0,
                    "profile_ptrace: K5 not launched, or empty shortlists")
        else:
            require(r["full_sort_mismatches"] == 0,
                    "profile_phase1: the full sort differs from phase 1")
            require(r["key_build_k9_mismatches"] == 0,
                    "profile_phase1: K9's keys differ from the plain ones")
            require(all(r[f"topk{k}"]["mismatches"]
                        == r[f"topk{k}"]["tie_mismatches"]
                        for k in profile_phase1.TOPK),
                    "profile_phase1: top-k differs beyond equal-key ties")
            e = r[f"compact{profile_phase1.COMPACT}"]
            require(e["set_equal"] == e["packets_within"],
                    "profile_phase1: the compaction lists other clusters")
    r = scaling_bench.measure(res=HEIGHT, width=WIDTH, frames=TOOLS_FRAMES,
                              n_devices=TOOLS_RANKS, radius=TOOLS_RADIUS,
                              device=dev, reps=3)
    print(f"[tools] scaling_bench ({TOOLS_RANKS} ranks sharing one card "
          f"under gloo: what sharding adds, not a speed-up) {json.dumps(r)} "
          f"({smi})", flush=True)
    require(r["halo_rows"] == halo_width(TOOLS_RADIUS)
            and r["halo_bytes_measured_per_frame_per_device"] > 0
            and r["staged_bytes_per_frame_per_device"] > 0,
            f"scaling_bench: halo or bytes wrong: {r}")
    print(f"[tools] phase {time.perf_counter() - t0:.1f} s", flush=True)


# the [bench] phase: the labels of the bench line's secondary entries and
# the kernels of the bench's path (K1-K6; ptrace_mxu is off in the bench)
BENCH_ENTRIES = ("lights1k", "terrain100k", "terrain1M")
BENCH_KERNELS = ("closest_hit", "any_hit", "gather_local", "scatter_local",
                 "trace_closest", "trace_any")


def phase_bench(dev, smi, results):
    """[bench]: `tpu_restir_torch.bench` run in this process (its terrain1M
    child a process of its own, which must load the kernels that this one
    built), the launch counts zeroed just before and read just after; its
    last line parsed: bench.py's keys and metric, a traced rays per pixel
    of 28.0 (the analytic count) on Cornell, lights1k, terrain100k and
    terrain1M, no "failed:" entry; every frame and the step finite, the
    exact traced rays 28 a pixel, terrain1M at factor 4 with cull mode 5
    on per-cluster boxes; K1-K6 launched and K7/K8 not. Then terrain1M
    built here: K5 on its frame's G-buffer query and K6 on its first
    shadow query and on the G-buffer rays as occlusion rays, against
    their plain versions (0 mismatches, t/u/v bit-identical). Then the
    whole-frame roofline (`tools.roofline_frame`) once, its blocks
    printed. -> the bench's launch counts."""
    import io
    import re

    import torch

    from tpu_restir_torch import bench, metrics
    from tpu_restir_torch.tools import roofline_frame
    t0 = time.perf_counter()
    _zero_launches()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            _obj, report = bench.main(["--device", str(dev)])
    finally:
        print(buf.getvalue(), end="", flush=True)
    launches = _launches()
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    unit = line["unit"]
    n_pix = WIDTH * HEIGHT
    analytic = metrics.rays_per_pixel(bench_cfg(WIDTH, HEIGHT))
    require(list(line) == ["metric", "value", "unit", "vs_baseline"]
            and line["metric"] == bench.METRIC,
            f"the bench line lacks bench.py's keys or metric: {line}")
    require("failed:" not in unit, f"a bench entry failed: {unit}")
    main_rpp = re.search(r"rpp ([0-9.]+) traced/([0-9]+) analytic\)$", unit)
    require(main_rpp is not None
            and float(main_rpp.group(1)) == float(analytic) == 28.0
            and int(main_rpp.group(2)) == analytic,
            f"Cornell's traced rays per pixel: {unit}")
    for label in BENCH_ENTRIES:
        m = re.search(rf"{label} ([0-9.]+) \(rpp ([0-9.]+)\)", unit)
        require(m is not None and float(m.group(2)) == float(analytic),
                f"{label}: no entry with {analytic}.0 traced rays per "
                f"pixel in {unit}")
    t1m = report["terrain1M"]
    require(t1m is not None, "the terrain1M child printed no info line")
    report["rays"]["terrain1M"] = t1m["rays"]
    report["finite"]["terrain1M"] = t1m["finite"]
    require(all(v == analytic * n_pix for v in report["rays"].values()),
            f"traced rays a frame {report['rays']}, want {analytic * n_pix}")
    require(all(report["finite"].values()) and report["step_finite"],
            f"non-finite frames or step: {report['finite']}, step "
            f"{report['step_finite']}")
    require(t1m["factor"] == 4 and t1m["cull_modes"]
            == {"closest": 5, "any": 5} and t1m["per_cluster_boxes"],
            f"terrain1M is not at factor 4 in cull mode 5 on per-cluster "
            f"boxes: {t1m}")
    require(not t1m["rebuilt_kernels"],
            f"the terrain1M child rebuilt {t1m['rebuilt_kernels']}")
    missing = [k for k in BENCH_KERNELS if not launches[k]]
    require(not missing, f"kernels of the bench's path never launched: "
            f"{missing} ({launches})")
    require(not launches["trace_closest_mxu"]
            and not launches["trace_any_mxu"],
            f"K7/K8 ran with ptrace_mxu off: {launches}")
    print(f"[bench] line parsed: {line['value']} Mrays/s fwd+bwd; traced "
          f"rays a frame {report['rays']}; ms/frame "
          + ", ".join(f"{k} {v:.2f}" for k, v in report["ms_frame"].items())
          + f", terrain1M {t1m['ms_frame']:.2f}; step {report['step_ms']:.2f}"
          f" ms; peak memory "
          + ", ".join(f"{k} {bench.fmt_gib(v)}"
                      for k, v in report["peak_gib"].items())
          + f", terrain1M {bench.fmt_gib(t1m['peak_gib'])}; terrain1M "
          f"build " + ", ".join(f"{k} {v:.2f} s" for k, v
                                in t1m["build_seconds"].items())
          + f"; launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)

    t1 = time.perf_counter()
    build, view = SCENES["terrain1M"]
    scene = build(dev)
    print(f"[bench] terrain1M rebuilt here for the K5/K6 hold in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    closest_pk, any_pk = capture_packets(scene, bench_cfg(WIDTH, HEIGHT,
                                                          view), dev)
    require(closest_pk.factor == any_pk.factor == 4,
            f"terrain1M packets at factor {closest_pk.factor}")
    hold_keys("terrain1M", scene, "G-buffer primary rays", closest_pk,
              results)
    hold_keys("terrain1M", scene, "area-candidate shadow rays", any_pk,
              results)
    sides = [hold_trace("terrain1M", scene, kind, label, pk, results)
             for kind, label, pk in (
                 ("trace_closest", "G-buffer primary rays", closest_pk),
                 ("trace_any", "area-candidate shadow rays", any_pk),
                 ("trace_any", "G-buffer rays as occlusion rays",
                  closest_pk))]
    require(any(sides), "K6 on terrain1M not held to a query with both "
            "occluded and visible rays")
    # phase 1 alone (cluster_trace.pack: the scene-box clamp and the dense
    # (packets, superclusters) shortlists) on the same rays, and the memory
    # it holds beyond what was allocated before it
    from tpu_restir_torch.kernels import cluster_trace as ct
    for label, pk in (("G-buffer", closest_pk), ("shadow", any_pk)):
        rays = (pk.o[:pk.n_rays], pk.d[:pk.n_rays], pk.tnear[:pk.n_rays],
                pk.tfar[:pk.n_rays])
        args = (scene.cluster_min, scene.cluster_max, *rays, pk.factor)
        ms = cuda_ms(lambda: ct.pack(*args), 3)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ct.pack(*args)
        torch.cuda.synchronize()
        extra_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f"[bench] terrain1M phase 1 ({label} query, {pk.n_rays} rays, "
              f"{pk.count.shape[0]} packets x S={pk.shortlist.shape[1]}): "
              f"{ms:.3f} ms a query; x 28 queries {28 * ms:.1f} ms = "
              f"{28 * ms / t1m['ms_frame']:.1%} of the child's "
              f"{t1m['ms_frame']:.1f} ms/frame; transient memory "
              f"{extra_gib:.2f} GiB ({smi})", flush=True)
    del scene, closest_pk, any_pk
    torch.cuda.empty_cache()

    t2 = time.perf_counter()
    roofline_frame.main(["--device", str(dev)])
    print(f"[bench] the whole-frame roofline ({roofline_frame.INNER} chained "
          f"frames a prefix) in {time.perf_counter() - t2:.1f} s; the phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


DIST_RANKS = 2    # ranks of the [dist] phase, sharing cuda:0 under gloo
DIST_SIZE = (1920, 1080)
DIST_FRAMES = 3   # sharded bench frames; the first is the warm-up
DIST_FALLBACK = (64, 8)   # 4-row shards: halo 7 takes the all-gather


def _dist_rank(rank, n, port, outdir):
    """One rank of the [dist] phase: joins the gloo group over localhost,
    renders on cuda:0 and writes what it measured to outdir."""
    import datetime

    import torch
    import torch.distributed as dist
    # a collective that waits longer than this raises on every rank
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=300))
    try:
        out = _dist_checks(torch.device("cuda:0"))
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _dist_checks(dev):
    """The [dist] phase on one rank: DIST_FRAMES sharded Cornell bench
    frames at 1080p (launch counts zeroed before, read after), held on
    rank 0 to the one-device frames bit for bit; K1, K2 and K3 (its
    spatial gather at top = halo, its temporal tap of the extended
    payload) against their plain versions on the rank's own queries of
    those frames; a sharded fwd+bwd step against the one-device step; the
    all-gather fallback at DIST_FALLBACK; one lights1k frame against one
    device, and K5/K6 against their plain versions on the rank's own
    packets of it. The ranks share the card, so they run the kernel
    checks in turn."""
    import torch

    from tpu_restir_torch import cornell_box, rng
    from tpu_restir_torch.diff.params import extract_params
    from tpu_restir_torch.diff.render import make_value_and_grad
    from tpu_restir_torch.dist import mesh as mesh_mod
    from tpu_restir_torch.dist.diff import make_sharded_value_and_grad
    from tpu_restir_torch.dist.halo import halo_width
    from tpu_restir_torch.dist.sharded import (gather_full,
                                               make_sharded_restir_step)
    from tpu_restir_torch.kernels import local_gather as lg
    from tpu_restir_torch.kernels import ray_tri
    from tpu_restir_torch.render import camera as cam_mod
    from tpu_restir_torch.render.integrators.restir.pipeline import (
        init_restir_state, restir_step)

    mesh = mesh_mod.make_mesh(DIST_RANKS, "tiles", dev)
    root = mesh.rank == 0
    out = {"rank": mesh.rank, "backend": mesh.backend,
           "staged": mesh.staged}

    def frames(scene, cfg, n, key, timed=False, capture=None):
        """n frames of cfg sharded over the mesh, the launch counts zeroed
        before them and read after them into out[key] (capture(f): None,
        or a block that captures kernel inputs in frame f; with timed, ms
        and bytes sent and staged a frame), then on rank 0 the one-device
        frames (with timed, their ms) -> on rank 0, whether they are all
        equal."""
        cam = cam_mod.make_camera(cfg.camera, dev)
        step = make_sharded_restir_step(mesh, cfg)
        h, w = cfg.camera.height, cfg.camera.width
        state = init_restir_state(h // mesh.size, w, dev)
        mine, ms, sent, staged = [], [], [], []
        _zero_launches()
        for f in range(n):
            s0 = dict(mesh.stats)
            mesh_mod.barrier(mesh)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            with (capture and capture(f)) or contextlib.nullcontext():
                frame, state = step(scene, cam, rng.make_frame_seed(0, f),
                                    state, f)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
            sent.append(mesh.stats["sent_bytes"] - s0["sent_bytes"])
            staged.append(mesh.stats["staged_bytes"] - s0["staged_bytes"])
            mine.append(frame)
        out[key] = _launches()
        if timed:
            out.update(ms=ms, sent_bytes=sent, staged_bytes=staged)
        full = [gather_full(fr, mesh) for fr in mine]
        if not root:
            mesh_mod.barrier(mesh)
            return None
        state = init_restir_state(h, w, dev)
        equal, one_ms = True, []
        for f in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            frame, state = restir_step(scene, cam, cfg,
                                       rng.make_frame_seed(0, f), state, f)
            b.record()
            torch.cuda.synchronize()
            one_ms.append(a.elapsed_time(b))
            equal &= bool(torch.equal(frame, full[f]))
        if timed:
            out["one_ms"] = one_ms
        mesh_mod.barrier(mesh)
        return equal

    scene = cornell_box(dev)
    cfg = bench_cfg(*DIST_SIZE).replace(n_devices=DIST_RANKS)
    halo = halo_width(cfg.restir.spatial_reuse_radius)
    n_local = DIST_SIZE[0] * DIST_SIZE[1] // mesh.size
    k = cfg.restir.spatial_neighbor_count
    got, got_t = {}, {}

    def capture(f):
        """Frame 0: this rank's G-buffer query, first shadow query and
        spatial gather; frame 1 (a real previous G-buffer): the first
        temporal tap, K = 1 into the halo-extended payload."""
        if f == 0:
            stack = contextlib.ExitStack()
            for name, mod, keep in (
                    ("closest_hit", ray_tri,
                     lambda sc, o, *_: o.shape[0] == n_local),
                    ("any_hit", ray_tri,
                     lambda sc, o, *_: o.shape[0] == n_local),
                    ("gather_local", lg,
                     lambda p, tys, *_: tys.shape[0] == k)):
                stack.enter_context(capture_first(mod, name, keep, got))
            return stack
        if f == 1:
            return capture_first(
                lg, "gather_local",
                lambda p, tys, *_: tys.shape[0] == 1
                and p.shape[0] != tys.shape[1], got_t)
        return None

    out["frames_equal"] = frames(scene, cfg, DIST_FRAMES, "launches",
                                 timed=True, capture=capture)
    require({"closest_hit", "any_hit", "gather_local"} <= set(got)
            and "gather_local" in got_t,
            f"rank {mesh.rank}: a sharded frame made no query of kind "
            f"{ {'closest_hit', 'any_hit', 'gather_local'} - set(got)} "
            f"(temporal tap captured: {'gather_local' in got_t})")
    # K1, K2 and K3 on this rank's own queries, the ranks in turn (they
    # share the card)
    held = {}
    for turn in range(mesh.size):
        if turn == mesh.rank:
            what = f"rank {mesh.rank}, sharded bench frame"
            check_closest(f"{what}'s G-buffer query", scene,
                          *got["closest_hit"][1:5], recorder(held))
            check_any(f"{what}'s first shadow query", scene,
                      *got["any_hit"][1:5], recorder(held))
            check_gather(f"{what}'s halo-extended spatial strip",
                         *got["gather_local"][:4], recorder(held), top=halo)
            payload, tys, txs, r = got_t["gather_local"][:4]
            check_gather(f"{what}'s temporal tap of the extended payload",
                         payload, tys, txs, r,
                         recorder(held.setdefault("temporal", {})))
        mesh_mod.barrier(mesh)
    out["k1"], out["k2"], out["k3"] = (held[x] for x in (
        "closest_hit", "any_hit", "gather_local"))
    out["k3_temporal"] = held["temporal"]["gather_local"]
    del got, got_t, payload, tys, txs

    # the sharded fwd+bwd step against the one-device step
    cam = cam_mod.make_camera(cfg.camera, dev)
    target = torch.zeros((DIST_SIZE[1], DIST_SIZE[0], 3), device=dev)
    vg = make_sharded_value_and_grad(scene, cam, cfg, (1,), target, mesh)
    vg(extract_params(scene))   # warm-up
    _zero_launches()
    mesh_mod.barrier(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = vg(extract_params(scene))
    torch.cuda.synchronize()
    out["step_ms"] = 1e3 * (time.perf_counter() - t0)
    out["step_launches"] = _launches()
    mesh_mod.barrier(mesh)
    if root:
        vg1 = make_value_and_grad(scene, cam, cfg, (1,), target)
        vg1(extract_params(scene))   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss1, g1 = vg1(extract_params(scene))
        torch.cuda.synchronize()
        out["one_step_ms"] = 1e3 * (time.perf_counter() - t0)
        ok = bool(torch.allclose(loss, loss1, rtol=1e-5, atol=0.0))
        err = {}
        for key, g in g1.items():
            ok &= bool(torch.allclose(grads[key], g, rtol=2e-4, atol=1e-6))
            err[key] = float((grads[key] - g).abs().max())
        out.update(grads_ok=ok, loss=float(loss), loss1=float(loss1),
                   grad_err=err)
    del grads
    mesh_mod.barrier(mesh)

    # the all-gather fallback: halo 7 above 4-row shards
    small = bench_cfg(*DIST_FALLBACK).replace(n_devices=DIST_RANKS)
    out["fallback_equal"] = frames(scene, small, DIST_FRAMES,
                                   "fallback_launches")

    # beyond the path: one lights1k frame through K5/K6, which are held
    # to their plain versions on this rank's own packets of it
    big, view = large_scene("lights1k", dev)
    pks = {}
    out["lights_equal"] = frames(
        big, bench_cfg(*DIST_SIZE, view).replace(n_devices=DIST_RANKS), 1,
        "lights_launches",
        capture=lambda f: packets_of(n_local, False, pks))
    require(set(pks) == {"closest", "any"}, f"rank {mesh.rank}: the "
            f"lights1k shard made no query of kind "
            f"{ {'closest', 'any'} - set(pks)}")
    for turn in range(mesh.size):
        if turn == mesh.rank:
            out["lights_k56"] = hold_packets(
                f"[dist] rank {mesh.rank} lights1k shard", big,
                pks["closest"], pks["any"])
        mesh_mod.barrier(mesh)
    return out


def phase_dist(dev, name, smi):
    """[dist]: DIST_RANKS ranks sharing the one card under gloo (the
    kernels built before they start), the checks of _dist_checks, and the
    CLI with --devices 2 where the machine has two cards -> rank 0's
    launch counts over its sharded frames and its K3 entry."""
    import torch
    import torch.multiprocessing as mp

    from tpu_restir_torch.dist.halo import halo_width
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as outdir:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        mp.start_processes(_dist_rank, args=(DIST_RANKS, port, outdir),
                           nprocs=DIST_RANKS, start_method="spawn")
        ranks = []
        for r in range(DIST_RANKS):
            with open(os.path.join(outdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    r0 = ranks[0]
    cfg = bench_cfg(*DIST_SIZE)
    halo = halo_width(cfg.restir.spatial_reuse_radius)
    h = DIST_SIZE[1]
    print(f"[dist] {DIST_RANKS} ranks sharing one card ({name}; {smi}), "
          f"backend {r0['backend']}, strips staged through host memory: "
          f"{r0['staged']}; Cornell bench config at {DIST_SIZE[0]}x{h}, "
          f"{h} rows in shards of {h // DIST_RANKS}, halo {halo} rows "
          f"(radius {cfg.restir.spatial_reuse_radius})", flush=True)
    for r in ranks:
        for what, e in (("K1 on its G-buffer query", r["k1"]),
                        ("K2 on its first shadow query", r["k2"]),
                        (f"K3 at top = {halo} on its spatial payload",
                         r["k3"]),
                        ("K3 on its temporal tap of the extended payload",
                         r["k3_temporal"])):
            lib = (f", PyTorch indexing {e['library_ms']:.3f} ms"
                   if e["library_ms"] is not None else "")
            print(f"[dist] rank {r['rank']}: {what}, bit-identical to its "
                  f"plain version: kernel {e['ms']:.3f} ms, plain "
                  f"{e['plain_ms']:.3f} ms{lib}, bound {e['bound_ms']:.3f} "
                  f"ms ({e['bound_by']})", flush=True)
        print(f"[dist] rank {r['rank']}: K5/K6 on its lights1k shard "
              f"packets against their plain versions: "
              + "; ".join(r["lights_k56"]), flush=True)
    for r in ranks:
        print(f"[dist] rank {r['rank']}: halo and gather bytes sent a "
              f"frame {r['sent_bytes'][1:]}, bytes staged a frame "
              f"{r['staged_bytes'][1:]}; ms/frame "
              f"{[round(x, 3) for x in r['ms']]} (the first is the "
              f"warm-up); fwd+bwd step {r['step_ms']:.1f} ms (after a "
              f"warm-up); launches over {DIST_FRAMES} frames "
              f"{r['launches']}, over the step {r['step_launches']}",
              flush=True)
    print(f"[dist] one device on the same card: ms/frame "
          f"{[round(x, 3) for x in r0['one_ms']]}, fwd+bwd step "
          f"{r0['one_step_ms']:.1f} ms. Two ranks sharing one card: a "
          "check of exactness and the exchange, not a scaling figure",
          flush=True)
    print(f"[dist] frames equal to one device: {r0['frames_equal']}; "
          f"fwd+bwd loss {r0['loss']:.9g} against {r0['loss1']:.9g}, "
          f"gradients within rtol 2e-4 + 1e-6: {r0['grads_ok']} (largest "
          f"differences {r0['grad_err']}); all-gather fallback at "
          f"{DIST_FALLBACK[0]}x{DIST_FALLBACK[1]} equal: "
          f"{r0['fallback_equal']}; lights1k frame equal: "
          f"{r0['lights_equal']} (its {h // DIST_RANKS}-row shards go "
          f"unswizzled where the rows are not a multiple of 8: exact and "
          f"only slower; K5/K6 launches "
          f"{r0['lights_launches']['trace_closest']}/"
          f"{r0['lights_launches']['trace_any']})", flush=True)
    require(r0["frames_equal"], "[dist] sharded frames differ from one device")
    require(r0["grads_ok"], "[dist] sharded gradients differ")
    require(r0["fallback_equal"], "[dist] the all-gather fallback differs")
    require(r0["lights_equal"], "[dist] the sharded lights1k frame differs")
    for r in ranks:
        for key in ("closest_hit", "any_hit", "gather_local"):
            require(r["launches"][key] > 0,
                    f"[dist] rank {r['rank']} never launched {key}")
        lights = r["lights_launches"]
        require(lights["trace_closest"] > 0 and lights["trace_any"] > 0,
                f"[dist] rank {r['rank']}: lights1k bypassed K5/K6")
        require(lights["shortlist_keys"] == lights["trace_closest"]
                + lights["trace_any"],
                f"[dist] rank {r['rank']}: K9 not once a K5/K6 launch: "
                f"{lights}")
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory() as tmp:
            cli_main(["--devices", "2", "--size", "64x32", "--temporal",
                      "--spatial", "--spatial-mis", "pairwise", "--frames",
                      "2", "--out", os.path.join(tmp, "two.png")])
            require(os.path.exists(os.path.join(tmp, "two.png")),
                    "[dist] the CLI with --devices 2 wrote no image")
        print("[dist] CLI --devices 2 on two cards: ran", flush=True)
    else:
        print(f"[dist] CLI --devices 2: not run ({torch.cuda.device_count()} "
              "card; it needs two)", flush=True)
    print(f"[dist] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return r0


def main():
    import torch  # noqa: F401  (fails here without PyTorch)

    import tpu_restir_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    dev, name, smi = phase_device()
    phase_build()
    results = phase_kernels(dev)
    phase_ptrace_kernels(dev, results)
    small_mean, small_se = phase_small()
    launches = phase_main_path(dev, small_mean, small_se, smi)
    phase_passes(dev)
    phase_integrators(dev, smi)
    demo = phase_demo(dev, smi, results)
    launches.update(scatter_local=phase_fwd_bwd(dev, smi)["scatter_local"])
    phase_grad_small()
    phase_optimize(dev)
    # the clustered scenes: K5/K6 launches are those of their two paths
    launches.update(trace_closest=0, trace_any=0, shortlist_keys=0)
    for label in ("terrain100k", "lights1k"):
        small_mean, _se = phase_small(label, CLUSTER_SMALL_FRAMES)
        got = phase_large_path(dev, label, smi, small_mean)
        for key in ("trace_closest", "trace_any", "shortlist_keys"):
            launches[key] += got[key]
    phase_grad_small("terrain100k")
    # the Woop variant: K7/K8 launches are those of its path
    small_mean, _se = phase_small("terrain20k-128", CLUSTER_SMALL_FRAMES)
    got = phase_large_path(dev, "terrain100k-128", smi, small_mean)
    for key in ("trace_closest_mxu", "trace_any_mxu"):
        launches[key] = got[key]
    launches["shortlist_keys"] += got["shortlist_keys"]
    phase_cli(dev, smi)
    phase_denoise_cost(dev, smi)
    dist = phase_dist(dev, name, smi)
    phase_backends(dev, smi)
    phase_tools(dev, smi)
    bench_launches = phase_bench(dev, smi, results)
    profile = [a.split("=", 1)[1] for a in sys.argv[1:]
               if a.startswith("--profile=")]
    if profile:
        phase_profile(dev, profile[0])
        root, ext = os.path.splitext(profile[0])
        profile_integrator(dev, f"{root}_nee{ext}")
    # after the CLI's exports and checkpoints
    loaded = sorted(m for m in sys.modules if m.split(".")[0]
                    in ("jax", "jaxlib", "flax", "tpu_restir"))
    require(not loaded, f"JAX or the JAX package was imported: {loaded}")

    meta = {
        "closest_hit": ("tpu_restir_torch/csrc/ray_tri.cu",
                        "tpu_restir/kernels/ray_tri.py:113"),
        "any_hit": ("tpu_restir_torch/csrc/ray_tri.cu",
                    "tpu_restir/kernels/ray_tri.py:90"),
        "gather_local": ("tpu_restir_torch/csrc/local_gather.cu",
                         "tpu_restir/kernels/local_gather.py:50"),
        "scatter_local": ("tpu_restir_torch/csrc/local_scatter.cu",
                          "tpu_restir/kernels/local_gather.py:167"),
        "trace_closest": ("tpu_restir_torch/csrc/cluster_trace.cu",
                          "tpu_restir/kernels/cluster_trace.py:314"),
        "trace_any": ("tpu_restir_torch/csrc/cluster_trace.cu",
                      "tpu_restir/kernels/cluster_trace.py:566"),
        "trace_closest_mxu": ("tpu_restir_torch/csrc/cluster_trace.cu",
                              "tpu_restir/kernels/cluster_trace.py:795"),
        "trace_any_mxu": ("tpu_restir_torch/csrc/cluster_trace.cu",
                          "tpu_restir/kernels/cluster_trace.py:888"),
        # phase 1's keys: XLA code in the JAX package, no Pallas kernel
        "shortlist_keys": ("tpu_restir_torch/csrc/cluster_trace.cu", None),
        # calc_i_m's incomplete beta: XLA's betainc in the JAX package
        "ibeta": ("tpu_restir_torch/csrc/ibeta.cu", None),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k],
                **{key: results[k][key] for key in keys},
                **{key: results[k][key] for key in ("slab_live_share",)
                   if key in results[k]},
                **({"demo_launches": demo[k]} if k in demo else {}),
                "dist_launches": dist["launches"].get(k, 0),
                "bench_launches": bench_launches[k],
                **({"dist_ms": dist["k3"]["ms"]}
                   if k == "gather_local" else {})}
               for k, (src, rep) in meta.items()]
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
