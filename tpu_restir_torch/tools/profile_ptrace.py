"""Phase split of one clustered closest-hit query on one GPU (counterpart of
the repository's `tools/profile_ptrace.py`).

    python -m tpu_restir_torch.tools.profile_ptrace [--device cuda]
        [--tris 100000] [--size 1920x1080] [--reps 5]

The query: the primary rays of terrain_scene(tris) from the bench's
terrain camera (frame seed 1), swizzled into 8x32-pixel packets as
`render.intersect` sends them, tnear 0.01, tfar 1e30. Printed, as the JAX
tool prints them:
  * phase 1 (the scene-box clamp `fcluster._clamp_tfar_bbox` and
    `cluster_trace.build_shortlists` on the (super)cluster boxes), its ms
    and the shortlist count's mean, p50, p95, p99 and max;
  * the whole closest query (`cluster_trace.trace_closest`: phase 1, then
    K5 on the card or its plain version on the CPU) and the kernel's time
    as the difference;
  * the effective ordered rounds under the final watermark: per packet the
    shortlist entries within the packet's largest min(t, tfar) of the
    query's result, the slots a front-to-back traversal that stops per
    packet must visit;
  * the bounds alone, and the bounds plus the interval pass and the
    swept sub-box cull, with the sort by difference;
then one JSON line of the same numbers, the card's name and power limit.

Each time is the median over `reps` runs of the work, each ending in a
synchronize, timed by CUDA events on the card (the host clock on the
CPU, where a run is a test of the tool, not a measurement). The default
device is cuda, which must be there: there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from tpu_restir_torch import bench
from tpu_restir_torch.accel.fcluster import _clamp_tfar_bbox, _packet_bounds
from tpu_restir_torch.config import CameraConfig
from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.metrics import sync
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render.intersect import _tile_perm

TNEAR, TFAR = 0.01, 1e30


def median_ms(fn, reps: int, device):
    """(median ms of fn() over reps runs after a warm-up run, its last
    result): CUDA events around each run on the card, which ends in a
    synchronize; the host clock on the CPU."""
    out = fn()
    sync(out)
    times = []
    for _ in range(reps):
        if torch.device(device).type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def primary_rays(width: int, height: int, device):
    """The terrain camera's primary rays at frame seed 1 in packet order
    (the 8x32-tile swizzle) -> o, d (R, 3), tnear, tfar (R,)."""
    view = bench.TERRAIN_VIEW
    cfg = CameraConfig(width=width, height=height, fov_y_deg=45.0,
                       view_from=view[0], view_at=view[1])
    cam = cam_mod.make_camera(cfg, device)
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    o, d = cam_mod.generate_rays_at(cam, cfg, 1, ys, xs)
    perm = _tile_perm(height, width, device)
    n = width * height
    return (o.reshape(-1, 3)[perm].contiguous(),
            d.reshape(-1, 3)[perm].contiguous(),
            torch.full((n,), TNEAR, device=device),
            torch.full((n,), TFAR, device=device))


def stats(x) -> dict:
    """mean, p50, p95, p99 and max of an integer array (numpy's
    percentiles, as the JAX tool takes them)."""
    x = np.asarray(x)
    return {"mean": float(x.mean()), "p50": float(np.percentile(x, 50)),
            "p95": float(np.percentile(x, 95)),
            "p99": float(np.percentile(x, 99)), "max": int(x.max())}


def measure(device, n_tris: int = 100_000, width: int = 1920,
            height: int = 1080, reps: int = 5, scene=None) -> dict:
    """The phase split of the closest query of `primary_rays` on
    terrain_scene(n_tris) (or `scene`) -> dict of ms and counts."""
    from tpu_restir_torch.scene.procedural import terrain_scene
    device = torch.device(device)
    if scene is None:
        scene = terrain_scene(device, n_tris)
    o, d, tn, tf = primary_rays(width, height, device)
    ctris, cmin, cmax = (scene.cluster_tris, scene.cluster_min,
                         scene.cluster_max)
    factor = ct.pick_factor(ctris.shape[0])
    scmin, scmax = ct._super_boxes(cmin, cmax, factor)
    lo, hi = scmin.amin(0), scmax.amax(0)

    def clamp():
        return _clamp_tfar_bbox(o, d, tn, tf, lo, hi)

    def phase1():
        return ct.build_shortlists(o, d, tn, clamp(), scmin, scmax)

    phase1_ms, (cnt, _sl, ent) = median_ms(phase1, reps, device)
    full_ms, hit = median_ms(
        lambda: ct.trace_closest(ctris, cmin, cmax, o, d, tn, tf), reps,
        device)
    # ordered early exit: per packet the entries within its largest
    # min(best t, tfar) of the query's result, at most its count
    maxt = torch.minimum(hit[0], clamp()).reshape(-1, ct.P).amax(1)
    rounds = torch.minimum((ent <= maxt[:, None]).sum(1), cnt)

    def bounds():
        out = _packet_bounds(o, d, tn, clamp(), ct.P)
        return sum(x.float().sum() for x in out)

    def bounds_interval():
        (omin, omax, dmin, dmax, tnp, tfp, bounded, emin,
         emax) = _packet_bounds(o, d, tn, clamp(), ct.P)
        passes, entry = ct._interval_pass_entry(omin, omax, dmin, dmax, tnp,
                                                tfp, scmin, scmax)
        passes &= ct.box_overlap(emin, emax, scmin, scmax) \
            | ~bounded[:, None]
        return passes, entry

    bounds_ms, _ = median_ms(bounds, reps, device)
    interval_ms, _ = median_ms(bounds_interval, reps, device)
    rounds_np = rounds.cpu().numpy()
    return {
        "device": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
        "triangles": scene.num_tris, "clusters": ctris.shape[0],
        "factor": factor, "rays": o.shape[0], "packets": cnt.shape[0],
        "reps": reps, "phase1_ms": phase1_ms,
        "count": stats(cnt.cpu().numpy()),
        "closest_ms": full_ms, "kernel_ms": full_ms - phase1_ms,
        "rounds": {**{k: v for k, v in stats(rounds_np).items()
                      if k in ("mean", "p95", "max")},
                   "total": int(rounds_np.sum())},
        "bounds_ms": bounds_ms, "bounds_interval_ms": interval_ms,
        "sort_ms": phase1_ms - interval_ms,
    }


def report(r: dict) -> str:
    """The JAX tool's lines."""
    c, rd = r["count"], r["rounds"]
    return "\n".join([
        f"phase1: {r['phase1_ms']:.1f} ms | count mean={c['mean']:.1f} "
        f"p50={c['p50']:.0f} p95={c['p95']:.0f} p99={c['p99']:.0f} "
        f"max={c['max']}",
        f"closest full: {r['closest_ms']:.1f} ms "
        f"(kernel ~{r['kernel_ms']:.1f} ms)",
        f"effective rounds (ordered, final watermark): mean="
        f"{rd['mean']:.2f} p95={rd['p95']:.0f} max={rd['max']} | "
        f"total={rd['total']}",
        f"  bounds: {r['bounds_ms']:.1f} ms",
        f"  bounds+interval: {r['bounds_interval_ms']:.1f} ms "
        f"(sort ~{r['sort_ms']:.1f})"])


def parse_size(text: str):
    w, h = text.lower().split("x")
    return int(w), int(h)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tris", type=int, default=100_000)
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    w, h = parse_size(args.size)
    r = measure(args.device, args.tris, w, h, args.reps)
    if torch.device(args.device).type == "cuda":
        r["gpu"] = bench.gpu_line()
    print(report(r), flush=True)
    print(json.dumps(r), flush=True)
    return r


if __name__ == "__main__":
    main()
