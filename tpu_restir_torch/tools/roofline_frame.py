"""Whole-frame roofline on one GPU: per-pass measured ms and the
least-time models of a frame's components for the three bench scenes
(counterpart of the repository's `tools/roofline_frame.py`).

    python -m tpu_restir_torch.tools.roofline_frame [OUT.md] [--device cuda]

Per scene (cornell, lights1k, terrain100k; the bench configuration at
1920x1080):
  * measured per-pass ms by prefix timing: restir_step cut after each
    pass (cfg.profile_stop_after), INNER chained frames a prefix, summed
    over frame and state and ended in one synchronize, after a warm-up
    run; a pass's time is the difference of two prefixes;
  * the query census of one frame (the `rays.` counts of
    `render.intersect` in a `tracing.recording()`,
    `roofline.summarize_query_log`);
  * model lines from `tpu_restir_torch.roofline` at the card's ceilings:
    the intersection queries (K1's fused spec or the clustered spec with
    the shortlist census of the primary rays and of real shadow
    segments), p_hat evaluation, the spatial gather at the payload's
    channels, and the G-buffer and shading streams; the frame's share of
    its bound.

The blocks are printed; with OUT.md they are also written there under a
heading that names the card and its power limit. It never writes
docs/ROOFLINE.md, the JAX package's record.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from tpu_restir_torch import bench, rng, roofline, tracing
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render import intersect as intersect_mod
from tpu_restir_torch.render.integrators.restir.pipeline import (
    init_restir_state, restir_step)

W, H = 1920, 1080
N_PIX = W * H
INNER = 4
SCENES = ("cornell", "lights1k", "terrain100k")
_JAX_RECORD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "ROOFLINE.md")


def _cfg(stop=None):
    return bench.bench_cfg(W, H).replace(profile_stop_after=stop)


def measure_prefix(scene, cam, cfg, device) -> float:
    """Seconds a frame of the restir_step prefix that cfg stops after:
    INNER chained frames, each adding its frame and state to a sum, one
    synchronize; a warm-up run first."""
    def run():
        state = init_restir_state(H, W, device)
        acc = torch.zeros((), device=device)
        for i in range(INNER):
            fr, state = restir_step(scene, cam, cfg,
                                    rng.make_frame_seed(0, i), state, i)
            # a prefix returns a zero frame and the computed state: the
            # sum reads both, as the JAX tool's does
            acc = (acc + fr.sum() + state.gb_prev.depth.sum()
                   + state.res_prev.w_sum.sum())
        bench.sync(acc)

    run()
    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) / INNER


def census(scene, cam, device):
    """The queries of one full frame, recorded -> (their
    {"kind", "backend", "rays"} dicts, summarize_query_log)."""
    with tracing.recording() as rec:
        fr, _st = restir_step(scene, cam, _cfg(None),
                              rng.make_frame_seed(0, 0),
                              init_restir_state(H, W, device), 0)
        bench.sync(fr)
    return intersect_mod.queries(rec), roofline.summarize_query_log(rec)


def _payload_channels(scene) -> int:
    from tpu_restir_torch.render.integrators.restir import packed as pk
    slim = pk.reuse_slim(scene.materials)
    return pk.gb_ch(slim) + (pk.RES_CH_SLIM if slim else pk.RES_CH)


def frame_model(scene, cam, cam_cfg, qlog, cen, device):
    """The frame's model lines, as the JAX tool builds them
    (roofline_frame.py:110-175) -> (FrameModel, backend, payload
    channels)."""
    fm = roofline.FrameModel()
    backend = qlog[0]["backend"] if qlog else "?"
    n_q_closest = cen.get("closest", {}).get("queries", 0)
    n_q_any = cen.get("any", {}).get("queries", 0)
    r_closest = cen.get("closest", {}).get("rays", 0)
    r_any = cen.get("any", {}).get("rays", 0)
    if backend == "fused":
        fm.add(roofline.fused_query_spec(
            f"intersect closest x{n_q_closest}", r_closest, scene.num_tris))
        fm.add(roofline.fused_query_spec(
            f"intersect any x{n_q_any}", r_any, scene.num_tris))
    else:
        # conservative: every query visits its whole mean shortlist.
        # _clamp_tfar_bbox is the port's, which keeps a ray lying in the
        # plane of the scene box's max face live where the JAX package's
        # clamp kills it (tests/test_torch_clamp.py): on such a ray this
        # census may list more clusters than the JAX tool's.
        from tpu_restir_torch.accel.fcluster import _clamp_tfar_bbox
        from tpu_restir_torch.config import IntersectorConfig
        from tpu_restir_torch.kernels.cluster_trace import (
            _super_boxes, build_shortlists, pick_factor)
        f = pick_factor(scene.cluster_tris.shape[0])
        scmin, scmax = _super_boxes(scene.cluster_min, scene.cluster_max, f)
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.int32, device=device),
            torch.arange(W, dtype=torch.int32, device=device), indexing="ij")
        o, d = cam_mod.generate_rays_at(cam, cam_cfg, 1, ys, xs)
        of = o.reshape(-1, 3).contiguous()
        df = d.reshape(-1, 3).contiguous()
        tn = torch.full((N_PIX,), 0.01, device=device)
        tf = _clamp_tfar_bbox(of, df, tn, torch.full((N_PIX,), 1e30,
                                                     device=device),
                              scmin.amin(0), scmax.amax(0))
        cnt = build_shortlists(of, df, tn, tf, scmin, scmax)[0]
        visited = float(cnt.sum()) * f
        b = scene.cluster_tris.shape[1]
        fm.add(roofline.ptrace_query_spec(
            f"intersect closest x{n_q_closest} (primary lists)", r_closest,
            int(visited * n_q_closest), b))
        # the shadow queries' lists: real shadow segments (hit point to a
        # seeded emissive triangle's v0), not the primary frustum's
        hit = intersect_mod.intersect_closest(
            scene, of, df, tn, torch.full((N_PIX,), 1e30, device=device),
            IntersectorConfig(backend="ptrace"))
        hp = of + df * torch.where(torch.isfinite(hit.t), hit.t,
                                   1.0)[:, None]
        e_idx = scene.lights.tri_idx
        pick = torch.as_tensor(np.random.default_rng(5).integers(
            0, e_idx.shape[0], N_PIX), device=device)
        seg = scene.tri_v0[e_idx[pick].long()] - hp
        dist = torch.linalg.norm(seg, dim=-1)
        sdir = seg / torch.clamp(dist, min=1e-9)[:, None]
        cnt2 = build_shortlists(hp, sdir, tn, dist - 1e-3, scmin, scmax)[0]
        visited2 = float(cnt2.sum()) * f
        fm.add(roofline.ptrace_query_spec(
            f"intersect any x{n_q_any} (shadow lists)", r_any,
            int(visited2 * n_q_any), b))
    n_phat = 4 + 17 + (1 + 1 + 1)   # temporal 4 + spatial 17 + initial 3
    fm.add(roofline.phat_spec(f"p_hat eval x{n_phat}", N_PIX, n_phat))
    ch = _payload_channels(scene)
    fm.add(roofline.gather_spec("spatial neighbor gather", N_PIX, 5, ch, 5))
    fm.add(roofline.shading_spec("gbuffer fill streams", N_PIX, 300, 30))
    fm.add(roofline.shading_spec("reservoir/shade streams", N_PIX, 500, 60))
    return fm, backend, ch


def scene_report(label, scene, cam_cfg, device) -> str:
    """One scene's block: per-pass ms, the frame's ms and Mrays/s, and
    the model lines with the frame's share of its bound."""
    cam = cam_mod.make_camera(cam_cfg, device)
    stages = ["gbuffer", "initial", "temporal", "spatial", None]
    names = ["gbuffer", "initial", "temporal", "spatial", "shade"]
    times, prev = {}, 0.0
    for st, nm in zip(stages, names):
        cum = measure_prefix(scene, cam, _cfg(st), device)
        times[nm] = max(cum - prev, 0.0)
        prev = cum
    frame_s = prev
    qlog, cen = census(scene, cam, device)
    fm, backend, ch = frame_model(scene, cam, cam_cfg, qlog, cen, device)
    lines = [f"## {label} ({scene.num_tris} tris, backend {backend}, "
             f"payload {ch} ch)"]
    lines.append("measured per-pass ms (prefix differences, "
                 f"{INNER} chained frames a prefix): "
                 + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in times.items())
                 + f"; frame {frame_s * 1e3:.1f} ms "
                 f"({cen['total_rays'] / frame_s / 1e6:.1f} Mrays/s)")
    lines.append(fm.report(frame_s))
    return "\n".join(lines)


def main(argv=None):
    from tpu_restir_torch.cli import device_from_args
    p = argparse.ArgumentParser("tpu_restir_torch.tools.roofline_frame")
    p.add_argument("out", nargs="?", default=None,
                   help="markdown file to write the blocks to")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); no fallback")
    a = p.parse_args(argv)
    device = device_from_args(a)
    if a.out and os.path.realpath(a.out) == os.path.realpath(_JAX_RECORD):
        raise ValueError(f"{a.out} is the JAX package's record; write the "
                         f"port's roofline elsewhere")
    card = bench.gpu_line() if device.type == "cuda" else f"{device}, no card"
    blocks = []
    for label in SCENES:
        build, view = bench.SCENES[label]
        blocks.append(scene_report(label, build(device),
                                   bench.bench_cfg(W, H, view).camera,
                                   device))
        print(blocks[-1], flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(f"# Whole-frame roofline (1080p ReSTIR; {card})\n\n"
                    + "\n\n".join(blocks) + "\n")
    return blocks


if __name__ == "__main__":
    main()
