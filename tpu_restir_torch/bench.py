"""Benchmark: Mrays/s of the full ReSTIR pipeline at 1080p on one GPU
(counterpart of the repository's `bench.py`, the same configurations,
ray count and JSON line).

    python -m tpu_restir_torch.bench [--device cuda]

Prints ONE JSON line last, {"metric", "value", "unit", "vs_baseline"}:
value is Mrays/s of the forward+backward step (value_and_grad of a pixel
loss w.r.t. the material table through one Cornell frame); the unit
carries the forward Mrays/s of 8 chained frames, those of lights1k,
terrain100k and terrain1M (the last in a child process,
`tpu_restir_torch.tools.bench_terrain1m`, under a 1500 s timeout), and
the traced rays per pixel beside the analytic count. Baseline: the
reference CPU renderer's ~2 Mrays/s (BASELINE.md "derived throughput"),
not a TPU figure. Every closest-hit or occlusion query counts as one ray
(`metrics.rays_per_pixel`). Earlier lines carry the card's name and power
limit and the peak memory of each scene and of the step.

Frames chain through the reservoir state and end in one synchronize, as
`bench.py` times them. The default device is cuda, which must be there:
there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from tpu_restir_torch import rng, tracing
from tpu_restir_torch.config import (CameraConfig, IntersectorConfig,
                                     RenderConfig, RenderParams, RestirParams)
from tpu_restir_torch.metrics import rays_per_pixel, sync
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render import intersect
from tpu_restir_torch.render.integrators.restir.pipeline import (
    init_restir_state, restir_step)

WIDTH, HEIGHT = 1920, 1080
N_FRAMES = 8        # chained Cornell frames of the forward metric
N_STEPS = 3         # timed fwd+bwd steps, after one warm-up step
N_SECONDARY = 4     # chained frames of each secondary scene
TERRAIN1M_TIMEOUT = 1500.0   # seconds of the terrain1M child
BASELINE_MRAYS = 2.0   # the reference CPU renderer (BASELINE.md)
METRIC = "restir_1080p_mrays_per_s_fwd_bwd"
# (view_from, view_at): the Cornell camera and the terrain camera
CORNELL_VIEW = ((0.0, -3.9, 1.0), (0.0, 0.0, 1.0))
TERRAIN_VIEW = ((0.0, -7.0, 4.0), (0.0, 0.0, 0.5))
CHILD = ["-m", "tpu_restir_torch.tools.bench_terrain1m"]
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_cfg(width: int = WIDTH, height: int = HEIGHT, view=CORNELL_VIEW,
              mxu: bool = False) -> RenderConfig:
    """The bench configuration (bench.py:55-65): fov 45, the random pixel
    sampler, no sky; m_area 1, m_brdf 1, temporal reuse, 5-neighbour
    pairwise spatial reuse; rays in chunks of 2^18 and triangle blocks of
    2048. mxu sets `ptrace_mxu` (the Woop kernels K7/K8 on scenes built
    at cluster size 128), which bench.py leaves off."""
    return RenderConfig(
        camera=CameraConfig(width=width, height=height, fov_y_deg=45.0,
                            view_from=view[0], view_at=view[1],
                            pixel_sampler="random"),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(m_area=1, m_brdf=1, do_temporal_reuse=True,
                            do_spatial_reuse=True, spatial_neighbor_count=5,
                            spatial_mis="pairwise"),
        intersector=IntersectorConfig(ray_chunk=1 << 18, tri_block=2048,
                                      ptrace_mxu=mxu),
        integrator="restir")


def _many_lights(device):
    from tpu_restir_torch.scene.cornell import many_lights_scene
    return many_lights_scene(device, 1000)


def _terrain(n_tris):
    def build(device):
        from tpu_restir_torch.scene.procedural import terrain_scene
        return terrain_scene(device, n_tris)
    return build


def _cornell(device):
    from tpu_restir_torch.scene.cornell import cornell_box
    return cornell_box(device)


# label -> (build(device) -> the scene, camera view): bench.py's scenes
SCENES = {
    "cornell": (_cornell, CORNELL_VIEW),
    "lights1k": (_many_lights, CORNELL_VIEW),
    "terrain100k": (_terrain(100_000), TERRAIN_VIEW),
    "terrain1M": (_terrain(1_000_000), TERRAIN_VIEW),
}
SECONDARY = ("lights1k", "terrain100k")


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device):
    """Peak device memory since reset_peak, in GiB; None off the card."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def fmt_gib(gib) -> str:
    return "not measured" if gib is None else f"{gib:.2f} GiB"


def chained_frames(scene, cfg, device, n_frames: int):
    """bench.py's frame loop: one warm-up frame with its counts recorded,
    then n_frames restir_step frames, each taking the previous frame's
    state, and one synchronize after the loop -> dict of the traced rays
    of a frame (the warm-up's queries), the seconds of the n_frames, the
    last frame, and the peak memory of the frames."""
    h, w = cfg.camera.height, cfg.camera.width
    cam = cam_mod.make_camera(cfg.camera, device)
    state = init_restir_state(h, w, device)
    reset_peak(device)
    with tracing.recording() as rec:
        frame, state = restir_step(scene, cam, cfg, rng.make_frame_seed(0, 0),
                                   state, 0)
        sync(frame)
    t0 = time.perf_counter()
    for f in range(1, n_frames + 1):
        frame, state = restir_step(scene, cam, cfg, rng.make_frame_seed(0, f),
                                   state, f)
    sync(frame)
    return {"rays": sum(e["rays"] for e in intersect.queries(rec)),
            "seconds": time.perf_counter() - t0, "frame": frame,
            "peak_gib": peak_gib(device)}


def fwd_bwd_step(scene, cfg, device):
    """bench.py's forward+backward step: value_and_grad of the pixel loss
    mean(img^2) (a zero target) w.r.t. the material table through one
    frame of frame seed 1 from a fresh state -> (the callable params ->
    (loss, grads), the parameters at the scene's values)."""
    from tpu_restir_torch.diff.params import extract_params
    from tpu_restir_torch.diff.render import make_value_and_grad
    h, w = cfg.camera.height, cfg.camera.width
    cam = cam_mod.make_camera(cfg.camera, device)
    target = torch.zeros((h, w, 3), device=device)
    return (make_value_and_grad(scene, cam, cfg, (1,), target),
            extract_params(scene))


def timed_steps(scene, cfg, device, n_steps: int):
    """One warm-up step, then n_steps steps with a synchronize after the
    last -> dict of seconds a step, the last loss and gradients, and the
    peak memory of the timed steps."""
    vg, params = fwd_bwd_step(scene, cfg, device)
    loss, grads = vg(params)
    sync(loss)
    reset_peak(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss, grads = vg(params)
    sync(loss)
    return {"seconds": (time.perf_counter() - t0) / n_steps, "loss": loss,
            "grads": grads, "peak_gib": peak_gib(device)}


def child_argv(device) -> list:
    """The terrain1M child's command line."""
    return [sys.executable, *CHILD, "--device", str(device)]


def run_child(argv, timeout: float = TERRAIN1M_TIMEOUT):
    """Runs the terrain1M child (bench.py:168-186) -> (its entry of the
    unit, its info dict or None). Its "TERRAIN1M <mrays> rpp <rpp>" line
    gives the entry; its other stdout lines are printed here. On a
    failure the entry is "terrain1M failed:rc<N>" (no such line) or
    "terrain1M failed:<ExceptionName>", and the rc and the child's last
    stderr line go to stderr."""
    label = "terrain1M"
    try:
        r = subprocess.run(argv, capture_output=True, text=True,
                           timeout=timeout, cwd=_ROOT)
    except Exception as e:  # noqa: BLE001 — a child failure is reported
        print(f"[bench] {label} child: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return f"{label} failed:{type(e).__name__}", None
    info, line = None, None
    for ln in r.stdout.splitlines():
        if ln.startswith("TERRAIN1M"):
            line = ln
            continue
        if ln.startswith("[terrain1M] {"):
            info = json.loads(ln.split(" ", 1)[1])
        print(ln, flush=True)
    if line is None:
        errs = [ln for ln in r.stderr.splitlines() if ln.strip()]
        print(f"[bench] {label} child exited with rc {r.returncode}; its "
              f"last stderr line: {errs[-1] if errs else '(none)'}",
              file=sys.stderr, flush=True)
        return f"{label} failed:rc{r.returncode}", info
    parts = line.split()
    return f"{label} {parts[1]} (rpp {parts[3]})", info


def run_bench(device, width: int = WIDTH, height: int = HEIGHT,
              scenes=None, child=None, n_frames: int = N_FRAMES,
              n_steps: int = N_STEPS, n_secondary: int = N_SECONDARY):
    """The whole bench on device -> (the JSON object of the last line, a
    report: per scene the traced rays of a frame, whether the last frame
    is finite, ms a frame and peak memory; the step's finiteness; the
    terrain1M child's info). scenes maps the labels of SCENES to (build,
    view) (SCENES by default); child is the terrain1M child's command
    line (child_argv(device) by default)."""
    scenes = SCENES if scenes is None else scenes
    n_pix = float(width * height)
    report = {"rays": {}, "finite": {}, "ms_frame": {}, "peak_gib": {}}

    def record(label, run, n):
        report["rays"][label] = run["rays"]
        report["finite"][label] = bool(torch.isfinite(run["frame"]).all())
        report["ms_frame"][label] = run["seconds"] / n * 1e3
        report["peak_gib"][label] = run["peak_gib"]
        print(f"[bench] {label} {width}x{height}: {n} chained frames, "
              f"{run['seconds'] / n * 1e3:.2f} ms/frame; traced rays "
              f"{run['rays']} a frame ({run['rays'] / n_pix} a pixel); "
              f"peak memory {fmt_gib(run['peak_gib'])}; frame finite "
              f"{report['finite'][label]}", flush=True)

    build, view = scenes["cornell"]
    cfg = bench_cfg(width, height, view)
    scene = build(device)
    main = chained_frames(scene, cfg, device, n_frames)
    record("cornell", main, n_frames)
    traced_rays = main["rays"]
    traced_rpp = traced_rays / n_pix
    # throughput on the traced ray count; the analytic count where no
    # query was counted (bench.py:107-108)
    rays_frame = traced_rays or rays_per_pixel(cfg) * width * height
    mrays_fwd = rays_frame * n_frames / main["seconds"] / 1e6

    step = timed_steps(scene, cfg, device, n_steps)
    report["step_finite"] = bool(torch.isfinite(step["loss"])) and all(
        bool(torch.isfinite(g).all()) for g in step["grads"].values())
    report["step_ms"] = step["seconds"] * 1e3
    report["peak_gib"]["fwd+bwd"] = step["peak_gib"]
    mrays_fwd_bwd = rays_frame / step["seconds"] / 1e6
    print(f"[bench] fwd+bwd {width}x{height}: {n_steps} steps, "
          f"{step['seconds'] * 1e3:.2f} ms/step, {mrays_fwd_bwd:.2f} Mrays/s; "
          f"loss {float(step['loss']):.6f}; finite {report['step_finite']}; "
          f"peak memory {fmt_gib(step['peak_gib'])}", flush=True)
    del scene, step

    # the secondary scenes (bench.py:128-166): a failure loses only its
    # own entry, never the main metric
    extras = []
    for label in SECONDARY:
        try:
            build, view = scenes[label]
            run = chained_frames(build(device), bench_cfg(width, height, view),
                                 device, n_secondary)
            record(label, run, n_secondary)
            rays2 = run["rays"] or rays_frame
            mrays = rays2 * n_secondary / run["seconds"] / 1e6
            extras.append(f"{label} {mrays:.1f} (rpp {rays2 / n_pix:.1f})")
        except Exception as e:  # noqa: BLE001 — secondary metric only
            traceback.print_exc()
            print(f"[bench] {label} failed: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            extras.append(f"{label} failed:{type(e).__name__}")
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()   # the child takes the card next

    entry, report["terrain1M"] = run_child(
        child_argv(device) if child is None else child)
    extras.append(entry)

    line = {
        "metric": METRIC,
        "value": round(mrays_fwd_bwd, 2),
        "unit": ("Mrays/s (fwd " + str(round(mrays_fwd, 1))
                 + "; " + "; ".join(extras)
                 + f"; rpp {traced_rpp:.1f} traced/"
                 + f"{rays_per_pixel(cfg)} analytic)"),
        "vs_baseline": round(mrays_fwd_bwd / BASELINE_MRAYS, 2),
    }
    return line, report


def main(argv=None):
    from tpu_restir_torch.cli import device_from_args
    p = argparse.ArgumentParser("tpu_restir_torch.bench",
                                description="Mrays/s of the 1080p ReSTIR "
                                "frame and its fwd+bwd step")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); no fallback")
    device = device_from_args(p.parse_args(argv))
    if device.type == "cuda":
        from tpu_restir_torch.accel import bvh
        from tpu_restir_torch.kernels import build
        # built before the first timed call, and reused by the child
        build.load_kernels()
        bvh._lib()
        print(f"[bench] {torch.cuda.get_device_name(device)}; nvidia-smi: "
              f"{gpu_line()}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}", flush=True)
    else:
        print(f"[bench] device {device}: no card, nothing here is a device "
              f"time", flush=True)
    line, report = run_bench(device)
    print(json.dumps(line), flush=True)
    return line, report


if __name__ == "__main__":
    main()
