"""One device against N row-sharded ranks for the ReSTIR step (counterpart
of the repository's `tools/scaling_bench.py`, the same JSON keys).

    python -m tpu_restir_torch.tools.scaling_bench [--device cuda]
        [--res 256 | --size 1920x1080] [--frames 8] [--devices 2]
        [--radius 4.0] [--reps 3]

The JAX tool's configuration: the Cornell box, m_area 1, m_brdf 1,
temporal reuse and 5-neighbour pairwise spatial reuse at the given
radius. t1: `restir_step` on one device in this process; tN: the same
frames row-sharded (`dist.sharded.make_sharded_restir_step`) over N ranks
of a gloo group spawned on this host, as `chip_smoke.py`'s [dist] phase
runs them: on the CPU each rank renders on the CPU (with 1/N of this
process's intra-op threads), on the card all N ranks share cuda:0 (NCCL
refuses two ranks on one device) and gloo stages every exchanged buffer
through host memory. So, as with the JAX tool's virtual CPU mesh, the
ranks share one device's compute: t1 / tN measures what sharding adds
(the halo exchange, its staging, the collectives), not a speed-up. A
run's frame time is the median over `reps` windows of `frames` chained
frames, after one warm-up frame, each window ending in a synchronize
(CUDA events on the card, the host clock on the CPU); tN is the slowest
rank's.

halo_bytes_per_frame_per_device is the JAX tool's formula: 32 float32
channels of `halo` rows to and from each of two neighbours, 2 * 2 * halo
* width * 32 * 4 bytes. halo_bytes_measured_per_frame_per_device is what
the ranks sent through collectives a frame (`Mesh.stats`, the mean over
the ranks): every exchange of the frame (the temporal pass's and the
spatial pass's halos of the port's packed G-buffer and reservoir fields,
at their own byte widths), sent bytes only, an edge rank sending to one
neighbour; and, on the card, staged_bytes_per_frame_per_device, the
bytes staged between the card and the host.

The default device is cuda, which must be there: there is no fallback to
the CPU.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import statistics
import tempfile
import time

import torch

from tpu_restir_torch import bench, rng
from tpu_restir_torch.config import (CameraConfig, RenderConfig, RenderParams,
                                     RestirParams)
from tpu_restir_torch.metrics import sync

JAX_CHANNELS = 32   # the JAX tool's reuse payload: 32 packed f32 channels
TIMEOUT_S = 600     # a collective that waits longer raises on every rank


def scaling_cfg(width: int, height: int, radius: float) -> RenderConfig:
    """The JAX tool's ReSTIR configuration (scaling_bench.py:60-69)."""
    return RenderConfig(
        camera=CameraConfig(width=width, height=height, fov_y_deg=45.0,
                            view_from=(0.0, -3.9, 1.0),
                            view_at=(0.0, 0.0, 1.0), pixel_sampler="random"),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(m_area=1, m_brdf=1, do_temporal_reuse=True,
                            do_spatial_reuse=True, spatial_neighbor_count=5,
                            spatial_reuse_radius=radius,
                            spatial_mis="pairwise"),
        integrator="restir")


def timed_windows(step, state, frames: int, reps: int, device, mesh=None):
    """One warm-up frame, then `reps` windows of `frames` chained frames,
    each window ending in a synchronize -> (median ms a frame, bytes sent
    and staged a frame over the windows)."""
    from tpu_restir_torch.dist import mesh as mesh_mod
    frame, state = step(rng.make_frame_seed(0, 0), state, 0)
    sync(frame)
    cuda = torch.device(device).type == "cuda"
    ms, f = [], 1
    s0 = dict(mesh.stats) if mesh else None
    for _ in range(reps):
        if mesh:
            mesh_mod.barrier(mesh)
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        for _ in range(frames):
            frame, state = step(rng.make_frame_seed(0, f), state, f)
            f += 1
        if cuda:
            b.record()
            torch.cuda.synchronize(device)
            ms.append(a.elapsed_time(b) / frames)
        else:
            ms.append((time.perf_counter() - t0) * 1e3 / frames)
    per = {k: (mesh.stats[k] - s0[k]) / (reps * frames) if mesh else 0.0
           for k in ("sent_bytes", "staged_bytes")}
    return statistics.median(ms), per


def _rank(rank, n, port, outdir, width, height, frames, reps, radius,
          device, threads):
    """One rank: joins the gloo group over localhost, renders its rows of
    the timed frames and writes its ms and bytes to outdir."""
    import torch.distributed as dist

    from tpu_restir_torch.dist import mesh as mesh_mod
    from tpu_restir_torch.dist.sharded import make_sharded_restir_step
    from tpu_restir_torch.render import camera as cam_mod
    from tpu_restir_torch.render.integrators.restir.pipeline import (
        init_restir_state)
    from tpu_restir_torch.scene.cornell import cornell_box
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        dev = torch.device(device)
        mesh = mesh_mod.make_mesh(n, "tiles", dev)
        cfg = scaling_cfg(width, height, radius)
        scene = cornell_box(dev)
        cam = cam_mod.make_camera(cfg.camera, dev)
        sharded = make_sharded_restir_step(mesh, cfg)

        def step(seed, state, f):
            return sharded(scene, cam, seed, state, f)

        ms, per = timed_windows(step, init_restir_state(height // n, width,
                                                        dev),
                                frames, reps, dev, mesh)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
            json.dump({"rank": rank, "ms": ms, "backend": mesh.backend,
                       "staged": mesh.staged, **per}, fh)
    finally:
        dist.destroy_process_group()


def measure(res: int = 256, frames: int = 8, n_devices: int = 2,
            radius: float = 4.0, device="cuda", width=None, reps: int = 3):
    """t1 against tN for the ReSTIR step at width x res (width defaults to
    res, the JAX tool's square) -> dict of the JAX tool's keys and the
    measured bytes."""
    import torch.multiprocessing as mp

    from tpu_restir_torch.dist.halo import halo_width
    from tpu_restir_torch.render import camera as cam_mod
    from tpu_restir_torch.render.integrators.restir.pipeline import (
        init_restir_state, restir_step)
    from tpu_restir_torch.scene.cornell import cornell_box
    dev = torch.device(device)
    height, width = res, width or res
    if height % n_devices:
        raise ValueError(f"height {height} not divisible by {n_devices}")
    cfg = scaling_cfg(width, height, radius)
    scene = cornell_box(dev)
    cam = cam_mod.make_camera(cfg.camera, dev)

    def step(seed, state, f):
        return restir_step(scene, cam, cfg, seed, state, f)

    t1, _ = timed_windows(step, init_restir_state(height, width, dev),
                          frames, reps, dev)
    del scene, cam
    threads = max(1, torch.get_num_threads() // n_devices)
    with tempfile.TemporaryDirectory() as outdir:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        mp.start_processes(
            _rank, args=(n_devices, port, outdir, width, height, frames, reps,
                         radius, str(dev), threads),
            nprocs=n_devices, start_method="spawn")
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(outdir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    tn = max(r["ms"] for r in ranks)
    halo = halo_width(radius)
    return {
        "n_devices": n_devices,
        "res": res if width == res else f"{width}x{height}",
        "frames": frames,
        "t1_ms": round(t1, 2),
        "tN_ms": round(tn, 2),
        "overhead_pct": round((tn / t1 - 1.0) * 100.0, 1),
        "scaling_eff": round(t1 / tn, 3),
        "halo_rows": halo,
        "halo_bytes_per_frame_per_device":
            2 * 2 * halo * width * JAX_CHANNELS * 4,
        "halo_bytes_measured_per_frame_per_device":
            statistics.mean(r["sent_bytes"] for r in ranks),
        "staged_bytes_per_frame_per_device":
            statistics.mean(r["staged_bytes"] for r in ranks),
        "rank_ms": [round(r["ms"], 2) for r in ranks],
        "backend": ranks[0]["backend"], "reps": reps,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--size", default=None,
                    help="WxH in place of the square --res")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    width, res = args.res, args.res
    if args.size:
        width, res = (int(x) for x in args.size.lower().split("x"))
    r = measure(res, args.frames, args.devices, args.radius, args.device,
                width, args.reps)
    if torch.device(args.device).type == "cuda":
        r["gpu"] = bench.gpu_line()
    print(json.dumps(r), flush=True)
    return r


if __name__ == "__main__":
    main()
