"""1M-triangle scale proof: the full 1080p spatiotemporal ReSTIR frame of
the bench configuration on the procedural terrain at ~1e6 triangles
(counterpart of the repository's `tools/bench_terrain1m.py`).

    python -m tpu_restir_torch.tools.bench_terrain1m [--device cuda]

terrain_scene(1_000_000) has 1,002,530 triangles in C ~ 15.7k clusters of
64, so the supercluster factor is 4 (`cluster_trace.pick_factor`, at most
SUPER_MAX = 4096 shortlist entries a packet) and every query runs K5/K6
in cull mode 5 on per-cluster boxes (C <= BOX_MAX). One warm-up frame
with its counts recorded, then 2 chained frames and one synchronize.
Earlier lines: the scene build's seconds by stage, C, the factor, S and
the cull modes, then one "[terrain1M] {...}" JSON line of the run
(`tpu_restir_torch.bench` reads it). The last line of stdout is
"TERRAIN1M <mrays> rpp <rpp>". Run alone or as the bench's child.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from tpu_restir_torch import bench
from tpu_restir_torch.kernels import cluster_trace as ct

N_TRIS = 1_000_000
N_FRAMES = 2


@contextlib.contextmanager
def stage_seconds(seconds, stages):
    """Wraps each (module, name, label) of stages for the block, adding
    the wall seconds of its calls to seconds[label]."""
    saved = []
    for module, name, label in stages:
        fn = getattr(module, name)

        def timed(*args, _fn=fn, _label=label, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                seconds[_label] = (seconds.get(_label, 0.0)
                                   + time.perf_counter() - t0)

        saved.append((module, name, fn))
        setattr(module, name, timed)
    try:
        yield seconds
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def build_timed(device, n_tris: int = N_TRIS):
    """terrain_scene(device, n_tris) -> (scene, seconds by stage: the
    heightfield, the host BVH2 (accel.cpp), the wide BVH collapse that
    orders the scene (SceneArrays.bvh), the cluster and Woop packing, and
    the rest (normals, lights, copies to the device), and the total)."""
    from tpu_restir_torch.accel import bvh
    from tpu_restir_torch.scene import procedural
    from tpu_restir_torch.scene import scene as scene_mod
    seconds = {}
    stages = [(procedural, "_fbm", "heightfield"),
              (bvh, "build_bvh2", "host BVH2 (accel.cpp)"),
              (scene_mod, "collapse_bvh8", "SceneArrays.bvh collapse"),
              (scene_mod, "build_clusters", "cluster and Woop packing"),
              (scene_mod, "build_woop_matrices", "cluster and Woop packing"),
              (scene_mod, "build_cluster_woop", "cluster and Woop packing")]
    t0 = time.perf_counter()
    with stage_seconds(seconds, stages):
        scene = procedural.terrain_scene(device, n_tris)
        bench.sync(scene.tri_v)
    total = time.perf_counter() - t0
    seconds["the rest"] = total - sum(seconds.values())
    seconds["total"] = total
    return scene, seconds


def scene_info(scene) -> dict:
    """The clustered traversal's shape on this scene: triangles, C, the
    supercluster factor, S (shortlist entries a packet), the cull mode
    of each query kind and whether mode 5 culls on per-cluster boxes."""
    c = scene.cluster_tris.shape[0]
    f = ct.pick_factor(c)
    return {"triangles": scene.num_tris, "clusters": c,
            "cluster_size": scene.cluster_size, "factor": f,
            "S": -(-c // f),
            "cull_modes": {k: ct._skip_for(k, c, f)
                           for k in ("closest", "any")},
            "per_cluster_boxes": ct.cull_boxes(scene.cluster_min,
                                               scene.cluster_max, f)[2]}


def run(scene, cfg, device, n_frames: int = N_FRAMES) -> dict:
    """One warm-up frame with its counts recorded, then n_frames chained
    frames and one synchronize (`bench.chained_frames`) -> its dict with
    ms a frame, Mrays/s and the traced rays per pixel added."""
    out = bench.chained_frames(scene, cfg, device, n_frames)
    n_pix = float(cfg.camera.width * cfg.camera.height)
    out["ms_frame"] = out["seconds"] / n_frames * 1e3
    out["mrays"] = out["rays"] * n_frames / out["seconds"] / 1e6
    out["rpp"] = out["rays"] / n_pix
    return out


def main(argv=None):
    from tpu_restir_torch.cli import device_from_args
    from tpu_restir_torch.kernels import build
    p = argparse.ArgumentParser("tpu_restir_torch.tools.bench_terrain1m")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); no fallback")
    device = device_from_args(p.parse_args(argv))
    rebuilt = []
    if device.type == "cuda":
        build.load_kernels()   # from build/ where the bench built them
        rebuilt = [k for k, v in build.BUILD_INFO.items() if v["seconds"]]
    scene, seconds = build_timed(device)
    info = scene_info(scene)
    print(f"[terrain1M] terrain_scene({N_TRIS}): {info['triangles']} "
          f"triangles, C={info['clusters']} clusters of "
          f"{info['cluster_size']}, factor {info['factor']}, S={info['S']}, "
          f"cull modes {info['cull_modes']} (per-cluster boxes "
          f"{info['per_cluster_boxes']}); built in "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()),
          flush=True)
    cfg = bench.bench_cfg(bench.WIDTH, bench.HEIGHT, bench.TERRAIN_VIEW)
    out = run(scene, cfg, device)
    info.update(build_seconds=seconds, rays=out["rays"], rpp=out["rpp"],
                ms_frame=out["ms_frame"], peak_gib=out["peak_gib"],
                finite=bool(torch.isfinite(out["frame"]).all()),
                rebuilt_kernels=rebuilt)
    print(f"[terrain1M] {N_FRAMES} chained frames: {out['ms_frame']:.2f} "
          f"ms/frame; traced rays {out['rays']} a frame; peak memory "
          f"{bench.fmt_gib(out['peak_gib'])}; frame finite {info['finite']}",
          flush=True)
    print("[terrain1M] " + json.dumps(info), flush=True)
    print(f"TERRAIN1M {out['mrays']:.1f} rpp {out['rpp']:.1f}", flush=True)
    return info


if __name__ == "__main__":
    main()
