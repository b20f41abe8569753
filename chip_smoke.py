#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_restir_torch) on one GPU.

    python3 chip_smoke.py [--profile=PATH]

Phases; any failure raises, so the exit code is non-zero and the final
line is not printed:
  1. device: require CUDA; print the card and its power limit; TF32 off.
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the time.
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: exact ids, masks and copies; float error printed
     with the tolerance stated; kernel and plain times (CUDA events).
  4. the main path: Renderer on the Cornell box at 1920x1080, the bench
     config (m_area=1, m_brdf=1, temporal, 5-neighbour pairwise spatial),
     8 frames; the traced rays per pixel must equal the analytic 28, every
     kernel must have launched, the image must be finite with a plausible
     mean; ms/frame, Mrays/s and a per-pass breakdown are printed.
  5. the same port at 64x32 for 4 frames on cuda and on cpu (plain
     versions): image means within 3 combined standard errors, fewer than
     1% of reservoirs holding a different sample.
  6. one JSON line of kernel results, then {"ok": true, "device": ...}.

--profile=PATH also profiles two 1080p frames (torch.profiler) and writes
the table of device time by kernel to PATH.

The script imports nothing of JAX or of the JAX package (tpu_restir),
and checks so at its end.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

WIDTH, HEIGHT = 1920, 1080
N_FRAMES = 8
SMALL_W, SMALL_H, SMALL_FRAMES = 64, 32, 4


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bench_cfg(width, height):
    from tpu_restir_torch.config import (CameraConfig, RenderConfig,
                                         RenderParams, RestirParams)
    return RenderConfig(
        camera=CameraConfig(width=width, height=height, fov_y_deg=45.0,
                            view_from=(0.0, -3.9, 1.0),
                            view_at=(0.0, 0.0, 1.0), pixel_sampler="random"),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(m_area=1, m_brdf=1, do_temporal_reuse=True,
                            do_spatial_reuse=True, spatial_neighbor_count=5,
                            spatial_mis="pairwise"),
        integrator="restir")


def cuda_ms(fn, reps):
    """Median milliseconds of fn() over reps runs (CUDA events), after a
    warm-up run."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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
    from tpu_restir_torch.kernels import build, local_gather, ray_tri
    t0 = time.perf_counter()
    ray_tri._lib()
    build.load("local_gather", local_gather._SIGNATURES)
    total = time.perf_counter() - t0
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

    def record(name, err, ms, plain_ms):
        """Largest error over a kernel's checks; times of its first one."""
        e = results.setdefault(name, {"max_abs_err": 0.0, "ms": ms,
                                      "plain_ms": plain_ms})
        e["max_abs_err"] = max(e["max_abs_err"], err)

    def check_closest(label, sc, o, d, tn, tf):
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
        print(f"[K1 closest_hit] {label}: {o.shape[0]} rays x "
              f"{w.shape[0]} tris; tri mismatches {tri_mis} (must be 0); "
              f"hits {int(hit.sum())}; max |t,u,v err| {err:.3g} "
              f"(tolerance 1e-6); kernel {ms:.3f} ms, plain {plain:.3f} ms",
              flush=True)
        require(tri_mis == 0, f"K1 {label}: triangle ids differ")
        require(err <= 1e-6, f"K1 {label}: t/u/v differ by {err}")
        record("closest_hit", err, ms, plain)

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
    check_closest("primary rays, 36 tris", scene, o, d, tn, inf)
    idx = scene.lights.tri_idx.long()
    sub = dataclasses.replace(scene, tri_v=scene.tri_v[idx],
                              woop=scene.woop[idx])
    ro, rd = _random_rays(gen, n, dev)
    check_closest("emissive subset, random rays, tfar=inf", sub, ro, rd, tn,
                  inf)

    # K2: random shadow segments; 10% zero-length (dead: tfar < tnear,
    # direction 0) as phat.py makes for pixels whose f is already 0
    from tpu_restir_torch import mathx
    a, _ = _random_rays(gen, n, dev)
    b, _ = _random_rays(gen, n, dev)
    b = torch.where((torch.rand((n, 1), generator=gen, device=dev) < 0.1),
                    a, b)
    seg = b - a
    dist = mathx.length(seg)
    sd = mathx.normalize(seg).contiguous()
    tf = (dist - cfg.params.tfar_offset).contiguous()
    w = ray_tri.woop_rows(scene)
    got = ray_tri.any_hit(scene, a, sd, tn, tf)
    want = ray_tri.any_hit_ref(w, a, sd, tn, tf)
    torch.cuda.synchronize()
    mis = int((got != want).sum())
    ms = cuda_ms(lambda: ray_tri.any_hit(scene, a, sd, tn, tf), 10)
    plain = cuda_ms(lambda: ray_tri.any_hit_ref(w, a, sd, tn, tf), 3)
    print(f"[K2 any_hit] shadow segments: {n} rays x {w.shape[0]} tris, "
          f"{int((tf < tn).sum())} dead; mask mismatches {mis} (must be 0); "
          f"occluded {int(want.sum())}; kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms", flush=True)
    require(mis == 0, "K2: occlusion masks differ")
    record("any_hit", float((got.float() - want.float()).abs().max()), ms,
           plain)

    # K3: spatial taps (K=5, r=5, C=24 slim and C=32 full), temporal
    # reprojection taps (K=1, r=8, C=24 and the C=3 position tap)
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
        ty, tx = taps(k, r)
        got = lg.gather_local(payload, ty, tx, r)
        want = lg.gather_local_ref(payload, ty, tx)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: lg.gather_local(payload, ty, tx, r), 10)
        plain = cuda_ms(lambda: lg.gather_local_ref(payload, ty, tx), 10)
        print(f"[K3 gather_local] {label}: K={k} r={r} C={c} at "
              f"{HEIGHT}x{WIDTH}; bit-identical {equal}; kernel {ms:.3f} ms, "
              f"plain {plain:.3f} ms", flush=True)
        require(equal, f"K3 {label}: gather differs from the plain version")
        record("gather_local", err, ms, plain)
    return results


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


def phase_small():
    """The port at 64x32 on cuda and on cpu; returns (mean, stderr) of the
    cuda image."""
    import torch

    from tpu_restir_torch import cornell_box
    cfg = bench_cfg(SMALL_W, SMALL_H)
    out = {}
    for dev in ("cuda", "cpu"):
        img, state = run_frames(cornell_box(dev), cfg, torch.device(dev),
                                SMALL_FRAMES)
        pix = img.mean(-1).cpu()
        out[dev] = (float(pix.mean()), float(pix.std() / pix.numel() ** 0.5),
                    state.res_prev.sample.point.cpu())
    (mc, sc, pc), (mp, sp, pp) = out["cuda"], out["cpu"]
    comb = (sc * sc + sp * sp) ** 0.5
    differ = float(((pc - pp).abs().amax(-1) > 1e-4).float().mean())
    print(f"[cross-device] {SMALL_W}x{SMALL_H}, {SMALL_FRAMES} frames: mean "
          f"cuda {mc:.6f} cpu {mp:.6f} (|diff| {abs(mc - mp):.3g}, allowed "
          f"3 x {comb:.3g}); reservoirs with a different sample "
          f"{differ:.4%} (allowed < 1%)", flush=True)
    require(abs(mc - mp) <= 3 * comb, "cuda and cpu image means disagree")
    require(differ < 0.01, "cuda and cpu reservoirs disagree")
    return mc, sc


def phase_main_path(dev, small_mean, small_se, smi):
    import torch

    from tpu_restir_torch import cornell_box, metrics
    from tpu_restir_torch.kernels import local_gather as lg
    from tpu_restir_torch.kernels import ray_tri
    from tpu_restir_torch.render import intersect
    from tpu_restir_torch.renderer import Renderer

    cfg = bench_cfg(WIDTH, HEIGHT)
    scene = cornell_box(dev)
    Renderer(scene, cfg, device=dev).run(1)      # warm-up (allocator, libs)
    torch.cuda.synchronize()
    renderer = Renderer(scene, cfg, device=dev)
    for counts in (ray_tri.LAUNCHES, lg.LAUNCHES):
        for key in counts:
            counts[key] = 0
    intersect.QUERY_LOG = qlog = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = renderer.run(N_FRAMES)                  # ends in a synchronize
    dt = time.perf_counter() - t0
    intersect.QUERY_LOG = None
    launches = {**ray_tri.LAUNCHES, **lg.LAUNCHES}
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


def phase_profile(dev, path):
    """Two 1080p frames under torch.profiler: device time summed over the
    CUDA kernels only (operator rows repeat their kernels' time), the
    share of K1-K3, and the busy share against the wall time of the same
    two frames run without the profiler."""
    import torch
    from torch.autograd import DeviceType

    from tpu_restir_torch import cornell_box
    cfg = bench_cfg(WIDTH, HEIGHT)
    scene = cornell_box(dev)
    run_frames(scene, cfg, dev, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_frames(scene, cfg, dev, 2)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_frames(scene, cfg, dev, 2)
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
                              ("gather_local", "gather_kernel"))}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))
    print(f"[profile] 2 frames: wall {wall_ms:.1f} ms without the profiler; "
          f"device kernels {device_ms:.1f} ms in {sum(e.count for e in kernels)}"
          f" launches, busy share {device_ms / wall_ms:.3f}; K1-K3 ms "
          f"{ {k: round(v, 3) for k, v in ours.items()} } "
          f"({sum(ours.values()) / device_ms:.3f} of device time); table in "
          f"{path}", flush=True)


def main():
    import torch  # noqa: F401  (fails here without PyTorch)

    import tpu_restir_torch  # noqa: F401  (fails outside the repository)

    dev, name, smi = phase_device()
    phase_build()
    results = phase_kernels(dev)
    small_mean, small_se = phase_small()
    launches = phase_main_path(dev, small_mean, small_se, smi)
    phase_passes(dev)
    profile = [a.split("=", 1)[1] for a in sys.argv[1:]
               if a.startswith("--profile=")]
    if profile:
        phase_profile(dev, profile[0])
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
    }
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k],
                "max_abs_err": results[k]["max_abs_err"],
                "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
               for k, (src, rep) in meta.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
