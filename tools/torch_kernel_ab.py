"""The kernel checks and timings of chip_smoke.py and the bench frame's
per-pass, whole-frame and fwd+bwd times, run on the kernels of one
checkout, for comparing two checkouts on one card:

    python3 tools/torch_kernel_ab.py [ROOT] [--woop-only]

ROOT (default: this checkout) is the checkout whose `tpu_restir_torch`
is imported. The inputs, the checks, the timer (`chip_smoke.cuda_ms`:
runs enqueued back to back between CUDA events) and the bounds come from
THIS checkout's chip_smoke.py, so two checkouts run in turn (parent,
change, change, parent) compare like with like. A run builds ROOT's
kernels and prints their registers, then runs phase 3's checks of K1-K4
at 1080p (its Cornell part; K4's lines print a sha256 of its output on
the seeded normal cotangents, which two checkouts with the same summation
order share) and of K5-K8 on the terrain100k, lights1k and
terrain100k-128 queries (the G-buffer query through K5, the shadow and
occlusion queries through K6, with the cull on terrain100k and without it
on lights1k, and their Woop twins through K7/K8 with K5/K6 on the same
packets), the host time of one any_hit and one
gather_local call on inputs too small to keep the device busy, the
Cornell bench frame's per-pass times, the ms/frame of the bench frame on
Cornell, terrain100k and lights1k (`chip_smoke.timed_frames` of
chip_smoke.LARGE_FRAMES frames), the 1080p fwd+bwd step
(`chip_smoke.phase_fwd_bwd`), and the device's busy share over two
Cornell frames and over one fwd+bwd step (`chip_smoke._profile`; tables
in out/ab_profile/ of this checkout).

--woop-only runs only the build and the checks of K7/K8 (and K5/K6 on
the same packets) on the terrain100k-128 queries, for comparing variants
of the Woop kernels.

The checks call plain versions that an older ROOT may lack
(`cluster_trace.slab_live_ref`, `woop_cull_boxes`,
`local_gather.scatter_local_ordered_ref`); those are taken from this
checkout's modules. A ROOT whose `any_packets_mxu` takes no cluster boxes
(K8 without a cull) is called without them.
"""

import importlib.util
import inspect
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# plain versions the checks need: kernels module -> names
PLAIN = {"cluster_trace": ("slab_live_ref", "woop_cull_boxes"),
         "local_gather": ("scatter_local_ordered_ref",)}


def _borrow_plain_versions():
    """Give ROOT's kernel modules this checkout's plain versions that they
    lack (plain PyTorch code, not the kernels under comparison)."""
    for name, fns in PLAIN.items():
        mod = importlib.import_module(f"tpu_restir_torch.kernels.{name}")
        missing = [f for f in fns if not hasattr(mod, f)]
        if not missing:
            continue
        spec = importlib.util.spec_from_file_location(
            f"_ab_here_{name}",
            os.path.join(HERE, "tpu_restir_torch", "kernels", f"{name}.py"))
        here = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = here   # its dataclasses look it up
        spec.loader.exec_module(here)
        for f in missing:
            setattr(mod, f, getattr(here, f))
        print(f"[ab] {name}: plain {missing} taken from {HERE}", flush=True)


def _adapt_any_packets_mxu():
    """Let ROOT's K8 wrapper be called as any_packets_mxu(cwoop, cmin, cmax,
    pk) where it takes (cwoop, pk), by its callers here and in ROOT."""
    from tpu_restir_torch.kernels import cluster_trace as ct
    old = ct.any_packets_mxu
    if len(inspect.signature(old).parameters) != 2:
        return

    def any_packets_mxu(cwoop, *rest):
        return old(cwoop, rest[-1])

    ct.any_packets_mxu = any_packets_mxu
    print("[ab] cluster_trace.any_packets_mxu of ROOT takes no boxes",
          flush=True)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    woop_only = "--woop-only" in sys.argv[1:]
    root = os.path.abspath(args[0] if args else HERE)
    sys.path.insert(0, HERE)
    import chip_smoke as cs   # the inputs, checks, timer and bounds
    sys.path.insert(0, root)  # the kernels of ROOT
    import torch

    import tpu_restir_torch
    from tpu_restir_torch import cornell_box
    from tpu_restir_torch.kernels import local_gather as lg
    from tpu_restir_torch.kernels import ray_tri
    cs.require(os.path.dirname(os.path.dirname(tpu_restir_torch.__file__))
               == root, f"tpu_restir_torch was not imported from {root}")
    dev, _name, smi = cs.phase_device()
    print(f"[ab] kernels of {root}", flush=True)
    _borrow_plain_versions()
    _adapt_any_packets_mxu()
    cs.phase_build()
    if woop_only:
        cs.phase_ptrace_kernels(dev, {}, scenes=("terrain100k-128",))
        return
    cs.phase_kernels(dev)
    cs.phase_ptrace_kernels(dev, {})
    scene = cornell_box(dev)
    rays = [torch.rand((1, 3), device=dev), torch.rand((1, 3), device=dev),
            torch.zeros((1,), device=dev), torch.ones((1,), device=dev)]
    taps = torch.zeros((1, 8, 8), dtype=torch.int32, device=dev)
    payload = torch.rand((8, 8, 24), device=dev)
    for name, fn in (("any_hit", lambda: ray_tri.any_hit(scene, *rays)),
                     ("gather_local",
                      lambda: lg.gather_local(payload, taps, taps, 1))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host_ms = time.perf_counter() - t0   # seconds per 1000 calls
        torch.cuda.synchronize()
        print(f"[ab] host time of one {name} call: {host_ms:.4f} ms "
              f"({smi})", flush=True)
    cs.phase_passes(dev)
    frames = {}
    for label in ("cornell", "terrain100k", "lights1k"):
        big, view = cs.scene_and_view(label, dev)
        dt = cs.timed_frames(big, cs.bench_cfg(cs.WIDTH, cs.HEIGHT, view),
                             dev, cs.LARGE_FRAMES)[2]
        frames[label] = round(dt / cs.LARGE_FRAMES * 1e3, 2)
    print(f"[ab] ms/frame at {cs.WIDTH}x{cs.HEIGHT}, {cs.LARGE_FRAMES} "
          f"frames after a warm-up: {frames} ({smi})", flush=True)
    cs.phase_fwd_bwd(dev, smi)
    out = os.path.join(HERE, "out", "ab_profile", os.path.basename(root))
    cfg = cs.bench_cfg(cs.WIDTH, cs.HEIGHT)
    cs._profile("2 forward frames",
                lambda: cs.run_frames(scene, cfg, dev, 2), f"{out}_frames.txt")
    vg, params = cs.bench_step(dev, cs.WIDTH, cs.HEIGHT)
    cs._profile("1 fwd+bwd step", lambda: vg(params), f"{out}_fwd_bwd.txt")


if __name__ == "__main__":
    main()
