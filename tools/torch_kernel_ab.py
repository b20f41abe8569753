"""The kernel checks and timings of chip_smoke.py (K1-K4 at 1080p, phase
3's Cornell part) and the bench frame's per-pass times, run on the kernels
of one checkout, for comparing two checkouts on one card:

    python3 tools/torch_kernel_ab.py [ROOT]

ROOT (default: this checkout) is the checkout whose `tpu_restir_torch`
is imported. The inputs, the checks, the timer (`chip_smoke.cuda_ms`:
runs enqueued back to back between CUDA events) and the bounds come from
THIS checkout's chip_smoke.py, so two checkouts run in turn (parent,
change, change, parent) compare like with like. Also prints the host time
of one any_hit and one gather_local call on inputs too small to keep the
device busy.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
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
    cs.phase_kernels(dev)
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


if __name__ == "__main__":
    main()
