"""The control of `correct`: the plain reference put in the program's
place and computed with every buffer that leaves a ReSTIR pass, a hit
query or a path-traced frame stored in bfloat16 (`check.control`), the
nearest precision below the configurations' float32. It reads the same
numbers as a run does, against the float32 reference, so each limit can
be set between the program's readings and the control's:

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3

prints one JSON line per seed with the control's numbers, and the cell's
limits; for the gradient cell `--faults half,altered` adds the readings
of those faults planted in the reference. The benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from perfbench import check, harness


@contextlib.contextmanager
def loss_fault(name: str):
    """A fault planted in the reference's gradient step: "half" takes the
    loss over the top half of the pixels only, "altered" returns the loss
    times 1.01."""
    from perfbench.refrender.diff import render as rd
    orig = rd.loss_fn

    def half(params, scene, cam, cfg, seeds, target):
        img = rd.render_with_params(params, scene, cam, cfg, seeds)
        h = img.shape[0] // 2
        return torch.mean((img[:h] - target[:h]) ** 2)

    rd.loss_fn = {"half": half,
                  "altered": lambda *a: orig(*a) * 1.01}[name]
    try:
        yield
    finally:
        rd.loss_fn = orig


def control_numbers(cell, seed: int, device, size=None,
                    faults=()) -> dict:
    """The numbers a run of `cell` compares, with the control in the
    program's place (key "control"), and with each of `faults` (gradient
    cells: "half", "altered") planted in the reference put there."""
    seeds = harness.run_seeds(seed)
    tr = cell.traffic
    if tr["kind"] == "fwdbwd":
        n = tr["check_steps"]
        ref = check.ref_fwdbwd(cell, seeds, n, device, size)
        with check.control():
            out = {"control": check.fwdbwd_numbers(
                check.ref_fwdbwd(cell, seeds, n, device, size), ref)}
        for f in faults:
            with loss_fault(f):
                out[f] = check.fwdbwd_numbers(
                    check.ref_fwdbwd(cell, seeds, n, device, size), ref)
        return out
    nums = {}
    n = tr.get("check_frames", 0)
    if n:
        ref = check.ref_restir_frames(cell, seeds, n, device, size)
        with check.control():
            low = check.ref_restir_frames(cell, seeds, n, device, size)
        nums["pixels_off"] = max(check.pixels_off(a, b)
                                 for a, b in zip(low, ref))
    if tr.get("check_window_draw_below", 0):
        k = tr["warmup_frames"] + seeds.check_draw % tr[
            "check_window_draw_below"]
        ref = check.ref_path_frame(cell, seeds, k, device, size)
        with check.control():
            low = check.ref_path_frame(cell, seeds, k, device, size)
        nums["pixels_off"] = max(nums.get("pixels_off", 0.0),
                                 check.pixels_off(low, ref))
    return {"control": nums}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--faults", default="",
                   help="gradient cells: comma-separated faults (half, "
                   "altered) planted in the reference")
    args = p.parse_args(argv)
    cell = harness.find_cell(harness.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("[perfbench.control] needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        nums = control_numbers(cell, int(s), dev, faults=[
            f for f in args.faults.split(",") if f])
        print(json.dumps({"workload": cell.name, "seed": int(s),
                          "seconds": time.perf_counter() - t0,
                          "limits": cell.limits, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
