"""One run of one benchmark cell of the PyTorch/CUDA port on one H100:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (`setup_s`, from the start of this module): the port's kernels
are loaded (built by nvcc and g++ into the checkout's `build/` on a
checkout's first run), the scene's raw arrays are made by the
configuration's generator and handed to the port's `build_scene` on the
card, and the traffic's own first frames or steps run through the same
call the window drives. The window then drives that same object for
`--seconds`: `Renderer.step()` back to back with a CUDA event after
each, or gradient steps (loss, backward, Adam, the loss read back).
With `--trace 1` some of the window's frames or steps run under
`torch.profiler` (`perfbench/trace.py`), with the per-layer metrics'
ranges wrapped around the port's functions, and the per-layer metrics
are printed in place of the end-to-end ones. The traffic kind
(`perfbench/kinds/<kind>.py`) is found by the name its traffic file
gives.

After the window the port's state is freed and the plain reference
(`perfbench/refrender`) works out the checked frames or steps again
from the same inputs (`perfbench/check.py`). Each number compared is
printed beside its limit (`perfbench/limits/<cell>.json`) on standard
error, and last in the result line, which is the last line of standard
output. There is no fallback to the CPU: without a card the run exits 2
and prints no result; with JAX or the JAX package loaded it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from perfbench import harness  # noqa: E402

# --- one run ---------------------------------------------------------------


def read_per_layer(cell, traced, log) -> dict:
    """The cell's per-layer metrics from the trace; a metric whose reader
    finds nothing is left out, and the reason printed."""
    out = {}
    for m in cell.per_layer:
        mod = harness.metric_module(m["name"])
        why = [traced.missing[s.name]
               for s in mod.SPANS + getattr(mod, "COUNTS", [])
               if s.name in traced.missing]
        value = None if why else mod.read(traced)
        if hasattr(mod, "describe") and not why:
            log(f"[perfbench] {m['name']}: {mod.describe(traced)}")
        if value is None:
            log(f"[perfbench] {m['name']}: nothing to read"
                + (f" ({'; '.join(why)})" if why else ""))
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _log_window(out, log) -> None:
    """The window's shape on standard error: units, seconds, the first
    unit times, the longest, and the mean unit time of each tenth of the
    window in order (a warm-up that reaches into the window shows in the
    first tenths), then the traced units' own stages."""
    win = out.window
    ms = win.unit_ms()
    k = len(ms)
    tenths = [sum(ms[k * j // 10:k * (j + 1) // 10])
              / max(k * (j + 1) // 10 - k * j // 10, 1) for j in range(10)]
    log(f"[perfbench] window: {win.units} units in {win.seconds:.3f} s; "
        f"first unit ms {[round(x, 3) for x in ms[:5]]}; longest "
        f"{max(ms):.3f} at unit {ms.index(max(ms))}; mean of each tenth "
        f"{[round(x, 3) for x in tenths]}")
    if out.traced is not None:
        log(f"[perfbench] traced: {out.traced.describe()}")


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             size=None, log=None, t_start=T_START) -> dict:
    """One run of `cell` on `device` -> the result object (without the
    module check, which `main` makes last). size: (width, height) in
    place of the configuration's, for the CPU tests only; t_start: the
    host clock at which set-up began."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    seeds = harness.run_seeds(seed)
    tracing = None
    if trace:
        mods = [harness.metric_module(m["name"]) for m in cell.per_layer]
        tracing = ([s for m in mods for s in m.SPANS],
                   [s for m in mods for s in getattr(m, "COUNTS", [])])
    kind = harness.kind_module(cell.traffic["kind"])
    out = kind.run(cell, seeds, seconds, device, size, tracing, t_start)
    if out.traced is not None:
        steady = out.window.untraced_unit_ms()
        out.traced.period_ms = statistics.fmean(steady) if steady else 0.0
    _log_window(out, log)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = out.numbers()
    log(f"[perfbench] reference: {time.perf_counter() - t0:.3f} s")
    if trace:
        metrics = read_per_layer(cell, out.traced, log)
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    checks = {}
    correct = out.failed == 0
    for name, limit in cell.limits.items():
        value = numbers.get(name, float("inf"))
        checks[name] = {"value": value, "limit": limit}
        correct = correct and value <= limit
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": out.peak_bytes}
    result = {"correct": bool(correct), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace:
        timeline = out.traced.device
        dev["busy_s"] = timeline.busy_us() / 1e6
        dev["window_s"] = timeline.window_us() / 1e6
        result["breakdown"] = {"device_ops": timeline.top_device_ops(),
                               "idle_gaps": timeline.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser("perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.find_cell(harness.load_spec(), args.workload)
    if importlib.util.find_spec("tpu_restir_torch") is None:
        print("[perfbench] the program under test, tpu_restir_torch, is "
              "not in this checkout", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"[perfbench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = harness.forbidden_modules()
    if bad:
        print(f"[perfbench] loaded modules that the port must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[perfbench] check {name} {c['value']!r} limit "
              f"{c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
