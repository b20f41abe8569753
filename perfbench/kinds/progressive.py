"""The progressive render: one Renderer, static camera, accumulation on.
Its first `warmup_frames` frames are set-up (the first `check_frames` of
them are compared); the window steps it back to back, and one of its
first `check_window_draw_below` frames (where that is set), drawn from
the seed, is compared. A traced run profiles `trace_frames` frames a
quarter of the way into the window."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import check
from perfbench import trace as trace_mod
from perfbench.window import (GIB, Outcome, Program, peak_bytes, reset_peak,
                              run_window, sync)


def run(cell, seeds, seconds, device, size, tracing, t_start) -> Outcome:
    from tpu_restir_torch.renderer import Renderer
    tr = cell.traffic
    prog = Program(cell, seeds, device, size)
    r = Renderer(prog.scene, prog.cfg, device)
    kept = []
    for i in range(tr["warmup_frames"]):
        frame = r.step()
        if i < tr.get("check_frames", 0):
            kept.append(frame.cpu())
    sync(device)
    setup_s = time.perf_counter() - t_start
    first = r.frame_ctr

    n_keep = tr.get("check_window_draw_below", 0)
    window_frames = {}
    bad = [torch.zeros((), dtype=torch.int64, device=device)]

    def keep(i, frame):
        bad[0] = bad[0] + (~torch.isfinite(frame)).any().to(torch.int64)
        if i < n_keep:
            host = torch.empty(frame.shape, dtype=frame.dtype,
                               pin_memory=device.type == "cuda")
            host.copy_(frame, non_blocking=True)
            window_frames[i] = host

    trace = None
    if tracing is not None:
        def trace(one):
            return trace_mod.capture(one, tr["trace_frames"], *tracing,
                                     lambda: sync(device))

    reset_peak(device)
    win = run_window(lambda i: r.step(), seconds, device, keep, trace)
    peak = peak_bytes(device)
    e2e = {"frame_ms": win.seconds * 1e3 / win.units,
           "frame_ms_p90": float(np.quantile(win.unit_ms(), 0.9)),
           "peak_gib": peak / GIB, "setup_s": setup_s}
    failed = int(bad[0])
    failed += sum(int(not torch.isfinite(f).all()) for f in kept)

    def numbers():
        out = {}
        if kept:
            ref = check.ref_restir_frames(cell, seeds, len(kept), device,
                                          size)
            out["pixels_off"] = max(check.pixels_off(p, q)
                                    for p, q in zip(kept, ref))
        if n_keep:
            k = seeds.check_draw % min(win.units, n_keep)
            ref = check.ref_path_frame(cell, seeds, first + k, device, size)
            out["pixels_off"] = max(out.get("pixels_off", 0.0),
                                    check.pixels_off(window_frames[k], ref))
        return out

    return Outcome(win.units, failed, e2e, peak, win.traced, numbers, win)
