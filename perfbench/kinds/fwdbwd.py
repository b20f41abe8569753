"""The inverse-rendering step of `diff/optimize.py`, taken step by step:
the loss on one frame with fresh frame seeds, backward, Adam on the
fields, the loss read back. The target is rendered in set-up from the
scene's own materials; the start is a perturbation drawn from the seed.
The first `check_steps` steps are set-up and are compared. A traced run
profiles `trace_steps` steps a quarter of the way into the window."""

from __future__ import annotations

import math
import time

import torch

from perfbench import check, harness
from perfbench import trace as trace_mod
from perfbench.window import (GIB, Outcome, Program, peak_bytes, reset_peak,
                              run_window, sync)


def _first_grad(opt, p):
    """The first gradient as Adam got it, from its first moment after one
    step (NaN where the optimizer holds no state for p)."""
    st = opt.state.get(p, {})
    if "exp_avg" not in st:
        return torch.full(p.shape, float("nan")).numpy()
    return (st["exp_avg"] / (1.0 - check.ADAM_BETAS[0])).cpu().numpy()


def run(cell, seeds, seconds, device, size, tracing, t_start) -> Outcome:
    from tpu_restir_torch.diff.render import loss_fn, render_with_params
    from tpu_restir_torch.render import camera as cam_mod
    tr = cell.traffic
    prog = Program(cell, seeds, device, size)
    cam = cam_mod.make_camera(prog.cfg.camera, device)
    p0 = check.start_params(cell.config, tr, seeds)
    with torch.no_grad():
        own = {f: getattr(prog.scene.materials, f) for f in tr["fields"]}
        target = render_with_params(own, prog.scene, cam, prog.cfg,
                                    check.target_seeds(seeds))
    params = {k: torch.tensor(v, device=device, requires_grad=True)
              for k, v in p0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=tr["lr"],
                           betas=check.ADAM_BETAS, eps=check.ADAM_EPS)

    def step(i):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, prog.scene, cam, prog.cfg,
                       check.step_seeds(seeds, i), target)
        harness.backward(loss)
        opt.step()
        return float(loss.detach())

    done = tr["check_steps"]
    losses = []
    for i in range(done):
        losses.append(step(i))
        if i == 0:
            first_grad = {k: _first_grad(opt, p) for k, p in params.items()}
    after = {k: p.detach().cpu().clone().numpy() for k, p in params.items()}
    setup_s = time.perf_counter() - t_start
    bad = [0]

    def keep(_i, loss):
        bad[0] += not math.isfinite(loss)

    trace = None
    if tracing is not None:
        def trace(one):
            return trace_mod.capture(one, tr["trace_steps"], *tracing,
                                     lambda: sync(device))

    reset_peak(device)
    win = run_window(lambda i: step(done + i), seconds, device, keep, trace)
    peak = peak_bytes(device)
    e2e = {"step_ms": win.seconds * 1e3 / win.units, "peak_gib": peak / GIB,
           "setup_s": setup_s}
    prog_out = {"losses": losses, "first_grad": first_grad,
                "params": after, "start": p0}

    def numbers():
        ref = check.ref_fwdbwd(cell, seeds, done, device, size)
        return check.fwdbwd_numbers(prog_out, ref)

    return Outcome(win.units, bad[0], e2e, peak, win.traced, numbers, win)
