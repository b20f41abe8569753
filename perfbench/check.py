"""What decides `correct`: the plain reference (`perfbench/refrender`, a
frozen copy of the port's plain code with an intersection of its own)
run on the inputs the program was handed, the numbers that compare the
two, and the control (the reference with every buffer that leaves a pass
or a hit query stored in bfloat16).

The reference imports nothing of the program: it builds its own scene
(triangles in the order given, its own clusters) from the scene
generator's raw arrays, works the reservoirs' temporal chain out again
from the first frame, and takes its own steps of Adam.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from perfbench import harness

# a pixel is off where a channel differs by more than ATOL + RTOL |ref|
PIXEL_ATOL = 1e-3
PIXEL_RTOL = 1e-3
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def pixels_off(prog, ref) -> float:
    """Share of pixels (H, W, 3) with a channel off, or not finite."""
    prog = torch.as_tensor(prog, dtype=torch.float32).cpu()
    ref = torch.as_tensor(ref, dtype=torch.float32).cpu()
    off = ~(torch.abs(prog - ref) <= PIXEL_ATOL + PIXEL_RTOL * ref.abs())
    return float(off.any(-1).float().mean())


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b| (inf where b is 0 and a is not)."""
    a, b = float(a), float(b)
    if not np.isfinite(a):
        return float("inf")
    if b == 0.0:
        return 0.0 if a == 0.0 else float("inf")
    return abs(a - b) / abs(b)


# --- the reference ----------------------------------------------------------

def ref_scene(config: dict, device):
    from perfbench.refrender.scene.materials import MaterialSpec
    from perfbench.refrender.scene.scene import build_ref_scene
    v, m, specs = harness.scene_arrays(config)
    return build_ref_scene(v, m, [MaterialSpec(**d) for d in specs], device)


def ref_config(cell, seed: int, size=None):
    from perfbench.refrender import config as cfg_mod
    return harness.render_config(cfg_mod, cell.config, cell.traffic, seed,
                                 size)


def _bf16(obj):
    """obj with every float32 tensor in it rounded to bfloat16 and back."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.float32:
            return obj.to(torch.bfloat16).to(torch.float32)
        return obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _bf16(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_bf16(x) for x in obj)
    return obj


@contextlib.contextmanager
def control():
    """The control: within it, the reference stores the output of every
    ReSTIR pass, every hit record and every path-traced frame in
    bfloat16, the nearest precision below the configuration's float32."""
    from perfbench.refrender.render import integrators, intersect
    from perfbench.refrender.render.integrators.restir import (gbuffer,
                                                                pipeline)
    targets = [(gbuffer, "gbuffer_fill")] + [
        (pipeline, n) for n in ("initial_pass", "temporal_pass",
                                "spatial_pass", "shade_pass")] + [
        (intersect, "hit_attributes"), (integrators, "render_nee")]
    saved = [(m, n, getattr(m, n)) for m, n in targets]

    def rounded(fn):
        return lambda *a, **k: _bf16(fn(*a, **k))

    try:
        for m, n, fn in saved:
            setattr(m, n, rounded(fn))
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def ref_restir_frames(cell, seeds, n_frames: int, device, size=None):
    """The reference's first n_frames ReSTIR frames from a fresh state
    (the frame seeds and counters of `Renderer.step`), each on the host."""
    from perfbench.refrender import rng
    from perfbench.refrender.render import camera as cam_mod
    from perfbench.refrender.render.integrators.restir import pipeline
    cfg = ref_config(cell, seeds.render, size)
    scene = ref_scene(cell.config, device)
    cam = cam_mod.make_camera(cfg.camera, device)
    state = pipeline.init_restir_state(cfg.camera.height, cfg.camera.width,
                                       device)
    frames = []
    with torch.no_grad():
        for f in range(n_frames):
            frame, state = pipeline.restir_step(
                scene, cam, cfg, rng.make_frame_seed(cfg.seed, f), state, f)
            frames.append(frame.cpu())
    return frames


def ref_path_frame(cell, seeds, index: int, device, size=None):
    """The reference's NEE frame of frame counter `index`."""
    from perfbench.refrender import rng
    from perfbench.refrender.render import camera as cam_mod
    from perfbench.refrender.render import integrators
    cfg = ref_config(cell, seeds.render, size)
    scene = ref_scene(cell.config, device)
    cam = cam_mod.make_camera(cfg.camera, device)
    with torch.no_grad():
        return integrators.render_nee(scene, cam, cfg,
                                      rng.frame_key(cfg.seed, index)).cpu()


def start_params(config: dict, traffic: dict, seeds) -> dict:
    """The starting parameters of the gradient steps: each field of the
    scene's materials times (1 + perturb * N(0, 1)), drawn from the seed
    on the host, clipped to [0, 1]."""
    _v, _m, specs = harness.scene_arrays(config)
    gen = np.random.default_rng(seeds.params)
    out = {}
    for field in traffic["fields"]:
        base = np.array([d.get(field, (0.5, 0.5, 0.5)) for d in specs],
                        np.float64)
        noise = gen.standard_normal(base.shape)
        out[field] = np.clip(base * (1.0 + traffic["perturb"] * noise),
                             0.0, 1.0).astype(np.float32)
    return out


def step_seeds(seeds, step: int):
    """The frame seed of gradient step `step` (one fresh frame a step)."""
    return (seeds.step0 + step,)


def target_seeds(seeds):
    """The target's frame seed, apart from every step's."""
    return (seeds.step0 + (1 << 30),)


def ref_fwdbwd(cell, seeds, n_steps: int, device, size=None):
    """The reference's first n_steps gradient steps -> dict of each step's
    loss, the first gradient and the parameters after the steps (numpy)."""
    from perfbench.refrender.diff.render import loss_fn, render_with_params
    from perfbench.refrender.render import camera as cam_mod
    tr = cell.traffic
    cfg = ref_config(cell, seeds.render, size)
    scene = ref_scene(cell.config, device)
    cam = cam_mod.make_camera(cfg.camera, device)
    p0 = start_params(cell.config, tr, seeds)
    with torch.no_grad():
        own = {f: getattr(scene.materials, f) for f in tr["fields"]}
        target = render_with_params(own, scene, cam, cfg,
                                    target_seeds(seeds))
    params = {k: torch.tensor(v, device=device) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2 = ADAM_BETAS
    losses, first_grad = [], None
    for i in range(n_steps):
        leaves = {k: v.clone().requires_grad_(True) for k, v in
                  params.items()}
        loss = loss_fn(leaves, scene, cam, cfg, step_seeds(seeds, i),
                       target)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        if i == 0:
            first_grad = {k: g.cpu().numpy() for k, g in zip(params, grads)}
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                mh = m[k] / (1 - b1 ** (i + 1))
                vh = v2[k] / (1 - b2 ** (i + 1))
                params[k] = p - tr["lr"] * mh / (torch.sqrt(vh) + ADAM_EPS)
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: v.cpu().numpy() for k, v in params.items()},
            "start": p0}


# --- the numbers compared ---------------------------------------------------

def norm_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap of norms: | |prog| - |ref| | over the larger of
    |ref| and the median leaf's |ref|."""
    refn = {k: float(np.linalg.norm(v)) for k, v in ref.items()}
    med = float(np.median(list(refn.values())))
    worst = 0.0
    for k, r in refn.items():
        p = float(np.linalg.norm(prog[k]))
        if not np.isfinite(p):
            return float("inf")
        worst = max(worst, abs(p - r) / max(r, med, 1e-30))
    return worst


def fwdbwd_numbers(prog: dict, ref: dict) -> dict:
    """The three numbers of a gradient cell: each step's loss (the worst
    relative gap), the first gradient's norm, and the norm of the
    parameters' change after the steps."""
    loss_gap = max(rel_gap(a, b) for a, b in zip(prog["losses"],
                                                 ref["losses"]))
    grad_gap = norm_gap(prog["first_grad"], ref["first_grad"])
    change_gap = norm_gap(
        {k: prog["params"][k] - prog["start"][k] for k in prog["params"]},
        {k: ref["params"][k] - ref["start"][k] for k in ref["params"]})
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
