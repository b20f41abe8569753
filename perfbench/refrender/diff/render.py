"""Differentiable rendering: the loss w.r.t. material parameters
(counterpart of `tpu_restir.diff.render`), through the reference's ReSTIR
frame. The estimator uses fixed frame seeds
(common random numbers), so render(params) is a deterministic,
almost-everywhere-differentiable function of the parameters."""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from perfbench.refrender import rng
from perfbench.refrender.diff.params import apply_params
from perfbench.refrender.render.integrators.restir.pipeline import (
    init_restir_state, restir_step)


def _detach(obj):
    """A dataclass tree with every tensor detached."""
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _detach(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def render_with_params(params: Dict[str, torch.Tensor], scene, cam, cfg,
                       seeds: Sequence[int]):
    """Average of the ReSTIR frames rendered with the given frame seeds
    from a fresh state, as a differentiable function of the material
    params; the inter-frame state is carried but detached (the estimator
    differentiates each frame's shading and treats the reuse history as
    data)."""
    scene_p = apply_params(scene, params)
    h, w = cfg.camera.height, cfg.camera.width
    dev = scene.tri_v.device
    state = init_restir_state(h, w, dev)
    acc = torch.zeros((h, w, 3), device=dev)
    for i, s in enumerate(seeds):
        frame, state = restir_step(scene_p, cam, cfg,
                                   rng.make_frame_seed(cfg.seed, s), state,
                                   s)
        state = _detach(state)
        acc = acc + (frame - acc) / (i + 1.0)
    return acc


def loss_fn(params, scene, cam, cfg, seeds, target):
    """mean((img - target)^2)."""
    img = render_with_params(params, scene, cam, cfg, seeds)
    return torch.mean((img - target) ** 2)
