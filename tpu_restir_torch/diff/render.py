"""Differentiable rendering: loss and gradients w.r.t. material parameters
(counterpart of `tpu_restir.diff.render`), through the ReSTIR frame or
the naive and NEE path tracers. The estimator uses fixed frame seeds
(common random numbers), so render(params) is a deterministic,
almost-everywhere-differentiable function of the parameters."""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from tpu_restir_torch import rng
from tpu_restir_torch.diff.params import apply_params
from tpu_restir_torch.render.integrators import render_naive, render_nee
from tpu_restir_torch.render.integrators.restir.pipeline import (
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
    """Average of the frames rendered with the given frame seeds, as a
    differentiable function of the material params. cfg.integrator picks
    the pipeline: the naive or NEE path tracer (frame keys of cfg.seed and
    each seed), or ReSTIR from a fresh state, its inter-frame state carried
    but detached (the estimator differentiates each frame's shading and
    treats the reuse history as data)."""
    scene_p = apply_params(scene, params)
    h, w = cfg.camera.height, cfg.camera.width
    dev = scene.tri_v.device
    if cfg.integrator in ("naive", "nee"):
        fn = render_naive if cfg.integrator == "naive" else render_nee
        acc = torch.zeros((h, w, 3), device=dev)
        for i, s in enumerate(seeds):
            frame = fn(scene_p, cam, cfg, rng.frame_key(cfg.seed, s))
            acc = acc + (frame - acc) / (i + 1.0)
        return acc
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


def make_value_and_grad(scene, cam, cfg, seeds, target):
    """A callable params -> (loss, grads): the loss (detached) and a dict
    of its gradients w.r.t. every leaf of params, by torch.autograd.grad.
    The leaves are taken as they are, detached from any graph."""
    seeds = tuple(seeds)

    def value_and_grad(params):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = loss_fn(leaves, scene, cam, cfg, seeds, target)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    return value_and_grad
