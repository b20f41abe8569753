"""Sharded differentiable rendering: all-reduced material gradients
(counterpart of `tpu_restir.dist.diff`).

Pixel rows shard over the row mesh and the material parameters are
replicated. Each rank renders its rows for every seed, and its backward
runs through the halo exchanges, whose backward returns the cotangents
of the border rows to their owners; the parameter gradients and the loss
are then summed over the ranks (`all_reduce`), as JAX's psum gives both.
Frames equal the one-device frames bit for bit, so value and gradients
agree with the one-device estimator up to the order of the sums
(tests/test_torch_dist.py).
"""

from __future__ import annotations

from typing import Sequence

import torch

from tpu_restir_torch import rng
from tpu_restir_torch.diff.params import apply_params
from tpu_restir_torch.diff.render import _detach
from tpu_restir_torch.dist import mesh as mesh_mod
from tpu_restir_torch.dist.sharded import row_slice
from tpu_restir_torch.render.integrators.restir.pipeline import (
    init_restir_state, restir_step)


def make_sharded_value_and_grad(scene, cam, cfg, seeds: Sequence[int],
                                target, mesh):
    """A callable params -> (loss, grads) over the row mesh: the estimator
    of `diff.render.loss_fn` (the mean squared pixel error of the average
    of the `seeds` ReSTIR frames, the temporal state detached between
    frames). target is the full-height image; every rank returns the same
    loss and gradients."""
    h, w = cfg.camera.height, cfg.camera.width
    if h % mesh.size != 0:
        raise ValueError(f"height {h} not divisible by {mesh.size} devices")
    local_h = h // mesh.size
    seeds = tuple(seeds)
    target_rows = target[row_slice(mesh, h)].to(mesh.device)

    def value_and_grad(params):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        scene_p = apply_params(scene, leaves)
        state = init_restir_state(local_h, w, mesh.device)
        acc = torch.zeros((local_h, w, 3), device=mesh.device)
        for i, s in enumerate(seeds):
            frame, state = restir_step(scene_p, cam, cfg,
                                       rng.make_frame_seed(cfg.seed, s),
                                       state, s, mesh=mesh)
            state = _detach(state)
            acc = acc + (frame - acc) / (i + 1.0)
        loss = torch.sum((acc - target_rows) ** 2) / (h * w * 3)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        # one all-reduce for the loss and every gradient
        flat = mesh_mod.all_reduce(mesh, torch.cat(
            [loss.detach().reshape(1)] + [g.reshape(-1) for g in grads]))
        out, at = {}, 1
        for k, g in zip(leaves, grads):
            out[k] = flat[at:at + g.numel()].reshape(g.shape)
            at += g.numel()
        return flat[0], out

    return value_and_grad
