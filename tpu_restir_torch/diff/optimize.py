"""Inverse rendering: fit material parameters to a target image
(counterpart of `tpu_restir.diff.optimize`). Adam over the parameter
dict; each step renders with fresh frame seeds so the stochastic
gradients decorrelate across steps."""

from __future__ import annotations

from typing import Sequence

import torch

from tpu_restir_torch.diff.params import extract_params
from tpu_restir_torch.diff.render import loss_fn


def optimize_materials(scene, cam, cfg, target, *,
                       fields: Sequence[str] = ("diffuse",),
                       n_steps: int = 100, lr: float = 5e-2,
                       frames_per_step: int = 1, seed0: int = 1000,
                       verbose: bool = False):
    """Returns (optimized params, loss history). torch.optim.Adam with
    betas (0.9, 0.999) and eps 1e-8 computes optax.adam's update:
    lr * m_hat / (sqrt(v_hat) + eps)."""
    params = extract_params(scene, fields)
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    history = []
    for i in range(n_steps):
        seeds = tuple(seed0 + i * frames_per_step + j
                      for j in range(frames_per_step))
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, scene, cam, cfg, seeds, target)
        loss.backward()
        opt.step()
        history.append(float(loss.detach()))
        if verbose and i % 10 == 0:
            print(f"step {i:4d} loss {history[-1]:.6f}")
    return {k: v.detach() for k, v in params.items()}, history
