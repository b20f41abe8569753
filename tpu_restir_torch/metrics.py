"""Image statistics, per-pass timing and the analytic ray count of a
ReSTIR frame."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def image_mean_variance(img):
    """Mean and variance of the per-pixel channel mean (the reference's
    image statistics, pg/simpleguidx11.cpp:308-329)."""
    pix = torch.mean(img, dim=-1)
    mean = torch.mean(pix)
    return mean, torch.mean(pix * pix) - mean * mean


def sync(obj) -> None:
    """Wait for the CUDA devices of the tensors in obj (a tensor, a tuple
    or list, or a dataclass of them): the counterpart of
    jax.block_until_ready."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            sync(x)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            sync(getattr(obj, f.name))


class PassTimers:
    """Wall-clock per-pass timers (reference pg/simpleguidx11.h:120-127),
    filled by the renderer's prefix profiling (`Renderer._timed_step`,
    which syncs the device before each reading)."""

    def __init__(self):
        self.durations: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def record(self, name: str, seconds: float) -> None:
        """Add one measured duration of a pass."""
        self.durations[name] = self.durations.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self) -> Dict[str, float]:
        """Average per-invocation milliseconds per pass."""
        return {k: 1e3 * v / max(self.counts.get(k, 1), 1)
                for k, v in self.durations.items()}


def rays_per_pixel(cfg) -> int:
    """Closest-hit + occlusion queries per pixel per frame for this config
    (the reference's per-pass trace counts, SURVEY.md §3.2); the count of
    the repository's bench.py."""
    r = cfg.restir
    test_vis = 0 if r.do_visibility_pass else 1
    closest = 1 + r.m_brdf                      # G-buffer + BRDF candidates
    occl = (r.m_area + r.m_brdf + 1) * test_vis  # initial p_hats + finalize
    occl += 1 if r.do_visibility_pass else 0
    if r.do_temporal_reuse:
        occl += 5                                # 4 MIS p_hats + finalize
    if r.do_spatial_reuse:
        k = r.spatial_neighbor_count
        if r.spatial_mis == "balance":
            per_pass = (k + 1) ** 2 + 1
        elif r.spatial_mis == "pairwise":
            per_pass = 3 * k + 2
        else:
            per_pass = (k + 1) + 1
        occl += per_pass * r.spatial_pass_count
    occl += 1                                    # final shading visibility
    return closest + occl
