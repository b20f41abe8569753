"""Weighted reservoir sampling state as image-shaped tensors (counterpart
of `tpu_restir.render.integrators.restir.reservoir`; reference
pg/Reservoir.h:6-59). addSample's branch becomes a masked select."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LightSample:
    point: torch.Tensor   # (..., 3)
    normal: torch.Tensor  # (..., 3)
    l_i: torch.Tensor     # (..., 3)
    valid: torch.Tensor   # (...,) bool


@dataclasses.dataclass
class Reservoir:
    sample: LightSample
    w_sum: torch.Tensor       # (...,)
    w: torch.Tensor           # (...,) unbiased contribution weight W
    confidence: torch.Tensor  # (...,)

    def has_sample(self):
        """w_sum > 0 (reference Reservoir::hasSample)."""
        return self.w_sum > 0.0


def empty_light_sample(shape, device) -> LightSample:
    def z3():
        return torch.zeros(shape + (3,), device=device)

    return LightSample(point=z3(), normal=z3(), l_i=z3(),
                       valid=torch.zeros(shape, dtype=torch.bool,
                                         device=device))


def empty_reservoir(shape, device) -> Reservoir:
    shape = tuple(shape)
    return Reservoir(sample=empty_light_sample(shape, device),
                     w_sum=torch.zeros(shape, device=device),
                     w=torch.zeros(shape, device=device),
                     confidence=torch.zeros(shape, device=device))


def add_sample_u(res: Reservoir, u, cand: LightSample, w, conf_inc):
    """Streaming WRS update (reference Reservoir::addSample,
    pg/Reservoir.h:33-47): accumulate w_sum and confidence, replace the
    kept sample w.p. w / w_sum'. u is the acceptance uniform per pixel.
    Returns (reservoir, accepted mask)."""
    w_sum = res.w_sum + w
    conf = res.confidence + conf_inc
    accept = (w_sum > 0.0) & (u < w / torch.clamp(w_sum, min=1e-30))
    a3 = accept[..., None]
    sample = LightSample(
        point=torch.where(a3, cand.point, res.sample.point),
        normal=torch.where(a3, cand.normal, res.sample.normal),
        l_i=torch.where(a3, cand.l_i, res.sample.l_i),
        valid=torch.where(accept, cand.valid, res.sample.valid))
    return Reservoir(sample=sample, w_sum=w_sum, w=res.w,
                     confidence=conf), accept


def cap_confidence(res: Reservoir, cap: float) -> Reservoir:
    """reference Reservoir::capConfidence."""
    return dataclasses.replace(res,
                               confidence=torch.clamp(res.confidence,
                                                      max=cap))


def select(mask, a: Reservoir, b: Reservoir) -> Reservoir:
    """Per-pixel reservoir select: mask ? a : b."""
    m3 = mask[..., None]
    return Reservoir(
        sample=LightSample(
            point=torch.where(m3, a.sample.point, b.sample.point),
            normal=torch.where(m3, a.sample.normal, b.sample.normal),
            l_i=torch.where(m3, a.sample.l_i, b.sample.l_i),
            valid=torch.where(mask, a.sample.valid, b.sample.valid)),
        w_sum=torch.where(mask, a.w_sum, b.w_sum),
        w=torch.where(mask, a.w, b.w),
        confidence=torch.where(mask, a.confidence, b.confidence))
