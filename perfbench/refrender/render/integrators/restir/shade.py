"""PASS 6: final shading, pixel = f(best sample) * W with visibility
(counterpart of `tpu_restir.render.integrators.restir.shade`; reference
pg/simpleguidx11.cpp:452-472). Empty reservoirs show the G-buffer
emission (lights, sky); the result is sanitized."""

from __future__ import annotations

import torch

from perfbench.refrender import mathx
from perfbench.refrender.render.integrators.restir.phat import evaluate_f


def shade_pass(scene, gb, res, cfg):
    f_val = evaluate_f(res.sample, scene, gb, True, cfg.params,
                       cfg.intersector)
    pixel = torch.where(res.has_sample()[..., None],
                        f_val * res.w[..., None], gb.emission)
    return mathx.sanitize(pixel)
