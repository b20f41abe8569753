"""Target function: f and p_hat (counterpart of
`tpu_restir.render.integrators.restir.phat`; reference
ReSTIRIntegrator::evaluateF / evaluatePHat, pg/ReSTIRIntegrator.cpp:180-211).
f = L_i * f_r * G * V for a light sample against a G-buffer surface;
p_hat = |f|. With visibility on, V is one batched occlusion query."""

from __future__ import annotations

import torch

from perfbench.refrender import mathx
from perfbench.refrender.render import brdf, intersect


def evaluate_f(sample, scene, gb, test_visibility, params, intersector):
    """f(sample; surface) with optional visibility. Invalid samples and
    emissive surfaces evaluate to 0 (lights are displayed directly)."""
    ok = sample.valid & ~gb.is_emissive()
    seg = sample.point - gb.pos
    r_sqr = mathx.dot(seg, seg)
    wi = mathx.normalize(seg)
    cos_i = mathx.maximum(mathx.dot(wi, gb.normal), 0.0)
    cos_y = torch.abs(mathx.dot(-wi, sample.normal))
    g = torch.where(r_sqr > 0.0,
                    cos_i * cos_y / mathx.maximum(r_sqr, 1e-20), 0.0)
    f = sample.l_i * brdf.gbuf_eval_brdf(gb, wi) * g[..., None]
    if test_visibility:
        # pixels whose f is already 0 get a zero-length segment, which
        # test_occlusion turns into a dead ray (tfar < tnear)
        to_p = torch.where(ok[..., None], sample.point, gb.pos)
        ok = ok & ~intersect.test_occlusion(scene, gb.pos, to_p, params,
                                            intersector)
    return torch.where(ok[..., None], f, 0.0)


def evaluate_p_hat(sample, scene, gb, test_visibility, params, intersector):
    """p_hat = |f| (pg/ReSTIRIntegrator.cpp:180-183)."""
    return mathx.length(evaluate_f(sample, scene, gb, test_visibility,
                                   params, intersector))
