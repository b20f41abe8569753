"""Direct-lighting strategies of the NEE path tracer (counterpart of
`tpu_restir.render.integrators.direct`): DirectAreaIntegrator,
DirectBRDFIntegrator and DirectMISIntegrator of the reference
(pg/DirectAreaIntegrator.cpp:9-53, pg/DirectBRDFIntegrator.cpp:7-49,
pg/DirectMISIntegrator.cpp:10-144), and the JAX package's per-pixel RIS
strategy.

Every function takes the flat hit wavefront: positions and normals of the
shading points, their per-ray material columns `m` and incident
directions `d`, and returns the direct radiance (..., 3).
"""

from __future__ import annotations

import torch

from perfbench.refrender import mathx, rng
from perfbench.refrender.config import DirectStrategy
from perfbench.refrender.render import brdf, intersect
from perfbench.refrender.scene import lights as lights_mod
from perfbench.refrender.scene.materials import gather_materials


def _light_sample_geometry(point, l_point, l_normal):
    """Direction, squared distance and the light-side cosine toward a
    point on a light."""
    seg = l_point - point
    r_sqr = mathx.dot(seg, seg)
    wi = mathx.normalize(seg)
    cos_y = mathx.maximum(mathx.dot(-wi, l_normal), 0.0)
    return wi, r_sqr, cos_y


def direct_area(key, scene, p, cfg, point, normal, m, d):
    """One area-CDF light sample with the geometry term and a shadow ray
    (pg/DirectAreaIntegrator.cpp:9-53)."""
    if not scene.lights.is_valid:
        return torch.zeros_like(point)
    ls = lights_mod.sample_light_point(key, scene, point.shape[:-1])
    wi, r_sqr, cos_y = _light_sample_geometry(point, ls["point"],
                                              ls["normal"])
    cos_i = mathx.maximum(mathx.dot(wi, normal), 0.0)
    facing = (cos_i > 0.0) & (cos_y > 0.0) & (r_sqr > 0.0)
    occ = intersect.test_occlusion(scene, point, ls["point"], p,
                                   cfg.intersector)
    g = torch.where(r_sqr > 0.0,
                    cos_i * cos_y / mathx.maximum(r_sqr, 1e-20), 0.0)
    f_r = brdf.eval_bsdf(m, normal, d, wi)
    contrib = ls["l_i"] * f_r \
        * (g / mathx.maximum(ls["pdf_area"], 1e-20))[..., None]
    return torch.where((facing & ~occ)[..., None], contrib, 0.0)


def _trace_brdf_sample(key, scene, p, cfg, point, normal, m, d,
                       from_inside, dst):
    """Sample the BSDF and trace toward it -> (sample, hit info at the
    bounce, its material columns)."""
    s = brdf.sample_bsdf(key, m, normal, d, from_inside, dst)
    o2 = point + p.normal_offset * normal
    hit = intersect.intersect_closest(scene, o2, s.omega_i, p.tnear_offset,
                                      float("inf"), cfg.intersector)
    hi = intersect.hit_attributes(scene, o2, s.omega_i, hit)
    return s, hi, gather_materials(scene.materials, hi.mat_id)


def direct_brdf(key, scene, p, cfg, point, normal, m, d, from_inside, dst):
    """One BSDF sample, counted where it hits an emitter
    (pg/DirectBRDFIntegrator.cpp:7-49)."""
    s, hi, m2 = _trace_brdf_sample(key, scene, p, cfg, point, normal, m, d,
                                   from_inside, dst)
    wi, r_sqr, cos_y = _light_sample_geometry(point, hi.point, hi.normal)
    cos_i = mathx.maximum(mathx.dot(wi, normal), 0.0)
    ok = hi.did_hit & m2.is_emissive() & (r_sqr > 0.0) \
        & (cos_i > 0.0) & (cos_y > 0.0)
    area_factor = torch.where(r_sqr > 0.0,
                              cos_y / mathx.maximum(r_sqr, 1e-20), 0.0)
    denom = s.pdf * area_factor
    g = cos_i * cos_y / mathx.maximum(r_sqr, 1e-20)
    contrib = m2.emission * s.f_r * torch.where(
        denom > 0.0, g / mathx.maximum(denom, 1e-30), 0.0)[..., None]
    return torch.where(ok[..., None], contrib, 0.0)


def direct_mis(key, scene, p, cfg, point, normal, m, d, from_inside, dst):
    """Both strategies, weighted by the power heuristic
    (pg/DirectMISIntegrator.cpp:38-144). With cfg.show_weights the weights
    render as colours instead of radiance: the BRDF side's in R, the light
    side's in G (pg/DirectMISIntegrator.cpp:80-81, 134-135)."""
    k_l, k_b = rng.split(key)
    shape = point.shape[:-1]
    zeros = torch.zeros(shape, device=point.device)
    show = cfg.show_weights

    # the BRDF side (evaluateBRDFSample)
    s, hi, m2 = _trace_brdf_sample(k_b, scene, p, cfg, point, normal, m, d,
                                   from_inside, dst)
    wi_b, r2_b, cosy_b = _light_sample_geometry(point, hi.point, hi.normal)
    cosi_b = mathx.maximum(mathx.dot(wi_b, normal), 0.0)
    ok_b = hi.did_hit & m2.is_emissive() & (r2_b > 0.0)
    area_factor = torch.where(r2_b > 0.0,
                              cosy_b / mathx.maximum(r2_b, 1e-20), 0.0)
    pdf_as_light = lights_mod.pdf_for_any_light_point(scene, shape) \
        if scene.lights.is_valid else zeros
    w_b = mathx.power_heuristic(s.pdf * area_factor, pdf_as_light)
    if show:
        contrib_b = torch.stack([w_b, zeros, zeros], dim=-1)
    else:
        contrib_b = m2.emission * s.f_r * torch.where(
            s.pdf > 0.0, w_b * cosi_b / mathx.maximum(s.pdf, 1e-30),
            0.0)[..., None]
    out = torch.where(ok_b[..., None], contrib_b, 0.0)

    # the light side (evaluateLightSample)
    if scene.lights.is_valid:
        ls = lights_mod.sample_light_point(k_l, scene, shape)
        wi_l, r2_l, cosy_l = _light_sample_geometry(point, ls["point"],
                                                    ls["normal"])
        cosi_l = mathx.maximum(mathx.dot(wi_l, normal), 0.0)
        facing = (cosi_l > 0.0) & (cosy_l > 0.0) & (r2_l > 0.0)
        occ = intersect.test_occlusion(scene, point, ls["point"], p,
                                       cfg.intersector)
        pdf_if_brdf_area = brdf.pdf_bsdf(m, normal, d, wi_l) * torch.where(
            r2_l > 0.0, cosy_l / mathx.maximum(r2_l, 1e-20), 0.0)
        w_l = mathx.power_heuristic(ls["pdf_area"], pdf_if_brdf_area)
        g = cosi_l * cosy_l / mathx.maximum(r2_l, 1e-20)
        if show:
            contrib_l = torch.stack([zeros, w_l, zeros], dim=-1)
        else:
            contrib_l = ls["l_i"] * brdf.eval_bsdf(m, normal, d, wi_l) * (
                w_l * g / mathx.maximum(ls["pdf_area"], 1e-20))[..., None]
        out = out + torch.where((facing & ~occ & (w_l > 0.0))[..., None],
                                contrib_l, 0.0)
    return out


def direct_ris(key, scene, p, cfg, point, normal, m, d, n_candidates=8):
    """Per-pixel RIS over area-sampled candidates with the target
    p_hat = |L_i f_r G|: one candidate picked by weighted reservoir
    sampling, shaded with the contribution weight W = w_sum / p_hat of the
    pick, behind one shadow ray."""
    if not scene.lights.is_valid:
        return torch.zeros_like(point)
    shape = point.shape[:-1]
    dev = point.device
    w_sum = torch.zeros(shape, device=dev)
    best_f = torch.zeros(shape + (3,), device=dev)
    best_phat = torch.zeros(shape, device=dev)
    best_pt = torch.zeros(shape + (3,), device=dev)

    for i in range(n_candidates):
        ki = rng.draw_key(key, i)
        ls = lights_mod.sample_light_point(ki, scene, shape)
        wi, r_sqr, cos_y = _light_sample_geometry(point, ls["point"],
                                                  ls["normal"])
        cos_i = mathx.maximum(mathx.dot(wi, normal), 0.0)
        g = torch.where(r_sqr > 0.0,
                        cos_i * cos_y / mathx.maximum(r_sqr, 1e-20), 0.0)
        f = ls["l_i"] * brdf.eval_bsdf(m, normal, d, wi) * g[..., None]
        phat = mathx.length(f)
        w = phat / (mathx.maximum(ls["pdf_area"], 1e-20) * n_candidates)
        w_sum = w_sum + w
        u = rng.uniform(rng.draw_key(ki, 1000), shape, dev)
        take = (w_sum > 0.0) & (u < w / mathx.maximum(w_sum, 1e-30))
        best_f = torch.where(take[..., None], f, best_f)
        best_phat = torch.where(take, phat, best_phat)
        best_pt = torch.where(take[..., None], ls["point"], best_pt)

    occ = intersect.test_occlusion(scene, point, best_pt, p, cfg.intersector)
    w_ucw = torch.where(best_phat > 0.0,
                        w_sum / mathx.maximum(best_phat, 1e-30), 0.0)
    return torch.where((~occ & (best_phat > 0.0))[..., None],
                       best_f * w_ucw[..., None], 0.0)


def calculate_direct(strategy, key, scene, p, cfg, point, normal, m, d,
                     from_inside, dst):
    if strategy == DirectStrategy.AREA:
        return direct_area(key, scene, p, cfg, point, normal, m, d)
    if strategy == DirectStrategy.BRDF:
        return direct_brdf(key, scene, p, cfg, point, normal, m, d,
                           from_inside, dst)
    if strategy == DirectStrategy.MIS:
        return direct_mis(key, scene, p, cfg, point, normal, m, d,
                          from_inside, dst)
    if strategy == DirectStrategy.RIS:
        return direct_ris(key, scene, p, cfg, point, normal, m, d,
                          cfg.ris_candidates)
    raise ValueError(f"unknown direct strategy {strategy!r}")
