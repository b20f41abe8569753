"""PASS 2: initial RIS candidate generation (counterpart of
`tpu_restir.render.integrators.restir.initial`; reference initialRenderPass
+ areaSampleLight + brdfSampleLight, pg/ReSTIRIntegrator.cpp:89-177,
236-298).

M_Area light-CDF candidates and M_Brdf BSDF-sampled candidates stream into
a per-pixel reservoir with the weight
  w = misWeight * p_hat * W_candidate        (both families in use)
  w = (1/M_family) * p_hat * W_candidate     (single family)
where misWeight is the area/brdf balance heuristic in area measure
(pg/ReSTIRIntegrator.h:62-74). All randomness is PCG4D keyed by
(frame seed, stream, global pixel).
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_restir_torch import mathx, rng
from tpu_restir_torch.kernels import ray_tri
from tpu_restir_torch.render import brdf, intersect
from tpu_restir_torch.render.integrators.restir import reservoir as rsv
from tpu_restir_torch.render.integrators.restir.phat import evaluate_p_hat
from tpu_restir_torch.scene import lights as lights_mod
from tpu_restir_torch.scene.materials import gather_materials


def _mis_m_area(pdf_area, pdf_brdf, m_area, m_brdf):
    """m_area = p_A / (M_A p_A + M_B p_B), 0 when both pdfs vanish
    (pg/ReSTIRIntegrator.h:62-67)."""
    denom = m_area * pdf_area + m_brdf * pdf_brdf
    return torch.where(denom > 0.0,
                       pdf_area / torch.clamp(denom, min=1e-30), 0.0)


def _mis_m_brdf(pdf_brdf, pdf_area, m_area, m_brdf):
    denom = m_area * pdf_area + m_brdf * pdf_brdf
    return torch.where(denom > 0.0,
                       pdf_brdf / torch.clamp(denom, min=1e-30), 0.0)


def _area_candidate(u3, scene, gb, cfg):
    """One area-sampled candidate per pixel (areaSampleLight,
    pg/ReSTIRIntegrator.cpp:89-124) -> (LightSample, W, misWeight)."""
    r = cfg.restir
    ls = lights_mod.light_point_from_uniforms(u3, scene)
    pdf_area = ls["pdf_area"]
    seg = ls["point"] - gb.pos
    r_sqr = mathx.dot(seg, seg)
    wi = mathx.normalize(seg)
    cos_y = torch.clamp(mathx.dot(-wi, ls["normal"]), min=0.0)
    area_factor = torch.where(r_sqr > 0.0,
                              cos_y / torch.clamp(r_sqr, min=1e-20), 0.0)
    pdf_if_brdf_area = brdf.gbuf_eval_pdf(gb, wi) * area_factor
    cand = rsv.LightSample(point=ls["point"], normal=ls["normal"],
                           l_i=ls["l_i"],
                           valid=torch.any(ls["l_i"] > 0.0, dim=-1))
    w_c = 1.0 / torch.clamp(pdf_area, min=1e-30)
    mis = _mis_m_area(pdf_area, pdf_if_brdf_area, r.m_area, r.m_brdf)
    return cand, w_c, mis


def _closest_emissive_visible(scene, o, d, tnear, cfg):
    """Closest hit restricted to the emissive triangles (kernel K1 on the
    emissive subset), then one occlusion segment against the whole scene
    bounded at t_e - tfar_offset (the reference's shadow-segment epsilon
    policy, pg/Intersection.h:42-60). brdfSampleLight keeps only emissive
    hits, so this equals a full closest hit followed by the emissive test."""
    p = cfg.params
    idx = scene.lights.tri_idx.long()
    sub = dataclasses.replace(scene, tri_v=scene.tri_v[idx],
                              woop=scene.woop[idx])
    shape = o.shape[:-1]
    n = o[..., 0].numel()
    bt, bu, bv, btri = ray_tri.closest_hit(
        sub, o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
        torch.full((n,), tnear, dtype=torch.float32, device=o.device),
        torch.full((n,), torch.inf, dtype=torch.float32, device=o.device))
    bt, bu, bv, btri = (x.reshape(shape) for x in (bt, bu, bv, btri))
    hit_e = btri >= 0
    bt = torch.where(hit_e, bt, torch.inf)
    # global triangle ids for the subset winners
    gtri = scene.lights.tri_idx[torch.clamp(btri, min=0).long()]
    # anything closer? a dead segment where no emissive was hit
    tf_occ = torch.where(hit_e, bt - p.tfar_offset, tnear - 1.0)
    occ = intersect.intersect_any(scene, o, d, tnear, tf_occ,
                                  cfg.intersector)
    ok = hit_e & ~occ
    return intersect.Hit(t=torch.where(ok, bt, 0.0), u=bu, v=bv,
                         tri=torch.where(ok, gtri, -1), hit=ok)


def _brdf_candidate(u5, scene, gb, cfg):
    """One BSDF-sampled candidate per pixel (brdfSampleLight,
    pg/ReSTIRIntegrator.cpp:126-177): sample the G-buffer BRDF, trace, and
    keep only emissive hits."""
    p = cfg.params
    r = cfg.restir
    s = brdf.gbuf_sample_brdf_u(u5, gb)
    o2 = gb.pos + p.normal_offset * gb.normal
    # the JAX pass takes a full closest hit above 4096 lights; the port's
    # scenes hold at most 64 triangles (build_scene), so never here
    hit = _closest_emissive_visible(scene, o2, s.omega_i, p.tnear_offset,
                                    cfg)
    hi = intersect.hit_attributes(scene, o2, s.omega_i, hit)
    m2 = gather_materials(scene.materials, hi.mat_id)
    emissive = hi.did_hit & m2.is_emissive()

    seg = hi.point - gb.pos
    r_sqr = mathx.dot(seg, seg)
    wi = mathx.normalize(seg)
    cos_y = torch.clamp(mathx.dot(-wi, hi.normal), min=0.0)
    area_factor = torch.where(r_sqr > 0.0,
                              cos_y / torch.clamp(r_sqr, min=1e-20), 0.0)
    pdf_brdf_area = s.pdf * area_factor
    pdf_area = lights_mod.pdf_for_any_light_point(scene, gb.depth.shape)

    e3 = emissive[..., None]
    cand = rsv.LightSample(point=torch.where(e3, hi.point, 0.0),
                           normal=torch.where(e3, hi.normal, 0.0),
                           l_i=torch.where(e3, m2.emission, 0.0),
                           valid=emissive)
    w_c = torch.where(emissive & (pdf_brdf_area > 0.0),
                      1.0 / torch.clamp(pdf_brdf_area, min=1e-30), 0.0)
    mis = torch.where(emissive,
                      _mis_m_brdf(pdf_brdf_area, pdf_area, r.m_area,
                                  r.m_brdf), 0.0)
    return cand, w_c, mis


def initial_pass(frame_seed, scene, gb, cfg, ys, xs) -> rsv.Reservoir:
    r = cfg.restir
    p = cfg.params
    shape = gb.depth.shape
    dev = gb.depth.device
    res = rsv.empty_reservoir(shape, dev)
    if not scene.lights.is_valid:
        return res

    test_vis = not r.do_visibility_pass
    one = torch.ones(shape, device=dev)

    def u(pass_id, draw, n, slot=0):
        return rng.pixel_uniforms(frame_seed,
                                  rng.stream_id(pass_id, draw, slot),
                                  ys, xs, n)

    for i in range(r.m_area):
        cand, w_c, mis = _area_candidate(u(rng.PASS_INITIAL_AREA, i, 3),
                                         scene, gb, cfg)
        p_hat = evaluate_p_hat(cand, scene, gb, test_vis, p, cfg.intersector)
        weight_term = mis if r.m_brdf > 0 else 1.0 / r.m_area
        res, _ = rsv.add_sample_u(
            res, u(rng.PASS_INITIAL_WRS, i, 1)[..., 0], cand,
            weight_term * p_hat * w_c, one)

    for i in range(r.m_brdf):
        u5 = torch.cat([u(rng.PASS_INITIAL_BRDF, i, 4, 0),
                        u(rng.PASS_INITIAL_BRDF, i, 1, 1)], dim=-1)
        cand, w_c, mis = _brdf_candidate(u5, scene, gb, cfg)
        p_hat = evaluate_p_hat(cand, scene, gb, test_vis, p, cfg.intersector)
        weight_term = mis if r.m_area > 0 else 1.0 / r.m_brdf
        res, _ = rsv.add_sample_u(
            res, u(rng.PASS_INITIAL_WRS, 1000 + i, 1)[..., 0], cand,
            weight_term * p_hat * w_c, one)

    # unbiased contribution weight W = w_sum / p_hat(best)
    # (pg/ReSTIRIntegrator.cpp:289-293)
    p_hat_best = evaluate_p_hat(res.sample, scene, gb, test_vis, p,
                                cfg.intersector)
    res = dataclasses.replace(res, w=torch.where(
        p_hat_best > 0.0, res.w_sum / torch.clamp(p_hat_best, min=1e-30),
        0.0))
    res = rsv.cap_confidence(res, r.confidence_cap)
    # emissive pixels get an empty reservoir (pg/ReSTIRIntegrator.cpp:241-244)
    return rsv.select(gb.is_emissive(), rsv.empty_reservoir(shape, dev), res)


def visibility_pass(scene, gb, res: rsv.Reservoir, cfg) -> rsv.Reservoir:
    """PASS 3 (optional): shadow-test the surviving sample; occluded ->
    W = 0 (pg/ReSTIRIntegrator.cpp:302-312)."""
    occ = intersect.test_occlusion(scene, gb.pos, res.sample.point,
                                   cfg.params, cfg.intersector)
    return dataclasses.replace(res, w=torch.where(occ, 0.0, res.w))
