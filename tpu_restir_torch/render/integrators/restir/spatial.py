"""PASS 5: spatial reuse with the five MIS/debiasing schemes (counterpart
of `tpu_restir.render.integrators.restir.spatial`; reference
spatialReusePass, pg/ReSTIRIntegrator.cpp:316-542). Per pixel: up to K
disk neighbours (the centre is always candidate 0), emissive and
optionally dissimilar neighbours rejected, then all candidates resampled
with a scheme-dependent MIS weight:
  CONSTANT                - 1/M (biased)
  CONSTANT_DEBIAS_Z       - 1/M, then W times M/|Z|
  CONSTANT_DEBIAS_CONTRIB - 1/M, then W times M * contribution weight
  BALANCE_HEURISTIC       - generalized balance heuristic, O(M^2) p_hat
  PAIRWISE                - pairwise MIS against the canonical sample, O(M)
Every p_hat with visibility is one batched occlusion query; all neighbour
taps come from one gather of the packed payload (kernel K3).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_restir_torch.config import SpatialMis
from tpu_restir_torch import mathx, rng
from tpu_restir_torch.kernels import local_gather as lg
from tpu_restir_torch.render import intersect
from tpu_restir_torch.render.integrators.restir import packed as pk
from tpu_restir_torch.render.integrators.restir import reservoir as rsv
from tpu_restir_torch.render.integrators.restir.phat import evaluate_p_hat
from tpu_restir_torch.render.sampling import disk_int_from_uniform


def _safe_div(num, denom):
    return torch.where(denom > 0.0, num / torch.clamp(denom, min=1e-30),
                       0.0)


def spatial_pass(frame_seed, pass_idx: int, scene, gb, res_in, cfg, ys,
                 xs) -> rsv.Reservoir:
    p = cfg.params
    r = cfg.restir
    h, w = cfg.camera.height, cfg.camera.width
    shape = gb.depth.shape
    dev = gb.depth.device
    n_cand = r.spatial_neighbor_count + 1  # index 0 = centre

    def uni(draw, n, slot):
        return rng.pixel_uniforms(
            frame_seed,
            rng.stream_id(rng.PASS_SPATIAL, pass_idx * 64 + draw, slot),
            ys, xs, n)

    # neighbour coords: integer disk offsets distributed as the
    # reference's trunc(float disk sample) (pg/ReSTIRIntegrator.cpp:334-341)
    tap_ys, tap_xs = [], []
    for k in range(r.spatial_neighbor_count):
        offi = disk_int_from_uniform(uni(k, 2, 2)[..., 0],
                                     r.spatial_reuse_radius)
        tap_xs.append(torch.clamp(xs + offi[..., 0], 0, w - 1))
        tap_ys.append(torch.clamp(ys + offi[..., 1], 0, h - 1))

    slim = pk.reuse_slim(scene.materials)
    gbs, ress = [gb], [res_in]
    if tap_ys:
        payload = pk.pack_reuse(gb, res_in, slim)       # (h, w, 32|24)
        # offsets are truncated disk samples of radius sqrt(radius_cfg)
        r_bound = int(math.floor(math.sqrt(max(r.spatial_reuse_radius,
                                                0.0))))
        taps = lg.gather_local(payload, torch.stack(tap_ys),
                               torch.stack(tap_xs), r_bound, top=0,
                               disk_r2=int(max(r.spatial_reuse_radius, 0.0)))
        gbc = pk.gb_ch(slim)
        gbs += [pk.unpack_gb(taps[i, ..., :gbc], gb, slim)
                for i in range(n_cand - 1)]
        ress += [pk.unpack_res(taps[i, ..., gbc:], slim)
                 for i in range(n_cand - 1)]

    # candidate validity (pg/ReSTIRIntegrator.cpp:344-374)
    valid = [torch.ones(shape, dtype=torch.bool, device=dev)]
    for i in range(1, n_cand):
        ok = ~gbs[i].is_emissive()
        if r.reject_dissimilar_neighbors:
            ok &= mathx.dot(gbs[i].normal, gb.normal) \
                >= r.min_normal_similarity
            depth_ratio = torch.where(
                gbs[i].depth > 0.0,
                gb.depth / torch.clamp(gbs[i].depth, min=1e-20), 0.0)
            half = r.max_depth_difference * 0.5
            ok &= (depth_ratio >= 1.0 - half) & (depth_ratio <= 1.0 + half)
        valid.append(ok)
    m_count = torch.stack(valid).sum(dim=0).to(torch.float32)
    rcp_m = torch.where(m_count > 0.0, 1.0 / m_count, 0.0)

    conf = [torch.where(valid[i], ress[i].confidence, 0.0)
            for i in range(n_cand)]
    conf_sum = conf[0]
    for c in conf[1:]:
        conf_sum = conf_sum + c
    conf_nc = conf_sum - conf[0]

    def ph(sample, surf):
        return evaluate_p_hat(sample, scene, surf, True, p, cfg.intersector)

    # every candidate's sample at the centre surface: the resampling
    # p_hat, needed by all schemes (pg/ReSTIRIntegrator.cpp:472)
    p_center = [ph(ress[i].sample, gb) for i in range(n_cand)]

    if r.spatial_mis == SpatialMis.BALANCE_HEURISTIC:
        # O(M^2): p_hat of sample i at every neighbour surface j
        # (pg/ReSTIRIntegrator.cpp:406-424)
        mis = []
        for i in range(n_cand):
            nom = torch.zeros(shape, device=dev)
            denom = torch.zeros(shape, device=dev)
            for j in range(n_cand):
                pij = p_center[i] if j == 0 else ph(ress[i].sample, gbs[j])
                pij = torch.where(valid[j], pij, 0.0)
                denom = denom + pij * conf[j]
                if i == j:
                    nom = pij * conf[i]
            mis.append(_safe_div(nom, denom))
    elif r.spatial_mis == SpatialMis.PAIRWISE:
        # O(M) pairwise against the canonical (centre) candidate
        # (pg/ReSTIRIntegrator.cpp:427-467)
        safe_conf_sum = torch.clamp(conf_sum, min=1e-30)
        p_hat_c = p_center[0] * conf[0]
        acc = torch.zeros(shape, device=dev)
        for j in range(1, n_cand):
            p_hat_j = torch.where(valid[j], ph(ress[0].sample, gbs[j]), 0.0)
            denom = p_hat_c + p_hat_j * conf_nc
            acc = acc + torch.where(
                (denom > 0.0) & valid[j],
                (conf[j] / safe_conf_sum)
                * (p_hat_c / torch.clamp(denom, min=1e-30)), 0.0)
        mis = [torch.where(conf_sum > 0.0, conf[0] / safe_conf_sum + acc,
                           0.0)]
        # p_hat of sample i at the canonical surface is p_center[i]
        for i in range(1, n_cand):
            p_hat_i = torch.where(valid[i], ph(ress[i].sample, gbs[i]),
                                  0.0) * conf_nc
            denom = p_hat_i + p_center[i] * conf[0]
            mis.append(torch.where(
                (denom > 0.0) & (conf_sum > 0.0),
                (conf[i] / safe_conf_sum)
                * (p_hat_i / torch.clamp(denom, min=1e-30)), 0.0))
    else:
        mis = [rcp_m] * n_cand

    # resample (pg/ReSTIRIntegrator.cpp:470-478)
    out = rsv.empty_reservoir(shape, dev)
    sel_idx = torch.zeros(shape, dtype=torch.int32, device=dev)
    for i in range(n_cand):
        w_i = torch.where(valid[i], mis[i] * p_center[i] * ress[i].w, 0.0)
        out, acc = rsv.add_sample_u(out, uni(i, 1, 3)[..., 0],
                                    ress[i].sample, w_i, conf[i])
        sel_idx = torch.where(acc, i, sel_idx)

    # finalize W per scheme (pg/ReSTIRIntegrator.cpp:480-538)
    final_p_hat = ph(out.sample, gb)
    base_w = _safe_div(out.w_sum, final_p_hat)
    if r.spatial_mis == SpatialMis.CONSTANT_DEBIAS_Z:
        z = torch.zeros(shape, device=dev)
        for i in range(n_cand):
            occ = intersect.test_occlusion(scene, gbs[i].pos,
                                           out.sample.point, p,
                                           cfg.intersector)
            z = z + torch.where(valid[i] & ~occ, 1.0, 0.0)
        corr = torch.where((z > 0.0) & (m_count > 0.0),
                           (1.0 / torch.clamp(z, min=1e-30))
                           / torch.clamp(rcp_m, min=1e-30), 1.0)
        w_final = corr * base_w
    elif r.spatial_mis == SpatialMis.CONSTANT_DEBIAS_CONTRIB:
        nom = torch.zeros(shape, device=dev)
        denom = torch.zeros(shape, device=dev)
        for i in range(n_cand):
            p_sel_i = torch.where(valid[i], ph(out.sample, gbs[i]), 0.0)
            denom = denom + p_sel_i * conf[i]
            nom = torch.where(sel_idx == i, p_sel_i * conf[i], nom)
        corr = torch.where(m_count > 0.0, _safe_div(nom, denom)
                           / torch.clamp(rcp_m, min=1e-30), 0.0)
        w_final = corr * base_w
    else:
        w_final = base_w

    out = rsv.cap_confidence(dataclasses.replace(out, w=w_final),
                             r.confidence_cap)
    # emissive centre pixels pass through (pg/ReSTIRIntegrator.cpp:318-324)
    return rsv.select(gb.is_emissive(), res_in, out)
