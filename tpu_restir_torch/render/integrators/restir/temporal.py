"""PASS 4: temporal reuse with bidirectional reprojection (counterpart of
`tpu_restir.render.integrators.restir.temporal`; reference
temporalReusePass + reprojectBackward/Forward,
pg/ReSTIRIntegrator.cpp:544-587, 625-732).

Rejection cascade: invalid backward reprojection -> depth ratio < 0.9 ->
invalid forward reprojection -> forward depth ratio < 0.9; a rejected
pixel keeps its current reservoir. Accepted pixels MIS-combine the current
and previous reservoirs with confidence-weighted balance weights.

Faithful quirk (SURVEY.md §2.5): the previous reservoir is read at the
CURRENT pixel, the previous G-buffer element at the reprojected pixel.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_restir_torch import mathx, rng
from tpu_restir_torch.kernels import local_gather as lg
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render.integrators.restir import packed as pk
from tpu_restir_torch.render.integrators.restir import reservoir as rsv
from tpu_restir_torch.render.integrators.restir.phat import evaluate_p_hat


def _reproject_tap(payload, tys, txs):
    """Gather payload (h, w, C) at the reprojected coords (h, w).

    The JAX function picks, under lax.cond (temporal.py:53-56), between
    its windowed Pallas gather (every offset within PAD) and an XLA row
    gather; both return payload[tys, txs]. The CUDA gather (K3) has no
    window bound, so it serves every tap, of any length, unconditionally."""
    return lg.gather_local(payload, tys[None], txs[None], lg.PAD)[0]


def temporal_pass(frame_seed, scene, gb, gb_prev, res_cur, res_prev, cfg,
                  ys, xs, *, return_reasons: bool = False):
    p = cfg.params
    r = cfg.restir
    h, w = cfg.camera.height, cfg.camera.width

    # backward: current surface into the previous camera; irrelevant taps
    # (invalid reprojection, miss pixels) snap to the identity
    bx, by, valid_b = cam_mod.project_to_screen(
        gb_prev.view_mat, gb_prev.focal, w, h, gb.pos)
    rel_b = valid_b & (gb.depth > 0.0)
    byc = torch.where(rel_b, torch.clamp(by, 0, h - 1), ys)
    bxc = torch.where(rel_b, torch.clamp(bx, 0, w - 1), xs)
    slim = pk.reuse_slim(scene.materials)
    prev_elem = pk.unpack_gb(
        _reproject_tap(pk.pack_gb(gb_prev, slim), byc, bxc), gb_prev, slim)

    cur_depth = mathx.length(gb.pos - gb.cam_pos)
    prev_depth = mathx.length(prev_elem.pos - gb_prev.cam_pos)
    depth_ok = torch.minimum(cur_depth, prev_depth) / torch.clamp(
        torch.maximum(cur_depth, prev_depth), min=1e-20) >= 0.9

    # forward: last frame's surface at this pixel into the current camera
    fx, fy, valid_f = cam_mod.project_to_screen(
        gb.view_mat, gb.focal, w, h, gb_prev.pos)
    rel_f = valid_f & (gb_prev.depth > 0.0)
    fyc = torch.where(rel_f, torch.clamp(fy, 0, h - 1), ys)
    fxc = torch.where(rel_f, torch.clamp(fx, 0, w - 1), xs)
    fw_elem_pos = _reproject_tap(gb.pos, fyc, fxc)
    cur_depth_p = mathx.length(gb_prev.pos - gb_prev.cam_pos)
    prev_depth_p = mathx.length(fw_elem_pos - gb.cam_pos)
    depth_ok_p = torch.minimum(cur_depth_p, prev_depth_p) / torch.clamp(
        torch.maximum(cur_depth_p, prev_depth_p), min=1e-20) >= 0.9

    accept = rel_b & depth_ok & rel_f & depth_ok_p

    # confidence-weighted MIS combine (pg/ReSTIRIntegrator.cpp:694-731)
    cur_s, prev_s = res_cur.sample, res_prev.sample
    conf_c, conf_p = res_cur.confidence, res_prev.confidence

    def ph(sample, surf):
        return evaluate_p_hat(sample, scene, surf, True, p, cfg.intersector)

    def balance(p_num, conf_num, p_c, p_p):
        denom = p_c * conf_c + p_p * conf_p
        return torch.where(denom > 0.0, p_num * conf_num
                           / torch.clamp(denom, min=1e-30), 0.0)

    p_cur_cs = ph(cur_s, gb)          # current sample at current surface
    p_prev_cs = ph(cur_s, prev_elem)  # current sample at previous surface
    m_cur = balance(p_cur_cs, conf_c, p_cur_cs, p_prev_cs)
    p_cur_ps = ph(prev_s, gb)
    p_prev_ps = ph(prev_s, prev_elem)
    m_prev = balance(p_prev_ps, conf_p, p_cur_ps, p_prev_ps)

    out = rsv.empty_reservoir(gb.depth.shape, gb.depth.device)
    u1 = rng.pixel_uniform(frame_seed, rng.stream_id(rng.PASS_TEMPORAL, 0),
                           ys, xs)
    u2 = rng.pixel_uniform(frame_seed, rng.stream_id(rng.PASS_TEMPORAL, 1),
                           ys, xs)
    out, _ = rsv.add_sample_u(out, u1, cur_s, m_cur * p_cur_cs * res_cur.w,
                              conf_c)
    out, _ = rsv.add_sample_u(out, u2, prev_s,
                              m_prev * p_cur_ps * res_prev.w, conf_p)
    out = rsv.cap_confidence(out, r.confidence_cap)
    final_p_hat = ph(out.sample, gb)
    out = dataclasses.replace(out, w=torch.where(
        final_p_hat > 0.0,
        out.w_sum / torch.clamp(final_p_hat, min=1e-30), 0.0))

    result = rsv.select(accept, out, res_cur)
    if not return_reasons:
        return result
    # rejection reason in cascade order (debugReprojection view,
    # pg/ReSTIRIntegrator.cpp:644-689): 0 accepted, 1 invalid backward
    # reprojection, 2 depth, 3 invalid forward reprojection, 4 forward depth
    reasons = torch.where(~rel_b, 1, torch.where(~depth_ok, 2, torch.where(
        ~rel_f, 3, torch.where(~depth_ok_p, 4, 0))))
    return result, reasons
