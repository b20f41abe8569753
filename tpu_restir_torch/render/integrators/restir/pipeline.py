"""The ReSTIR frame: pass schedule with explicit state (counterpart of
`tpu_restir.render.integrators.restir.pipeline`; reference produceRestir,
pg/simpleguidx11.cpp:359-487). Pass order: G-buffer fill -> initial
candidates -> [visibility] -> [temporal] -> [spatial x N] -> shade. The
inter-frame state (last frame's reservoirs and G-buffer) is a RestirState
returned from each step. One device only.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_restir_torch import rng
from tpu_restir_torch.render.integrators.restir import gbuffer as gb_mod
from tpu_restir_torch.render.integrators.restir import reservoir as rsv
from tpu_restir_torch.render.integrators.restir.initial import (
    initial_pass, visibility_pass)
from tpu_restir_torch.render.integrators.restir.shade import shade_pass
from tpu_restir_torch.render.integrators.restir.spatial import spatial_pass
from tpu_restir_torch.render.integrators.restir.temporal import temporal_pass

# temporal rejection reasons painted by debug_reprojection (the reference
# writes {100,*,*} into the displayed emission, pg/ReSTIRIntegrator.cpp:
# 647-689): accepted, invalid backward, depth, invalid forward, fwd depth
_REASON_COLORS = [[0.0, 0.0, 0.0], [100.0, 100.0, 0.0], [0.0, 100.0, 0.0],
                  [100.0, 0.0, 100.0], [0.0, 0.0, 100.0]]


@dataclasses.dataclass
class RestirState:
    """Inter-frame state: last frame's final reservoirs and G-buffer
    (the reference's reservoirsLastFrame / gBufferLastFrame)."""

    res_prev: rsv.Reservoir
    gb_prev: gb_mod.GBuffer


def init_restir_state(h: int, w: int, device) -> RestirState:
    return RestirState(res_prev=rsv.empty_reservoir((h, w), device),
                       gb_prev=gb_mod.empty_gbuffer(h, w, device))


def restir_step(scene, cam, cfg, frame_seed, state: RestirState,
                frame_ctr: int, *, axis_name=None, n_devices: int = 1):
    """One ReSTIR frame -> (radiance image (h, w, 3), new state).

    frame_seed: uint32 from rng.make_frame_seed(cfg.seed, frame)."""
    if axis_name is not None or n_devices != 1:
        raise NotImplementedError(
            "row-sharded multi-device frames are not ported yet "
            "(ROADMAP item 12)")
    r = cfg.restir
    h, w = cfg.camera.height, cfg.camera.width
    dev = state.res_prev.w_sum.device
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)

    def early(res_now, gb_now):
        """profile_stop_after cut: the same output and state structure."""
        return (torch.zeros(gb_now.depth.shape + (3,), device=dev),
                RestirState(res_prev=res_now, gb_prev=gb_now))

    stop = cfg.profile_stop_after
    gb = gb_mod.gbuffer_fill(scene, cam, cfg, frame_seed, ys, xs)
    if stop == "gbuffer":
        return early(rsv.empty_reservoir(gb.depth.shape, dev), gb)
    res = initial_pass(frame_seed, scene, gb, cfg, ys, xs)
    if stop == "initial":
        return early(res, gb)
    if r.do_visibility_pass:
        res = visibility_pass(scene, gb, res, cfg)
    if stop == "visibility":
        return early(res, gb)

    reasons = None
    if r.do_temporal_reuse:
        res_t = temporal_pass(frame_seed, scene, gb, state.gb_prev, res,
                              state.res_prev, cfg, ys, xs,
                              return_reasons=r.debug_reprojection)
        if r.debug_reprojection:
            res_t, reasons = res_t
        # no temporal reuse on the very first frame (frameCtr > 0 gate,
        # pg/simpleguidx11.cpp:408)
        if frame_ctr > 0:
            res = res_t
    if stop == "temporal":
        return early(res, gb)

    if r.do_spatial_reuse:
        for i in range(r.spatial_pass_count):
            res = spatial_pass(frame_seed, i, scene, gb, res, cfg, ys, xs)
    if stop == "spatial":
        return early(res, gb)

    frame = shade_pass(scene, gb, res, cfg)
    if reasons is not None and frame_ctr > 0:
        # reason 4 is painted at the current pixel, not the reference's
        # scattered reprojected pixel
        colors = torch.tensor(_REASON_COLORS, device=dev)
        frame = torch.where((reasons > 0)[..., None], colors[reasons.long()],
                            frame)
    return frame, RestirState(res_prev=res, gb_prev=gb)


def render_restir_frames(scene, cam, cfg, seed: int, n_frames: int, device):
    """Run n frames from a fresh state -> the accumulated HDR image."""
    h, w = cfg.camera.height, cfg.camera.width
    state = init_restir_state(h, w, device)
    acc = torch.zeros((h, w, 3), device=device)
    for f in range(n_frames):
        frame, state = restir_step(scene, cam, cfg,
                                   rng.make_frame_seed(seed, f), state, f)
        acc = acc + (frame - acc) / (f + 1.0)
    return acc
