"""The reference's ReSTIR frame: pass schedule with explicit state, a
frozen copy of the port's one-device schedule (G-buffer fill -> initial
candidates -> [visibility] -> [temporal] -> [spatial x N] -> shade), with
its inter-frame state (last frame's reservoirs and G-buffer) returned
from each step.
"""

from __future__ import annotations

import dataclasses

import torch

from perfbench.refrender.render.integrators.restir import gbuffer as gb_mod
from perfbench.refrender.render.integrators.restir import reservoir as rsv
from perfbench.refrender.render.integrators.restir.initial import (
    initial_pass, visibility_pass)
from perfbench.refrender.render.integrators.restir.shade import shade_pass
from perfbench.refrender.render.integrators.restir.spatial import spatial_pass
from perfbench.refrender.render.integrators.restir.temporal import temporal_pass

@dataclasses.dataclass
class RestirState:
    """Inter-frame state: last frame's final reservoirs and G-buffer
    (the reference's reservoirsLastFrame / gBufferLastFrame)."""

    res_prev: rsv.Reservoir
    gb_prev: gb_mod.GBuffer


def init_restir_state(h: int, w: int, device) -> RestirState:
    return RestirState(res_prev=rsv.empty_reservoir((h, w), device),
                       gb_prev=gb_mod.empty_gbuffer(h, w, device))


# the G-buffer's camera snapshot: replicated, not per-pixel
_CAMERA = ("cam_pos", "view_mat", "focal")


def tree_leaves(obj, pixels_only: bool = False):
    """Tensor leaves of a dataclass tree (a RestirState, Reservoir or
    GBuffer), fields depth first in declaration order (the JAX pytree's
    order); with pixels_only, without the G-buffer's camera snapshot."""
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                if not (pixels_only and f.name in _CAMERA)
                for x in tree_leaves(getattr(obj, f.name), pixels_only)]
    return [obj]


def tree_rebuild(obj, leaves, pixels_only: bool = False):
    """The dataclass tree obj with the leaves of tree_leaves(obj,
    pixels_only) replaced by `leaves`, in order."""
    it = iter(leaves)

    def build(o):
        if dataclasses.is_dataclass(o):
            return dataclasses.replace(o, **{
                f.name: build(getattr(o, f.name))
                for f in dataclasses.fields(o)
                if not (pixels_only and f.name in _CAMERA)})
        return next(it)

    return build(obj)


def map_pixels(obj, fn):
    """obj (a GBuffer, Reservoir or RestirState) with fn applied to its
    per-pixel tensors, passed as one list (fn returns the list of their
    replacements, in order); the G-buffer's camera snapshot is kept."""
    return tree_rebuild(obj, fn(tree_leaves(obj, True)), True)


def restir_step(scene, cam, cfg, frame_seed, state: RestirState,
                frame_ctr: int):
    """One ReSTIR frame -> (radiance image (h, w, 3), new state).

    frame_seed: uint32 from rng.make_frame_seed(cfg.seed, frame)."""
    r = cfg.restir
    h, w = cfg.camera.height, cfg.camera.width
    dev = state.res_prev.w_sum.device
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    gb = gb_mod.gbuffer_fill(scene, cam, cfg, frame_seed, ys, xs)
    res = initial_pass(frame_seed, scene, gb, cfg, ys, xs)
    if r.do_visibility_pass:
        res = visibility_pass(scene, gb, res, cfg)
    if r.do_temporal_reuse:
        res_t = temporal_pass(frame_seed, scene, gb, state.gb_prev, res,
                              state.res_prev, cfg, ys, xs)
        # no temporal reuse on the very first frame (frameCtr > 0 gate,
        # pg/simpleguidx11.cpp:408)
        if frame_ctr > 0:
            res = res_t
    if r.do_spatial_reuse:
        for i in range(r.spatial_pass_count):
            res = spatial_pass(frame_seed, i, scene, gb, res, cfg, ys, xs)
    frame = shade_pass(scene, gb, res, cfg)
    return frame, RestirState(res_prev=res, gb_prev=gb)
