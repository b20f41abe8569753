"""The ReSTIR frame: pass schedule with explicit state (counterpart of
`tpu_restir.render.integrators.restir.pipeline`; reference produceRestir,
pg/simpleguidx11.cpp:359-487). Pass order: G-buffer fill -> initial
candidates -> [visibility] -> [temporal] -> [spatial x N] -> shade, each
pass in a span of its own (`tracing.span("restir.<pass>")`). The
inter-frame state (last frame's reservoirs and G-buffer) is a RestirState
returned from each step.

The same passes run on one device and row-sharded: given a row mesh
(`tpu_restir_torch.dist`), each rank renders its own rows and exchanges
G-buffer and reservoir halos before the reuse passes. Every draw is PCG4D
keyed by GLOBAL pixel coordinates, so the sharded frame equals the
one-device frame bit for bit, as long as reprojections stay within the
shard and its halo (they are clamped there, as in the JAX package).
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_restir_torch import rng, tracing
from tpu_restir_torch.dist import halo as halo_mod
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
                frame_ctr: int, *, mesh=None):
    """One ReSTIR frame -> (radiance image (rows, w, 3), new state).

    frame_seed: uint32 from rng.make_frame_seed(cfg.seed, frame).
    mesh: the row mesh (`dist.mesh.make_mesh`) of a sharded frame, whose
    state holds this rank's rows; None on one device."""
    r = cfg.restir
    h, w = cfg.camera.height, cfg.camera.width
    dev = state.res_prev.w_sum.device
    local_h = state.res_prev.w_sum.shape[0]
    sharded = mesh is not None and mesh.size > 1
    row0, halo, use_gather, ext_row0 = 0, 0, False, 0
    if sharded:
        if local_h * mesh.size != h:
            raise ValueError(f"height {h} is not {mesh.size} shards of "
                             f"{local_h} rows")
        row0 = mesh.rank * local_h
        halo = halo_mod.halo_width(r.spatial_reuse_radius)
        # taps bounded by the halo fit in the neighbour shards; a halo
        # taller than the shard falls back to an all-gather of the rows
        use_gather = halo > local_h
        ext_row0 = 0 if use_gather else row0 - halo
    # GLOBAL rows: every draw is keyed by them
    ys = (torch.arange(local_h, dtype=torch.int32, device=dev)[:, None]
          + row0).expand(local_h, w)
    xs = torch.arange(w, dtype=torch.int32,
                      device=dev)[None, :].expand(local_h, w)

    def extend(obj):
        if not sharded:
            return obj
        if use_gather:
            return map_pixels(obj, lambda ts: halo_mod.gather_rows(ts, mesh))
        return map_pixels(
            obj, lambda ts: halo_mod.extend_rows(ts, halo, mesh))

    def early(res_now, gb_now):
        """profile_stop_after cut: the same output and state structure."""
        return (torch.zeros(gb_now.depth.shape + (3,), device=dev),
                RestirState(res_prev=res_now, gb_prev=gb_now))

    stop = cfg.profile_stop_after
    with tracing.span("restir.gbuffer"):
        gb = gb_mod.gbuffer_fill(scene, cam, cfg, frame_seed, ys, xs)
    if stop == "gbuffer":
        return early(rsv.empty_reservoir(gb.depth.shape, dev), gb)
    with tracing.span("restir.initial"):
        res = initial_pass(frame_seed, scene, gb, cfg, ys, xs)
    if stop == "initial":
        return early(res, gb)
    if r.do_visibility_pass:
        with tracing.span("restir.visibility"):
            res = visibility_pass(scene, gb, res, cfg)
    if stop == "visibility":
        return early(res, gb)

    gb_ext = extend(gb) if (r.do_temporal_reuse or r.do_spatial_reuse) \
        else gb
    reasons = None
    if r.do_temporal_reuse:
        with tracing.span("restir.temporal"):
            res_t = temporal_pass(frame_seed, scene, gb, state.gb_prev, res,
                                  state.res_prev, cfg, ys, xs, gb_ext=gb_ext,
                                  gb_prev_ext=extend(state.gb_prev),
                                  ext_row0=ext_row0,
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
        # the payload row of output row 0: 0 on one device, halo in a
        # halo-extended strip, row0 in all-gathered rows
        ext_top = row0 if use_gather else halo
        for i in range(r.spatial_pass_count):
            with tracing.span("restir.spatial"):
                res = spatial_pass(frame_seed, i, scene, gb, res, cfg, ys,
                                   xs, gb_ext=gb_ext, res_ext=extend(res),
                                   ext_row0=ext_row0, ext_top=ext_top)
    if stop == "spatial":
        return early(res, gb)

    with tracing.span("restir.shade"):
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
