"""Progressive renderer: the host-side frame loop (counterpart of
`tpu_restir.renderer.Renderer`; reference SimpleGuiDX11 producer loop,
pg/simpleguidx11.cpp:223-334). Each frame is rendered at 1 spp by the
configured integrator (ReSTIR, or the stateless naive and NEE path
tracers) and lerped into the HDR accumulator with weight 1/(n+1); the
display image goes accumulate -> [SVGF or joint-bilateral denoise, ReSTIR
only] -> ACES -> sRGB -> debug-pixel overlay. The state (accumulator,
luminance second moment, ReSTIR state, SVGF history, counters) lives on
the one device the renderer was given.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_restir_torch import mathx, metrics, rng
from tpu_restir_torch.config import RenderConfig
from tpu_restir_torch.io.export import export_image
from tpu_restir_torch.mathx.color import aces, srgb_compress
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render.integrators import render_naive, render_nee
from tpu_restir_torch.render.integrators.restir.pipeline import (
    init_restir_state, restir_step)


def _render_frame(scene, cam, cfg: RenderConfig, key):
    """One 1-spp frame of the stateless integrators (naive, NEE) from the
    frame key."""
    if cfg.integrator == "naive":
        return render_naive(scene, cam, cfg, key)
    if cfg.integrator == "nee":
        return render_nee(scene, cam, cfg, key)
    if cfg.integrator == "restir":
        raise RuntimeError(
            "use Renderer, which threads the ReSTIR state between frames")
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


def display_image(accumulator, params):
    """HDR accumulator -> display colors (pg/simpleguidx11.cpp:262-295):
    optional ACES, then sRGB compress."""
    img = accumulator
    if params.tonemap:
        img = aces(img)
    if params.gamma_correct:
        img = srgb_compress(img)
    return torch.clamp(img, 0.0, 1.0)


class Renderer:
    """Headless progressive renderer on one given device, with explicit,
    checkpointable state (`io.checkpoint`)."""

    def __init__(self, scene, cfg: RenderConfig, device):
        if cfg.integrator not in ("naive", "nee", "restir"):
            raise ValueError(f"unknown integrator {cfg.integrator!r}")
        if cfg.n_devices != 1:
            raise NotImplementedError(
                "multi-device rendering is not ported yet (ROADMAP item 12)")
        self.device = torch.device(device)
        self.scene = scene
        self.cfg = cfg
        self.cam = cam_mod.make_camera(cfg.camera, self.device)
        h, w = cfg.camera.height, cfg.camera.width
        self.accumulator = torch.zeros((h, w, 3), device=self.device)
        # luminance second moment, the same progressive lerp as the
        # accumulator; (m2 - mean^2)/n estimates the per-pixel variance of
        # the accumulated estimate, the SVGF denoiser's guide
        self.moment2 = torch.zeros((h, w), device=self.device)
        # SVGF temporal history (reprojected color and moments; survives
        # accumulator resets on camera motion), made on the first denoised
        # frame
        self._svgf_hist = None
        self.acc_ctr = 0
        self.frame_ctr = 0
        self.render_time = 0.0
        self._time_base = 0.0
        self._t_reset = time.perf_counter()
        self.timers = metrics.PassTimers()
        if cfg.profile_passes and cfg.integrator != "restir":
            raise ValueError("profile_passes requires the 'restir' "
                             "integrator")
        self._restir_state = (init_restir_state(h, w, self.device)
                              if cfg.integrator == "restir" else None)

    def update_config(self, cfg: RenderConfig):
        """Swap render knobs mid-run (the reference's live ImGui edits,
        pg/simpleguidx11.cpp:161-217). Resolution, integrator and device
        count are fixed at construction; accumulation is not reset."""
        old = self.cfg
        if (cfg.camera.width != old.camera.width
                or cfg.camera.height != old.camera.height
                or cfg.integrator != old.integrator
                or cfg.n_devices != old.n_devices):
            raise ValueError("update_config cannot change resolution, "
                             "integrator, or device count — build a new "
                             "Renderer")
        self.cfg = cfg

    def set_camera(self, view_from=None, view_at=None):
        """Camera move; accumulation is not reset, as in the reference."""
        self.cam = cam_mod.make_camera(self.cfg.camera, self.device,
                                       view_from, view_at)

    def reset_accumulation(self):
        self.accumulator = torch.zeros_like(self.accumulator)
        self.moment2 = torch.zeros_like(self.moment2)
        self.acc_ctr = 0
        self.render_time = 0.0
        self._time_base = 0.0
        self._t_reset = time.perf_counter()

    def _sync_time(self):
        """Wait for the device and refresh render_time (wall clock since
        the last reset, the reference's sidecar semantics)."""
        metrics.sync(self.accumulator)
        self.render_time = self._time_base + (
            time.perf_counter() - self._t_reset)

    def step(self):
        """Render one frame and fold it into the accumulator. Returns
        without waiting for the device; display/stats/export wait."""
        if self._restir_state is None:
            frame = _render_frame(self.scene, self.cam, self.cfg,
                                  rng.frame_key(self.cfg.seed,
                                                self.frame_ctr))
        elif self.cfg.profile_passes:
            frame, self._restir_state = self._timed_step(
                rng.make_frame_seed(self.cfg.seed, self.frame_ctr))
        else:
            frame, self._restir_state = restir_step(
                self.scene, self.cam, self.cfg,
                rng.make_frame_seed(self.cfg.seed, self.frame_ctr),
                self._restir_state, self.frame_ctr)
        # progressive lerp 1/(n+1) (pg/simpleguidx11.cpp:246-253)
        self.accumulator = self.accumulator + (
            frame - self.accumulator) / (self.acc_ctr + 1.0)
        lum = mathx.luminance(frame)
        self.moment2 = self.moment2 + (
            lum * lum - self.moment2) / (self.acc_ctr + 1.0)
        if (self.cfg.params.denoise and self.cfg.params.denoiser == "svgf"
                and self._restir_state is not None):
            from tpu_restir_torch.denoise import (empty_svgf_history,
                                                  svgf_temporal_update)
            if self._svgf_hist is None:
                h, w = frame.shape[:2]
                self._svgf_hist = empty_svgf_history(h, w, self.device)
            self._svgf_hist, _c, _v = svgf_temporal_update(
                self._svgf_hist, frame, self._restir_state.gb_prev)
        self.acc_ctr += 1
        self.frame_ctr += 1
        if not self.cfg.accumulate or self.acc_ctr > self.cfg.max_acc_count:
            self.acc_ctr = 0
        return frame

    def _timed_step(self, fseed):
        """Per-pass timing of the one pipeline (the reference's per-pass
        ms stats, pg/raytracer.cpp:56-75): restir_step runs once per
        prefix, cut after each pass by cfg.profile_stop_after, and a pass's
        time is the difference of adjacent prefix times
        (tpu_restir/renderer.py:189-243). The last, uncut run is the
        frame."""
        r_cfg = self.cfg.restir
        stages = ["gbuffer", "initial"]
        if r_cfg.do_visibility_pass:
            stages.append("visibility")
        if r_cfg.do_temporal_reuse:
            stages.append("temporal")
        if r_cfg.do_spatial_reuse:
            stages.append("spatial")
        stages.append("shade")  # the whole frame
        prev_t = 0.0
        out = None
        for st in stages:
            v = self.cfg.replace(
                profile_stop_after=None if st == "shade" else st)
            t0 = time.perf_counter()
            out = restir_step(self.scene, self.cam, v, fseed,
                              self._restir_state, self.frame_ctr)
            metrics.sync(out)
            cum = time.perf_counter() - t0
            self.timers.record(st, max(cum - prev_t, 0.0))
            prev_t = cum
        return out

    def run(self, n_frames: int):
        for _ in range(n_frames):
            self.step()
        self._sync_time()
        return self.accumulator

    def _denoised(self):
        """The accumulator through the configured denoiser, guided by the
        last G-buffer (tpu_restir/renderer.py:257-291): the variance is the
        accumulated moment estimate from 2 frames on; where the SVGF
        history has integrated more frames than the accumulator (after a
        reset), its color and variance take the pixel's place."""
        if self._restir_state is None:
            # the guide buffers come from the ReSTIR G-buffer; a requested
            # denoise pass is not dropped without a word
            raise ValueError(
                "denoise=True requires the 'restir' integrator (the "
                "denoiser's guide buffers come from its G-buffer)")
        from tpu_restir_torch.denoise import (denoise_accumulator,
                                              spatial_variance)
        img = self.accumulator
        if self.acc_ctr >= 2:
            mean_l = mathx.luminance(self.accumulator)
            var = torch.clamp(self.moment2 - mean_l * mean_l, min=0.0) \
                / self.acc_ctr
        else:
            var = None  # the spatial estimate (SVGF first-frames rule)
        if self._svgf_hist is not None:
            hs = self._svgf_hist
            use_h = (hs.length > float(self.acc_ctr))[..., None]
            img = torch.where(use_h, hs.color, img)
            var_h = torch.where(
                hs.length >= 4.0,
                torch.clamp(hs.m2 - hs.m1 * hs.m1, min=0.0),
                spatial_variance(hs.color))
            var = var_h if var is None else torch.where(
                use_h[..., 0], var_h, var)
        return denoise_accumulator(img, self._restir_state.gb_prev,
                                   variance=var,
                                   method=self.cfg.params.denoiser)

    def display(self) -> np.ndarray:
        """Accumulator -> display floats in [0, 1] (accumulate -> [denoise]
        -> ACES -> sRGB -> debug-pixel overlay)."""
        params = self.cfg.params
        img = self._denoised() if params.denoise else self.accumulator
        out = display_image(img, params)
        if params.debug_pixel is not None:
            x, y = params.debug_pixel
            out = out.clone()
            out[y, x] = torch.tensor([1.0, 0.0, 1.0], device=out.device)
        return out.cpu().numpy()

    def stats(self):
        """(mean, variance) of the accumulated image."""
        self._sync_time()
        m, v = metrics.image_mean_variance(self.accumulator)
        return float(m), float(v)

    def export(self, path: str):
        """PNG and the reference's sidecar .txt (with the per-pass times
        when profile_passes is on)."""
        mean, var = self.stats()
        export_image(
            path, self.display(), iterations=self.acc_ctr,
            restir=self.cfg.restir, render_time_s=self.render_time,
            image_mean=mean, image_variance=var,
            cam_pos=self.cam.pos.cpu().numpy(),
            cam_view_at=self.cam.view_at.cpu().numpy(),
            fov_deg=self.cfg.camera.fov_y_deg,
            pass_times_ms=self.timers.mean_ms() or None)
