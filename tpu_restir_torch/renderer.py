"""Progressive renderer: the host-side frame loop (counterpart of
`tpu_restir.renderer.Renderer`, ReSTIR integrator only; reference
SimpleGuiDX11 producer loop, pg/simpleguidx11.cpp:223-334). Each frame is
rendered at 1 spp, lerped into the HDR accumulator with weight 1/(n+1),
and shown through ACES and sRGB.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_restir_torch import metrics, rng
from tpu_restir_torch.config import RenderConfig
from tpu_restir_torch.mathx.color import aces, srgb_compress
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render.integrators.restir.pipeline import (
    init_restir_state, restir_step)


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
    """Headless progressive ReSTIR renderer on one given device."""

    def __init__(self, scene, cfg: RenderConfig, device):
        if cfg.integrator != "restir":
            raise NotImplementedError(
                f"integrator {cfg.integrator!r} is not ported yet; only "
                "'restir' is (ROADMAP item 10)")
        if cfg.params.denoise or cfg.profile_passes:
            raise NotImplementedError(
                "denoising and per-pass profiling are not ported yet "
                "(ROADMAP item 9)")
        if cfg.n_devices != 1:
            raise NotImplementedError(
                "multi-device rendering is not ported yet (ROADMAP item 12)")
        self.device = torch.device(device)
        self.scene = scene
        self.cfg = cfg
        self.cam = cam_mod.make_camera(cfg.camera, self.device)
        h, w = cfg.camera.height, cfg.camera.width
        self.accumulator = torch.zeros((h, w, 3), device=self.device)
        self.acc_ctr = 0
        self.frame_ctr = 0
        self.render_time = 0.0
        self._t_reset = time.perf_counter()
        self._restir_state = init_restir_state(h, w, self.device)

    def _sync_time(self):
        """Wait for the device and refresh render_time (wall clock since
        the last reset, the reference's sidecar semantics)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.render_time = time.perf_counter() - self._t_reset

    def step(self):
        """Render one frame and fold it into the accumulator. Returns
        without waiting for the device; display/stats/export wait."""
        fseed = rng.make_frame_seed(self.cfg.seed, self.frame_ctr)
        frame, self._restir_state = restir_step(
            self.scene, self.cam, self.cfg, fseed, self._restir_state,
            self.frame_ctr)
        # progressive lerp 1/(n+1) (pg/simpleguidx11.cpp:246-253)
        self.accumulator = self.accumulator + (
            frame - self.accumulator) / (self.acc_ctr + 1.0)
        self.acc_ctr += 1
        self.frame_ctr += 1
        if not self.cfg.accumulate or self.acc_ctr > self.cfg.max_acc_count:
            self.acc_ctr = 0
        return frame

    def run(self, n_frames: int):
        for _ in range(n_frames):
            self.step()
        self._sync_time()
        return self.accumulator

    def display(self) -> np.ndarray:
        """Accumulator -> display floats in [0, 1] (accumulate -> ACES ->
        sRGB -> debug-pixel overlay)."""
        params = self.cfg.params
        out = display_image(self.accumulator, params)
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
        """PNG and the reference's sidecar .txt, written by the JAX
        package's plain-numpy exporter (imported here, so that rendering
        needs nothing of that package)."""
        from tpu_restir.io.export import export_image

        mean, var = self.stats()
        export_image(
            path, self.display(), iterations=self.acc_ctr,
            restir=self.cfg.restir, render_time_s=self.render_time,
            image_mean=mean, image_variance=var,
            cam_pos=self.cam.pos.cpu().numpy(),
            cam_view_at=self.cam.view_at.cpu().numpy(),
            fov_deg=self.cfg.camera.fov_y_deg)
