"""Progressive renderer: the host-side frame loop (counterpart of
`tpu_restir.renderer.Renderer`; reference SimpleGuiDX11 producer loop,
pg/simpleguidx11.cpp:223-334). Each frame is rendered at 1 spp by the
configured integrator (ReSTIR, or the stateless naive and NEE path
tracers) and lerped into the HDR accumulator with weight 1/(n+1); the
display image goes accumulate -> [SVGF or joint-bilateral denoise, ReSTIR
only] -> ACES -> sRGB -> debug-pixel overlay. The state (accumulator,
luminance second moment, ReSTIR state, SVGF history, counters) lives on
the device the renderer was given.

With cfg.n_devices > 1 the renderer is one rank of a row mesh
(`tpu_restir_torch.dist`; the process group must exist, of n_devices
ranks, each running the same calls): the ReSTIR frame, its accumulator
and state are sharded by rows, and display, export, checkpoints and the
SVGF denoiser work on full rows gathered onto rank 0, which alone
returns the display image and writes files. As in the JAX package, only
the ReSTIR integrator is sharded: the naive and NEE path tracers render
the whole image on every rank.
"""

from __future__ import annotations

import contextlib
import time

import torch

from tpu_restir_torch import mathx, metrics, rng, tracing
from tpu_restir_torch.config import RenderConfig
from tpu_restir_torch.io.export import export_image
from tpu_restir_torch.mathx.color import aces, srgb_compress
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render.integrators import render_naive, render_nee
from tpu_restir_torch.render.integrators.restir.pipeline import (
    init_restir_state, restir_step)
from tpu_restir_torch.dist import mesh as mesh_mod
from tpu_restir_torch.dist import sharded


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
    """Headless progressive renderer on a given device (this rank's, for
    cfg.n_devices > 1), with explicit, checkpointable state
    (`io.checkpoint`)."""

    def __init__(self, scene, cfg: RenderConfig, device):
        if cfg.integrator not in ("naive", "nee", "restir"):
            raise ValueError(f"unknown integrator {cfg.integrator!r}")
        self.device = torch.device(device)
        self.mesh = None
        if cfg.n_devices > 1:
            self.mesh = mesh_mod.make_mesh(cfg.n_devices, cfg.mesh_axis,
                                           self.device)
            self.device = self.mesh.device
        # the mesh of the ReSTIR frame's rows; None on one device and for
        # the path tracers
        self._rows = self.mesh if cfg.integrator == "restir" else None
        self.scene = scene
        self.cfg = cfg
        self.cam = cam_mod.make_camera(cfg.camera, self.device)
        w = cfg.camera.width
        h = cfg.camera.height
        if self._rows is not None:
            if h % self._rows.size != 0:
                raise ValueError(f"height {h} not divisible by "
                                 f"{self._rows.size} devices")
            h //= self._rows.size
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
        self.timers = metrics.PassTimers(self.device)
        if cfg.profile_passes and cfg.integrator != "restir":
            raise ValueError("profile_passes requires the 'restir' "
                             "integrator")
        self._restir_state = (init_restir_state(h, w, self.device)
                              if cfg.integrator == "restir" else None)

    def update_config(self, cfg: RenderConfig):
        """Swap render knobs mid-run (the reference's live ImGui edits,
        pg/simpleguidx11.cpp:161-217). Resolution, integrator and device
        count are fixed at construction; accumulation is not reset. The
        next frame, sharded or not, reads the new config (there is no
        compiled step to rebuild)."""
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
        """Render one frame and fold it into the accumulator, in the span
        `frame`. Returns without waiting for the device; display/stats/
        export wait. With cfg.profile_passes the ReSTIR frame's pass spans
        fill the per-pass timers (`metrics.PassTimers`; the reference's
        per-pass ms stats, pg/raytracer.cpp:56-75)."""
        with tracing.span("frame"):
            return self._step()

    def _step(self):
        if self._restir_state is None:
            frame = _render_frame(self.scene, self.cam, self.cfg,
                                  rng.frame_key(self.cfg.seed,
                                                self.frame_ctr))
        else:
            with (self.timers.frame() if self.cfg.profile_passes
                  else contextlib.nullcontext()):
                frame, self._restir_state = restir_step(
                    self.scene, self.cam, self.cfg,
                    rng.make_frame_seed(self.cfg.seed, self.frame_ctr),
                    self._restir_state, self.frame_ctr, mesh=self._rows)
        # progressive lerp 1/(n+1) (pg/simpleguidx11.cpp:246-253)
        self.accumulator = self.accumulator + (
            frame - self.accumulator) / (self.acc_ctr + 1.0)
        lum = mathx.luminance(frame)
        self.moment2 = self.moment2 + (
            lum * lum - self.moment2) / (self.acc_ctr + 1.0)
        if (self.cfg.params.denoise and self.cfg.params.denoiser == "svgf"
                and self._restir_state is not None):
            self._svgf_step(frame)
        self.acc_ctr += 1
        self.frame_ctr += 1
        if not self.cfg.accumulate or self.acc_ctr > self.cfg.max_acc_count:
            self.acc_ctr = 0
        return frame

    def _svgf_step(self, frame):
        """The SVGF temporal update of one frame, on full rows (rank 0 of
        a sharded renderer, which gathers the frame and G-buffer)."""
        from tpu_restir_torch.denoise import (empty_svgf_history,
                                              svgf_temporal_update)
        frame = self.full_rows(frame)
        gb = self.full_rows(self._restir_state.gb_prev)
        if frame is None:
            return
        if self._svgf_hist is None:
            h, w = frame.shape[:2]
            self._svgf_hist = empty_svgf_history(h, w, self.device)
        self._svgf_hist, _c, _v = svgf_temporal_update(self._svgf_hist,
                                                       frame, gb)

    def full_rows(self, x):
        """A tensor or ReSTIR state of this renderer with all rows: x
        itself unless the renderer is row-sharded, then gathered onto
        rank 0 (None on the other ranks, which must call it too)."""
        return x if self._rows is None else sharded.gather_full(x,
                                                                self._rows)

    def own_rows(self, x):
        """This renderer's rows of a full-height tensor or ReSTIR state."""
        if self._rows is not None:
            return sharded.split_rows(x, self._rows, self.cfg.camera.height)
        return x.to(self.device) if hasattr(x, "shape") else x

    @property
    def is_root(self) -> bool:
        """Whether this rank returns the display image and writes files
        (rank 0, or the only process)."""
        return self.mesh is None or self.mesh.rank == 0

    def run(self, n_frames: int):
        for _ in range(n_frames):
            self.step()
        self._sync_time()
        return self.accumulator

    def _denoised(self):
        """The accumulator through the configured denoiser, guided by the
        last G-buffer (tpu_restir/renderer.py:257-291), on full rows
        (None on ranks other than 0, which must call it too): the
        variance is the accumulated moment estimate from 2 frames on;
        where the SVGF history has integrated more frames than the
        accumulator (after a reset), its color and variance take the
        pixel's place."""
        if self._restir_state is None:
            # the guide buffers come from the ReSTIR G-buffer; a requested
            # denoise pass is not dropped without a word
            raise ValueError(
                "denoise=True requires the 'restir' integrator (the "
                "denoiser's guide buffers come from its G-buffer)")
        from tpu_restir_torch.denoise import (denoise_accumulator,
                                              spatial_variance)
        acc = self.full_rows(self.accumulator)
        moment2 = self.full_rows(self.moment2)
        gb = self.full_rows(self._restir_state.gb_prev)
        if acc is None:
            return None
        img = acc
        if self.acc_ctr >= 2:
            mean_l = mathx.luminance(acc)
            var = torch.clamp(moment2 - mean_l * mean_l, min=0.0) \
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
        return denoise_accumulator(img, gb, variance=var,
                                   method=self.cfg.params.denoiser)

    def display(self):
        """Accumulator -> display floats in [0, 1] (accumulate -> [denoise]
        -> ACES -> sRGB -> debug-pixel overlay); None on ranks other than
        0, which must call it too."""
        params = self.cfg.params
        img = (self._denoised() if params.denoise
               else self.full_rows(self.accumulator))
        if not self.is_root:
            return None
        out = display_image(img, params)
        if params.debug_pixel is not None:
            x, y = params.debug_pixel
            out = out.clone()
            out[y, x] = torch.tensor([1.0, 0.0, 1.0], device=out.device)
        return out.cpu().numpy()

    def stats(self):
        """(mean, variance) of the accumulated image; a row-sharded
        renderer all-reduces its sums (float64), so every rank returns
        them."""
        self._sync_time()
        if self._rows is None:
            m, v = metrics.image_mean_variance(self.accumulator)
            return float(m), float(v)
        pix = torch.mean(self.accumulator, dim=-1).double()
        s = mesh_mod.all_reduce(self._rows, torch.stack(
            [pix.sum(), (pix * pix).sum()]))
        n = self.cfg.camera.height * self.cfg.camera.width
        m = float(s[0]) / n
        return m, float(s[1]) / n - m * m

    def export(self, path: str):
        """PNG and the reference's sidecar .txt (with the per-pass times
        when profile_passes is on), written by rank 0."""
        mean, var = self.stats()
        img = self.display()
        if not self.is_root:
            return
        export_image(
            path, img, iterations=self.acc_ctr,
            restir=self.cfg.restir, render_time_s=self.render_time,
            image_mean=mean, image_variance=var,
            cam_pos=self.cam.pos.cpu().numpy(),
            cam_view_at=self.cam.view_at.cpu().numpy(),
            fov_deg=self.cfg.camera.fov_y_deg,
            pass_times_ms=self.timers.mean_ms() or None)
