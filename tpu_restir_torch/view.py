"""Minimal live viewer of the port (counterpart of `tpu_restir.view`):
in-terminal progressive display + camera orbit.

The reference is an interactive ImGui/D3D11 app with a stats panel and
mouse-orbit camera (pg/simpleguidx11.cpp:497-604). Headless equivalent:
every frame the display image renders into the terminal as 24-bit ANSI
half-block cells (two pixels per character row), with a stats line
(iteration, mean/variance, per-pass ms when profiling); --orbit spins the
camera around the view target like the reference's right-drag orbit
(pg/simpleguidx11.cpp:572-604), exercising temporal reprojection under
real motion. PNG refresh (--export-every) covers non-TTY use.
"""

from __future__ import annotations

import math
import select
import sys

import numpy as np

from tpu_restir_torch.config import SpatialMis, replace


def ansi_preview(img: np.ndarray, max_cols: int = 96,
                 max_rows: int = 48) -> str:
    """(H, W, 3) floats in [0,1] -> ANSI string, 2 pixels per char row."""
    h, w = img.shape[:2]
    step = max(1, math.ceil(w / max_cols), math.ceil(h / (2 * max_rows)))
    # box-filter downsample by `step`
    hh = (h // step) * step
    ww = (w // step) * step
    small = img[:hh, :ww].reshape(hh // step, step, ww // step, step, 3)
    small = small.mean(axis=(1, 3))
    if small.shape[0] % 2:
        small = small[:-1]
    byte = (np.clip(small, 0.0, 1.0) * 255).astype(np.uint8)
    top = byte[0::2]
    bot = byte[1::2]
    lines = []
    for r in range(top.shape[0]):
        cells = []
        for c in range(top.shape[1]):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def orbit_camera(view_from, view_at, angle_deg: float):
    """Rotate the eye around the target about +z (the reference's
    spherical orbit, pg/simpleguidx11.cpp:572-604)."""
    f = np.asarray(view_from, np.float64)
    at = np.asarray(view_at, np.float64)
    rel = f - at
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return tuple((at + rot @ rel).tolist())


# Live parameter editing — the headless analog of the reference's ImGui
# panel (pg/simpleguidx11.cpp:161-217, pg/ReSTIRIntegrator.cpp:37-87).
# Each key maps to a config edit, which the Renderer's next frame runs.
KEY_HELP = ("keys: [t]emporal [s]patial [v]isibility  m/M area-  b/B brdf-"
            "candidates  n/N neighbors  p cycle-spatial-MIS  [d]enoise  "
            "[a]ces  [r]eset-acc  [q]uit")


def apply_key(cfg, key: str):
    """One keypress -> new RenderConfig (None = no change; 'q' handled by
    the caller). Pure function so the mapping is unit-testable."""
    r = cfg.restir
    p = cfg.params
    if key == "t":
        return cfg.replace(restir=replace(
            r, do_temporal_reuse=not r.do_temporal_reuse))
    if key == "s":
        return cfg.replace(restir=replace(
            r, do_spatial_reuse=not r.do_spatial_reuse))
    if key == "v":
        return cfg.replace(restir=replace(
            r, do_visibility_pass=not r.do_visibility_pass))
    if key == "m":
        return cfg.replace(restir=replace(r, m_area=max(r.m_area - 1, 0)))
    if key == "M":
        return cfg.replace(restir=replace(r, m_area=r.m_area + 1))
    if key == "b":
        return cfg.replace(restir=replace(r, m_brdf=max(r.m_brdf - 1, 0)))
    if key == "B":
        return cfg.replace(restir=replace(r, m_brdf=r.m_brdf + 1))
    if key == "n":
        return cfg.replace(restir=replace(
            r, spatial_neighbor_count=max(r.spatial_neighbor_count - 1, 0)))
    if key == "N":
        return cfg.replace(restir=replace(
            r, spatial_neighbor_count=r.spatial_neighbor_count + 1))
    if key == "p":
        i = SpatialMis.ALL.index(r.spatial_mis)
        nxt = SpatialMis.ALL[(i + 1) % len(SpatialMis.ALL)]
        return cfg.replace(restir=replace(r, spatial_mis=nxt))
    if key == "d":
        return cfg.replace(params=replace(p, denoise=not p.denoise))
    if key == "a":
        return cfg.replace(params=replace(p, tonemap=not p.tonemap))
    return None


def _poll_keys(stdin=sys.stdin):
    """Non-blocking read of pending keypresses (TTY raw mode assumed off:
    reads whole lines too — each character is applied)."""
    keys = []
    try:
        while select.select([stdin], [], [], 0)[0]:
            ch = stdin.read(1)
            if not ch:
                break
            keys.extend(ch.strip())
    except (OSError, ValueError):
        pass
    return keys


def run_view(renderer, n_frames: int, orbit_deg_per_frame: float = 0.0,
             refresh_every: int = 1, out=sys.stdout, stdin=sys.stdin):
    """Progressive render with live terminal display + key editing. On a
    rank of a multi-rank renderer (every rank runs it) only rank 0 draws,
    and keys are not read: a key read by one rank alone would leave the
    ranks with different configs."""
    is_tty = hasattr(out, "isatty") and out.isatty()
    keys = is_tty and renderer.mesh is None
    view_from = renderer.cfg.camera.view_from
    view_at = renderer.cfg.camera.view_at
    for i in range(n_frames):
        for key in (_poll_keys(stdin) if keys else []):
            if key == "q":
                return renderer.accumulator
            if key == "r":
                renderer.reset_accumulation()
                continue
            new_cfg = apply_key(renderer.cfg, key)
            if new_cfg is not None:
                renderer.update_config(new_cfg)
        # accumulation deliberately NOT reset on camera motion — matches
        # the reference (reset is explicit, pg/simpleguidx11.cpp:303-306)
        if orbit_deg_per_frame:
            view_from = orbit_camera(view_from, view_at,
                                     orbit_deg_per_frame)
            renderer.set_camera(view_from=view_from)
        renderer.step()
        if (i + 1) % refresh_every == 0 or i + 1 == n_frames:
            img = renderer.display()
            mean, var = renderer.stats()
            if not renderer.is_root:
                continue
            if is_tty:
                out.write("\x1b[H\x1b[2J")   # clear
                out.write(ansi_preview(img) + "\n")
            line = (f"frame {i + 1}/{n_frames}  acc={renderer.acc_ctr}  "
                    f"mean={mean:.5g} var={var:.5g}  "
                    f"t={renderer.render_time:.1f}s")
            ms = renderer.timers.mean_ms()
            if ms:
                line += "  |  " + "  ".join(f"{k}={v:.1f}ms"
                                            for k, v in ms.items())
            r = renderer.cfg.restir
            knobs = (f"M={r.m_area}+{r.m_brdf} "
                     f"T={'on' if r.do_temporal_reuse else 'off'} "
                     f"S={'on' if r.do_spatial_reuse else 'off'}"
                     f"({r.spatial_neighbor_count}n,{r.spatial_mis})")
            out.write(line + "\n" + knobs + "  " + KEY_HELP + "\n")
            out.flush()
    return renderer.accumulator
