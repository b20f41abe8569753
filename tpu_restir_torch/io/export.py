"""Image export: PNG + sidecar metric .txt (the port's copy of
`tpu_restir.io.export`, numpy and zlib only).

The sidecar format replicates the reference's exportImage fields verbatim
(pg/simpleguidx11.cpp:607-650) — those files are the reference's entire
quantitative evaluation record (BASELINE.md), so keeping the format makes
numbers directly comparable.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, img) -> None:
    """img: (H, W, 3) float in [0, 1] -> RGBA PNG (as the reference writes
    4-channel output via stb_image_write): the pixels of the JAX package's
    PIL writer, encoded here with zlib (8-bit RGBA, filter 0 on every row)
    so that the port needs no imaging package."""
    arr = np.asarray(img)
    byte = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    rgba = np.concatenate(
        [byte, np.full(byte.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    h, w = rgba.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgba.reshape(h, w * 4)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def _vec3(v) -> str:
    v = np.asarray(v, np.float64)
    return f"vec3({v[0]:.6f}, {v[1]:.6f}, {v[2]:.6f})"


def write_sidecar(path: str, *, iterations: int, restir, render_time_s: float,
                  image_mean: float, image_variance: float,
                  cam_pos, cam_view_at, fov_deg: float,
                  pass_times_ms: Optional[dict] = None) -> None:
    """Write `<image>.txt` with the same fields and layout as the
    reference (pg/simpleguidx11.cpp:627-650)."""
    lines = [
        f"Image name: {path[:-4] if path.endswith('.txt') else path}", "",
        f"Iteration count: {iterations}",
        f"Area samples: {restir.m_area}",
        f"BRDF samples: {restir.m_brdf}", "",
        f"Spatial reuse: {'True' if restir.do_spatial_reuse else 'False'}",
        f"\tPass count: {restir.spatial_pass_count}",
        f"\tNeighbor count: {restir.spatial_neighbor_count}",
        f"\tReuse radius: {restir.spatial_reuse_radius:g}", "",
        f"Temporal reuse: {'True' if restir.do_temporal_reuse else 'False'}",
        "",
        f"Render time: {render_time_s:g} s",
        f"Image mean: {image_mean:g}",
        f"Image variance: {image_variance:g}", "",
        f"Camera position: {_vec3(cam_pos)}",
        f"Camera view at: {_vec3(cam_view_at)}",
        f"Camera vertical FOV: {fov_deg:g}",
    ]
    if pass_times_ms:
        # per-pass ms (shown by the reference's stats panel,
        # pg/raytracer.cpp:56-75; recorded when profile_passes is on)
        lines += ["", "Pass times (ms):"]
        lines += [f"\t{name}: {ms:.2f}" for name, ms in pass_times_ms.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def export_image(path: str, display_img, *, iterations: int, restir,
                 render_time_s: float, image_mean: float,
                 image_variance: float, cam_pos, cam_view_at,
                 fov_deg: float, pass_times_ms: Optional[dict] = None) -> None:
    """PNG + sidecar pair, the full reference export behavior."""
    save_png(path, display_img)
    write_sidecar(path + ".txt", iterations=iterations, restir=restir,
                  render_time_s=render_time_s, image_mean=image_mean,
                  image_variance=image_variance, cam_pos=cam_pos,
                  cam_view_at=cam_view_at, fov_deg=fov_deg,
                  pass_times_ms=pass_times_ms)
