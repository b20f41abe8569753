"""Environment (sky) lookup and the environment image readers
(counterpart of `tpu_restir.scene.envmap`).

Equirectangular spherical map per the reference's SphericalMap
(pg/SphericalMap.cpp:10-14): x = 0.5 + 0.5*atan2(dy, dx)/pi,
y = 1 - acos(dz)/pi, looked up bilinearly with CLAMP addressing (the seam
at x = 0 | 1 is clamped, not wrapped, as in the JAX package). Misses fall
back to the flat background colour (pg/RenderParams.h bgColor) when no
map is loaded or use_skybox is off.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from perfbench.refrender import mathx
from perfbench.refrender.scene.textures import sample_bilinear


def spherical_uv(d):
    x = 0.5 + 0.5 * torch.atan2(d[..., 1], d[..., 0]) / math.pi
    y = 1.0 - torch.acos(mathx.clip(d[..., 2], -1.0, 1.0)) / math.pi
    return torch.stack([x, y], dim=-1)


def sky_radiance(scene, params, d):
    """Radiance for rays that leave the scene, shaped like d."""
    if params.use_skybox and scene.envmap is not None:
        return sample_bilinear(scene.envmap, spherical_uv(d))
    bg = torch.tensor(params.bg_color, dtype=torch.float32, device=d.device)
    return bg.expand(d.shape)


def load_hdr(path: str) -> np.ndarray:
    """An HDR/EXR/PFM/PNG environment image as (H, W, 3) float32 on the
    host. PFM (the demo asset's format) is read here, Radiance .hdr as
    radiance by `io.hdr`, PNG (byte values 0-255, as imageio gives them)
    and the rest by `io.image.read_image`, which raises where no decoder
    is installed: the sky is never replaced by a flat colour."""
    if path.lower().endswith(".pfm"):
        return read_pfm(path)
    if path.lower().endswith(".hdr"):
        from perfbench.refrender.io.hdr import read_hdr

        return read_hdr(path)
    from perfbench.refrender.io.image import read_image

    return read_image(path).astype(np.float32)


def with_sky(scene, path: str):
    """scene with the environment image at path as its sky (`envmap`),
    on the scene's device."""
    return dataclasses.replace(scene, envmap=torch.tensor(
        load_hdr(path), device=scene.tri_v.device))


def read_pfm(path: str) -> np.ndarray:
    """Portable FloatMap reader (colour 'PF', either byte order, stored
    bottom-up), rows returned top-down."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header != b"PF":
            raise ValueError(f"{path}: not a color PFM")
        w, h = (int(v) for v in f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(w * h * 3 * 4),
                             "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3)
    return np.ascontiguousarray(img[::-1]).astype(np.float32)


def write_pfm(path: str, img) -> None:
    """Portable FloatMap writer (colour, little-endian)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())
