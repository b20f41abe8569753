"""Texture sampling over a native-resolution texture stack (counterpart of
`tpu_restir.scene.textures`; reference pg/Texture.cpp:9-194).

Every texture is zero-padded into one (T, Hmax, Wmax, 3) float32 tensor,
so a whole image of lookups is one gather, with per-texture native
(h, w) and address-mode side tables: the filtering math uses each
texture's NATIVE size, and no texture is resampled to another. HDR
images are stored as linear float, LDR ones as loaded (the loader expands
sRGB).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

CLAMP = 0   # TextureClamp::CLAMP_TO_EDGE (reference default, Texture.h:27)
REPEAT = 1  # TextureClamp::REPEAT


@dataclasses.dataclass
class TextureStack:
    """Padded texture array + native sizes and address modes, on one
    device."""

    data: torch.Tensor     # (T, Hmax, Wmax, 3) float32, zero-padded
    sizes: torch.Tensor    # (T, 2) int32: native (h, w)
    modes: torch.Tensor    # (T,) int32: CLAMP | REPEAT

    @property
    def num_textures(self) -> int:
        return self.data.shape[0]

    def to(self, device) -> "TextureStack":
        return TextureStack(data=self.data.to(device),
                            sizes=self.sizes.to(device),
                            modes=self.modes.to(device))


def _area_downsample(img: np.ndarray, max_size: int) -> np.ndarray:
    """Integer-factor box downsample so max(h, w) <= max_size."""
    h, w = img.shape[:2]
    f = -(-max(h, w) // max_size)
    if f <= 1:
        return img
    hh, ww = (h // f) * f, (w // f) * f
    return img[:hh, :ww].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


def build_texture_stack(images: List[np.ndarray], device,
                        modes: Optional[Sequence[int]] = None,
                        max_size: int = 2048) -> TextureStack:
    """Pack images at native resolution into one padded stack on device
    (the host-side packing of tpu_restir/scene/textures.py:49-72)."""
    imgs = []
    for img in images:
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        imgs.append(_area_downsample(img[..., :3], max_size))
    hmax = max(i.shape[0] for i in imgs)
    wmax = max(i.shape[1] for i in imgs)
    data = np.zeros((len(imgs), hmax, wmax, 3), np.float32)
    sizes = np.zeros((len(imgs), 2), np.int32)
    for t, img in enumerate(imgs):
        h, w = img.shape[:2]
        data[t, :h, :w] = img
        sizes[t] = (h, w)
    m = np.zeros((len(imgs),), np.int32) if modes is None \
        else np.asarray(modes, np.int32)
    return TextureStack(data=torch.tensor(data, device=device),
                        sizes=torch.tensor(sizes, device=device),
                        modes=torch.tensor(m, device=device))


def _blend(c00, c01, c10, c11, fx, fy):
    """The bilinear blend in the JAX package's order."""
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) \
        + (c10 * (1 - fx) + c11 * fx) * fy


def sample_bilinear(image, uv, address: int = CLAMP):
    """Bilinear lookup into one (H, W, 3) image at uv in [0,1]^2; uv.y = 0
    is the bottom row (the reference flips y in get_texel). REPEAT wraps
    by the floored modulo of jnp.mod (torch.remainder, never torch.fmod),
    so negative coordinates wrap as the JAX package wraps them."""
    h, w = image.shape[0], image.shape[1]
    x = uv[..., 0] * (w - 1)
    y = (1.0 - uv[..., 1]) * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def addr(i, n):
        i = i.to(torch.int32)
        if address == REPEAT:
            return torch.abs(torch.remainder(i, n)).long()
        return torch.clamp(i, 0, n - 1).long()

    x0i, x1i = addr(x0, w), addr(x0 + 1, w)
    y0i, y1i = addr(y0, h), addr(y0 + 1, h)
    return _blend(image[y0i, x0i], image[y0i, x1i], image[y1i, x0i],
                  image[y1i, x1i], fx, fy)


def stack_corners(stack: TextureStack, tex_id, uv):
    """(t, y0, y1, x0, x1, fx, fy) of each lookup: the clamped texture id,
    the integer corner rows and columns after the texture's own address
    mode, and the fractional offsets (..., 1)."""
    t = torch.clamp(tex_id, 0, stack.num_textures - 1).long()
    h = stack.sizes[t, 0]
    w = stack.sizes[t, 1]
    repeat = stack.modes[t] == REPEAT
    x = uv[..., 0] * (w - 1).to(torch.float32)
    y = (1.0 - uv[..., 1]) * (h - 1).to(torch.float32)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def addr(i, n):
        rep = torch.abs(torch.remainder(i, n))
        cl = torch.minimum(torch.maximum(i, torch.zeros_like(n)), n - 1)
        return torch.where(repeat, rep, cl).long()

    return (t, addr(y0, h), addr(y0 + 1, h), addr(x0, w), addr(x0 + 1, w),
            fx, fy)


def sample_stack(stack: TextureStack, tex_id, uv, fallback):
    """Bilinear texel per element at NATIVE texture resolution, honouring
    each texture's address mode; tex_id < 0 -> fallback colour
    (reference getTexelBilinear -> get_texel, pg/Texture.cpp:72-140).
    Differentiable in stack.data: autograd's backward of the gathers is an
    accumulating index_put_."""
    t, y0i, y1i, x0i, x1i, fx, fy = stack_corners(stack, tex_id, uv)
    d = stack.data
    texel = _blend(d[t, y0i, x0i], d[t, y0i, x1i], d[t, y1i, x0i],
                   d[t, y1i, x1i], fx, fy)
    return torch.where((tex_id >= 0)[..., None], texel, fallback)
