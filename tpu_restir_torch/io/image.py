"""Image decoding for the scene loaders (textures and skies).

PNG is read by the port's own decoder (`io.png`), so the demo asset needs
no imaging package. Other formats go through imageio, else PIL, whichever
is installed; without either it raises, naming the file. No caller
replaces an image it could not decode.
"""

from __future__ import annotations

import numpy as np


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) array of an image file, grey replicated and alpha
    dropped: uint8 for PNG and the LDR formats, float32 where the decoder
    gives floats (.exr). Skies in Radiance .hdr are read by `io.hdr`."""
    if path.lower().endswith(".png"):
        from tpu_restir_torch.io.png import read_png_rgb

        return read_png_rgb(path)
    img = _decode(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _decode(path: str) -> np.ndarray:
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        return np.asarray(imageio.imread(path))
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: no decoder for this format is installed (the port "
            "reads .png and .pfm itself; other formats need imageio or "
            "PIL)") from None
    with Image.open(path) as im:
        # float and integer modes as stored; palettes and the rest as RGB
        if im.mode not in ("F", "I", "RGB", "RGBA"):
            im = im.convert("RGB")
        return np.asarray(im)
