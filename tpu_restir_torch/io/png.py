"""The port's PNG decoder (zlib and numpy only), so that loading a
textured scene needs no imaging package.

It reads 8-bit, non-interlaced images of colour type 0 (grey), 2 (RGB)
or 6 (RGBA), with row filters 0-4: the demo asset's textures and the
images `io.export.save_png` writes. Any other layout raises, naming the
file and the layout.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> channels


def _chunks(path: str, blob: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        if len(data) != n:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, data
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG without an IEND chunk")


def _unfilter_row(kind: int, raw: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One scanline's bytes after undoing filter `kind` (PNG spec 9.2)."""
    if kind == 0:
        return raw
    if kind == 1:      # Sub: a running sum per channel, modulo 256
        px = raw.reshape(-1, bpp).astype(np.uint32)
        return (np.cumsum(px, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    if kind == 2:      # Up
        return raw + prior
    out = bytearray(raw.tobytes())
    up = prior.tobytes()
    if kind == 3:      # Average
        for i in range(len(out)):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    else:              # Paeth
        for i in range(len(out)):
            a = out[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 with C = 1, 3 or 4 (grey, RGB, RGBA)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, data in _chunks(path, blob):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or comp != 0 or filt != 0 \
            or interlace != 0:
        raise ValueError(
            f"{path}: PNG layout not supported (bit depth {depth}, colour "
            f"type {ctype}, interlace {interlace}); the port reads 8-bit, "
            f"non-interlaced grey, RGB or RGBA")
    ch = _CHANNELS[ctype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, "
                         f"want {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind = int(rows[y, 0])
        if kind > 4:
            raise ValueError(f"{path}: PNG row {y} has filter type {kind}")
        out[y] = prior = _unfilter_row(kind, rows[y, 1:], prior, ch)
    return out.reshape(h, w, ch)


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8: grey replicated, alpha dropped (the pixels of
    PIL's `Image.convert("RGB")` for these layouts)."""
    img = read_png(path)
    if img.shape[-1] == 1:
        return np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])
