"""Radiance RGBE (.hdr) reader, the port's own, as `io.png` is for PNG.

Reads what Greg Ward's `rgbe.c` writes: a `#?RADIANCE` or `#?RGBE` header
with `FORMAT=32-bit_rle_rgbe`, the `-Y H +X W` orientation (rows top-down,
columns left to right), and scanlines that are flat or new-style run-length
encoded (each scanline starts 2, 2, W >> 8, W & 255 and holds the four
byte planes, each as runs of 128 + n copies or literal spans of n <= 128).
A pixel (m_r, m_g, m_b, e) is radiance ldexp(m + 0.5, e - 136), and black
where e == 0. Any other layout or format raises, naming the file.
"""

from __future__ import annotations

import re

import numpy as np

_RES = re.compile(rb"-Y (\d+) \+X (\d+)")


def read_hdr(path: str) -> np.ndarray:
    """(H, W, 3) float32 radiance of a Radiance RGBE file."""
    with open(path, "rb") as f:
        data = f.read()

    def fail(msg):
        raise ValueError(f"{path}: {msg}")

    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        fail("not a Radiance RGBE file (no #?RADIANCE or #?RGBE)")
    end = data.find(b"\n\n")
    if end < 0:
        fail("header has no end")
    fmt = None
    for line in data[:end].split(b"\n")[1:]:
        if line.startswith(b"FORMAT="):
            fmt = line[len(b"FORMAT="):].strip()
    if fmt != b"32-bit_rle_rgbe":
        fail(f"unsupported FORMAT {fmt!r} (only 32-bit_rle_rgbe is read)")
    nl = data.find(b"\n", end + 2)
    m = _RES.fullmatch(data[end + 2:nl].strip()) if nl > 0 else None
    if m is None:
        fail("unsupported resolution line (only '-Y H +X W' is read)")
    h, w = int(m.group(1)), int(m.group(2))
    rgbe = _pixels(data, nl + 1, h, w, fail)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0)
    img = (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]
    return img.astype(np.float32)


def _pixels(data: bytes, pos: int, h: int, w: int, fail) -> np.ndarray:
    """(h, w, 4) uint8 RGBE from the scanlines at data[pos:]."""
    out = np.empty((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(h):
        head = data[pos:pos + 4]
        if len(head) < 4:
            fail(f"truncated at scanline {y}")
        if not (8 <= w < 0x8000 and head[0] == 2 and head[1] == 2
                and not head[2] & 0x80):
            # flat: this and every later scanline are plain RGBE quads
            n = (h - y) * w * 4
            if len(data) - pos < n:
                fail(f"truncated flat pixels from scanline {y}")
            out[y:] = buf[pos:pos + n].reshape(h - y, w, 4)
            return out
        if (head[2] << 8) | head[3] != w:
            fail(f"scanline {y} has width {(head[2] << 8) | head[3]}, "
                 f"not {w}")
        pos += 4
        for c in range(4):
            x = 0
            while x < w:
                if pos >= len(data):
                    fail(f"truncated run at scanline {y}")
                count = data[pos]
                if count > 128:
                    count -= 128
                    if x + count > w or pos + 1 >= len(data):
                        fail(f"bad run at scanline {y}")
                    out[y, x:x + count, c] = data[pos + 1]
                    pos += 2
                else:
                    if count == 0 or x + count > w \
                            or pos + 1 + count > len(data):
                        fail(f"bad literal span at scanline {y}")
                    out[y, x:x + count, c] = buf[pos + 1:pos + 1 + count]
                    pos += 1 + count
                x += count
    return out
