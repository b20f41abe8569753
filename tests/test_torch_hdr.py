"""The port's Radiance RGBE reader (`tpu_restir_torch.io.hdr`), through
`envmap.load_hdr`: hand-written flat and run-length-encoded files with
radiance above 1.0 load as float32 radiance, equal to the exact RGBE
decode ldexp(m + 0.5, e - 136) (e == 0 black), and to OpenCV's reader
where cv2 is installed (OpenCV decodes m * 2^(e - 136), without the half
step, so the two differ by exactly 2^(e - 137) on every lit channel).
Other orientations and formats raise, naming the file."""

import math

import numpy as np
import pytest

from tpu_restir_torch.scene.envmap import load_hdr


def _rgbe(rgb):
    """Greg Ward's float2rgbe."""
    v = max(rgb)
    if v < 1e-32:
        return [0, 0, 0, 0]
    m, e = math.frexp(v)
    s = m * 256.0 / v
    return [int(c * s) for c in rgb] + [e + 128]


def _decode(q):
    """The exact decode of (h, w, 4) RGBE bytes."""
    q = np.asarray(q, np.int64)
    f = np.where(q[..., 3] > 0,
                 np.ldexp(1.0, (q[..., 3] - 136).astype(np.int32)), 0.0)
    return ((q[..., :3] + 0.5) * f[..., None]).astype(np.float32)


def _header(h, w, res=None, fmt=b"32-bit_rle_rgbe"):
    return (b"#?RADIANCE\n# written by hand\nFORMAT=" + fmt
            + b"\nEXPOSURE=1.0\n\n"
            + (res or f"-Y {h} +X {w}".encode()) + b"\n")


def _rle_plane(vals):
    """One byte plane of a new-style RLE scanline: runs of 3 or more equal
    bytes as 128 + n, the rest as literal spans."""
    out, i, n = bytearray(), 0, len(vals)
    while i < n:
        j = i
        while j < n and vals[j] == vals[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, vals[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (
                k + 2 < n and vals[k] == vals[k + 1] == vals[k + 2]):
            k += 1
        out += bytes([k - i]) + bytes(vals[i:k])
        i = k
    return bytes(out)


def _write_flat(path, quads, **kw):
    q = np.asarray(quads, np.uint8)
    path.write_bytes(_header(*q.shape[:2], **kw) + q.tobytes())


def _write_rle(path, quads):
    q = np.asarray(quads, np.uint8)
    h, w = q.shape[:2]
    body = b""
    for y in range(h):
        body += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            body += _rle_plane(list(q[y, :, c]))
    path.write_bytes(_header(h, w) + body)


# two pixels above 1.0, black and a dim one
_PIXELS = [(1.0, 0.5, 0.25), (4.0, 2.0, 1.0), (0.0, 0.0, 0.0),
           (0.01, 0.02, 0.03)]


def _quads_rle(h=3, w=37):
    """(h, w, 4) RGBE with runs and literal spans in every plane."""
    rng = np.random.default_rng(7)
    q = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        for x in range(w):
            if x < 12:   # a run
                rgb = _PIXELS[y % 2]
            else:
                rgb = tuple(rng.uniform(0.0, 6.0, 3))
            q[y, x] = _rgbe(rgb)
    q[1, w // 2 + 1] = 0   # black
    return q


def _cv2_check(path, got, quads):
    cv2 = pytest.importorskip("cv2")
    ref = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    assert ref is not None and ref.dtype == np.float32
    ref = ref[..., ::-1]
    e = np.asarray(quads)[..., 3].astype(np.int32)
    half = np.where(e > 0, np.ldexp(np.float32(1.0), e - 137), 0.0)
    lit = np.asarray(quads)[..., :3] > 0
    want = np.where(lit, ref + half[..., None], 0.0)
    np.testing.assert_array_equal(np.where(lit, got, 0.0), want)


@pytest.mark.parametrize("layout", ["flat", "rle"])
def test_hdr_sky_loads_radiance(tmp_path, layout):
    path = tmp_path / f"sky_{layout}.hdr"
    if layout == "flat":
        quads = np.asarray([[_rgbe(p) for p in _PIXELS[:2]]], np.uint8)
        _write_flat(path, quads)
    else:
        quads = _quads_rle()
        _write_rle(path, quads)
    got = load_hdr(str(path))
    assert got.dtype == np.float32 and got.shape == quads.shape[:2] + (3,)
    np.testing.assert_array_equal(got, _decode(quads))
    assert got.max() > 1.0
    if layout == "flat":
        # the two pixels, to the half step of their smallest mantissa (32):
        # radiance, not 8-bit display values
        np.testing.assert_allclose(got[0], [_PIXELS[0], _PIXELS[1]],
                                   rtol=1.0 / 64)
    _cv2_check(path, got, quads)


@pytest.mark.parametrize("bad", ["orientation", "format", "width"])
def test_hdr_unsupported_layout_raises(tmp_path, bad):
    path = tmp_path / f"bad_{bad}.hdr"
    quads = _quads_rle(2, 16)
    if bad == "orientation":
        _write_flat(path, quads, res=b"+Y 2 +X 16")
    elif bad == "format":
        _write_flat(path, quads, fmt=b"32-bit_rle_xyze")
    else:
        _write_rle(path, quads)
        data = bytearray(path.read_bytes())
        at = data.index(bytes([2, 2, 0, 16]))
        data[at + 3] = 15   # a scanline that claims another width
        path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=str(path.name)):
        load_hdr(str(path))
