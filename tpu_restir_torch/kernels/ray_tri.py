"""Ray x triangle queries for small scenes: K1 (closest hit) and K2 (any
hit), the counterparts of `tpu_restir.kernels.ray_tri`.

Every ray is tested against every triangle by the Woop affine test
(`kernels/woop.py`). On CUDA tensors the wrappers launch the kernels of
`csrc/ray_tri.cu`; on CPU tensors they take the plain PyTorch versions
`closest_hit_ref` / `any_hit_ref` below, which compute the same test in
the same operation order. Forward only: the analytic closest-hit
derivative of the JAX package comes with the differentiable path
(ROADMAP item 6).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_restir_torch.kernels import build

# kernel launches per wrapper (the plain versions do not count)
LAUNCHES = {"closest_hit": 0, "any_hit": 0}

_BARY_EPS = 1e-5
_REF_CHUNK = 1 << 14   # rays per (rays, tris) broadcast in the plain versions
_P = ctypes.c_void_p


def woop_rows(scene):
    """(T, 12) float32 Woop rows (u, v, w rows of each 3x4 map)."""
    return scene.woop.reshape(scene.num_tris, 12)


def _woop_tuvok(o, d, tn, tf, w):
    """(t, u, v, ok), each (R, T), for rays (R, ...) against rows (T, 12),
    in the operation order of tpu_restir.kernels.ray_tri._woop_tuvok."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]

    def aff(c):
        return ox * w[:, 4 * c] + oy * w[:, 4 * c + 1] \
            + oz * w[:, 4 * c + 2] + w[:, 4 * c + 3]

    def lin(c):
        return dx * w[:, 4 * c] + dy * w[:, 4 * c + 1] + dz * w[:, 4 * c + 2]

    ow, dw = aff(2), lin(2)
    t = torch.where(torch.abs(dw) > 1e-18, -ow / dw, torch.inf)
    u = aff(0) + t * lin(0)
    v = aff(1) + t * lin(1)
    ok = ((u >= -_BARY_EPS) & (v >= -_BARY_EPS)
          & (u + v <= 1.0 + _BARY_EPS) & torch.isfinite(t)
          & (t >= tn[:, None]) & (t <= tf[:, None]))
    return t, u, v, ok


def closest_hit_ref(w, o, d, tnear, tfar):
    """Plain version of K1 -> (t, u, v, tri int32); t = inf and tri = -1
    on a miss. The winner is the first triangle of least t, as the
    kernel's strictly-closer running minimum."""
    n = o.shape[0]
    t_out = torch.full((n,), torch.inf, dtype=torch.float32, device=o.device)
    u_out = torch.zeros((n,), dtype=torch.float32, device=o.device)
    v_out = torch.zeros_like(u_out)
    tri_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for s in range(0, n, _REF_CHUNK):
        e = min(n, s + _REF_CHUNK)
        t, u, v, ok = _woop_tuvok(o[s:e], d[s:e], tnear[s:e], tfar[s:e], w)
        tt = torch.where(ok, t, torch.inf)
        j = torch.argmin(tt, dim=1, keepdim=True)
        hit = torch.any(ok, dim=1)
        t_out[s:e] = torch.where(hit, tt.gather(1, j)[:, 0], torch.inf)
        u_out[s:e] = torch.where(hit, u.gather(1, j)[:, 0], 0.0)
        v_out[s:e] = torch.where(hit, v.gather(1, j)[:, 0], 0.0)
        tri_out[s:e] = torch.where(hit, j[:, 0].to(torch.int32), -1)
    return t_out, u_out, v_out, tri_out


def any_hit_ref(w, o, d, tnear, tfar):
    """Plain version of K2 -> bool occlusion mask."""
    n = o.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for s in range(0, n, _REF_CHUNK):
        e = min(n, s + _REF_CHUNK)
        ok = _woop_tuvok(o[s:e], d[s:e], tnear[s:e], tfar[s:e], w)[3]
        occ[s:e] = torch.any(ok, dim=1)
    return occ


_SIGNATURES = {
    "ray_tri_closest": ([_P] * 5 + [ctypes.c_longlong, ctypes.c_int]
                        + [_P] * 5, ctypes.c_int),
    "ray_tri_any": ([_P] * 5 + [ctypes.c_longlong, ctypes.c_int] + [_P] * 2,
                    ctypes.c_int),
    "ray_tri_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _lib():
    return build.load("ray_tri", _SIGNATURES, extra_flags=["--fmad=false"])


def _check_args(w, o, d, tnear, tfar):
    """Validate the kernel's inputs: one CUDA device, float32, contiguous,
    rays (N, 3) / (N,), rows (T, 12)."""
    n = o.shape[0]
    want = {"w": (w, (w.shape[0], 12)), "o": (o, (n, 3)), "d": (d, (n, 3)),
            "tnear": (tnear, (n,)), "tfar": (tfar, (n,))}
    for name, (x, shape) in want.items():
        if x.device != o.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"ray_tri: {name} must be a contiguous float32 tensor of "
                f"shape {shape} on {o.device}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")


def _launch(kind, w, o, d, tnear, tfar, outs):
    _check_args(w, o, d, tnear, tfar)
    lib = _lib()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        fn = lib.ray_tri_closest if kind == "closest_hit" else lib.ray_tri_any
        err = fn(o.data_ptr(), d.data_ptr(), tnear.data_ptr(),
                 tfar.data_ptr(), w.data_ptr(), o.shape[0], w.shape[0],
                 *[x.data_ptr() for x in outs], stream)
    if err:
        raise RuntimeError(f"ray_tri {kind}: launch failed: "
                           f"{lib.ray_tri_error_string(err).decode()}")
    LAUNCHES[kind] += 1


def _on_cuda(o) -> bool:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ray_tri: unsupported device {o.device}")
    return o.device.type == "cuda"


def closest_hit(scene, o, d, tnear, tfar):
    """K1, closest-hit query -> (t, u, v, tri int32) flat tensors (tri = -1,
    t = inf on a miss). o, d (N, 3); tnear, tfar (N,)."""
    w = woop_rows(scene)
    if not _on_cuda(o):
        return closest_hit_ref(w, o, d, tnear, tfar)
    n = o.shape[0]
    t, u, v = (torch.empty((n,), dtype=torch.float32, device=o.device)
               for _ in range(3))
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n:
        _launch("closest_hit", w, o, d, tnear, tfar, (t, u, v, tri))
    return t, u, v, tri


def any_hit(scene, o, d, tnear, tfar):
    """K2, occlusion query: True where any triangle blocks [tnear, tfar]."""
    w = woop_rows(scene)
    if not _on_cuda(o):
        return any_hit_ref(w, o, d, tnear, tfar)
    occ = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    if o.shape[0]:
        _launch("any_hit", w, o, d, tnear, tfar, (occ,))
    return occ


def supports(scene, max_tris: int = 512) -> bool:
    """Kernel applicability: a small scene."""
    return scene.num_tris <= max_tris
