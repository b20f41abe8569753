"""K1/K2's share of their roofline a frame, in %: the least time at the
H100's published peaks (`perfbench/roofline.py`) of the work the frame's
queries need, over the device time of the K1 and K2 kernels
(`closest_kernel`, `any_kernel` of `csrc/ray_tri.cu`) a frame on the
CUDA-only timeline.

The work is counted on the frame after the traced ones, from each call's
own rays and triangles (`ray_tri.closest_hit` / `any_hit`): a (ray,
triangle) pair costs the Woop test up to the stage that rules it out (t
outside the ray's interval: 13 operations; u outside [0, 1]: 26; else
the whole 40), and an occlusion ray stops at its first hit in the
scene's order. Each input byte is read once (rays, the Woop maps) and
each output byte written once. Each call is ruled by operations or by
bytes, whichever is slower."""

import re

import torch

from perfbench import roofline
from perfbench.refrender.render.intersect import woop_tuvok
from perfbench.refrender.scene.scene import build_woop_matrices
from perfbench.trace import SpanSpec

_CHUNK = 1 << 15
_BARY_EPS = 1e-5
_NAME = re.compile(r"\b(closest|any)_kernel\b")


def _needed_ops(kind, scene, o, d, tn, tf) -> float:
    """Operations the call's pairs need (see the module's text)."""
    w = torch.tensor(build_woop_matrices(scene.tri_v.detach().cpu().numpy()),
                     device=o.device).reshape(-1, 12)
    total = 0
    with torch.no_grad():
        for s in range(0, o.shape[0], _CHUNK):
            sl = slice(s, s + _CHUNK)
            t, u, _v, ok = woop_tuvok(o[sl].detach(), d[sl].detach(),
                                      tn[sl].detach(), tf[sl].detach(), w)
            t_ok = torch.isfinite(t) & (t >= tn[sl, None]) \
                & (t <= tf[sl, None])
            u_ok = t_ok & (u >= -_BARY_EPS) & (u <= 1.0 + _BARY_EPS)
            ops = 13 + 13 * t_ok.to(torch.int64) + 14 * u_ok.to(torch.int64)
            if kind == "any":
                cols = torch.arange(w.shape[0], device=o.device)[None]
                first = torch.where(ok.any(1), ok.to(torch.int8).argmax(1),
                                    w.shape[0] - 1)
                ops = torch.where(cols <= first[:, None], ops, 0)
            total += int(ops.sum())
    return float(total)


def _counter(kind):
    def count(args, kwargs):
        scene, o, d, tn, tf = args[:5]
        return (kind, int(o.shape[0]), int(scene.num_tris),
                _needed_ops(kind, scene, o, d, tn, tf))
    return count


_MOD = "tpu_restir_torch.kernels.ray_tri"
SPANS = []
COUNTS = [SpanSpec(_MOD, "closest_hit", "raytri.closest", _counter("closest")),
          SpanSpec(_MOD, "any_hit", "raytri.any", _counter("any"))]


def _bound(trace):
    """(least seconds a frame, of it ruled by operations, by bytes)."""
    total = by_ops = by_bytes = 0.0
    for name in ("raytri.closest", "raytri.any"):
        for kind, n_rays, n_tris, ops in trace.counts.get(name, []):
            nbytes = roofline.fused_query(kind, n_rays, n_tris)[1]
            t, rule = roofline.bound_s(ops, nbytes)
            total += t
            if rule == "operations":
                by_ops += t
            else:
                by_bytes += t
    n = max(trace.count_units, 1)
    return total / n, by_ops / n, by_bytes / n


def _measured_s(trace):
    dev = trace.device
    if dev.units <= 0:
        return 0.0
    return dev.kernel_ms(lambda n: bool(_NAME.search(n))) / 1e3 / dev.units


def read(trace):
    measured, (bound, _o, _b) = _measured_s(trace), _bound(trace)
    if measured <= 0 or bound <= 0:
        return None
    return 100.0 * bound / measured


def describe(trace):
    bound, by_ops, by_bytes = _bound(trace)
    calls = sum(len(trace.counts.get(r, []))
                for r in ("raytri.closest", "raytri.any"))
    return (f"K1/K2 a frame: {calls} calls counted, kernels "
            f"{_measured_s(trace) * 1e3:.6f} ms, bound {bound * 1e3:.6f} ms "
            f"({by_ops * 1e3:.6f} ms of it ruled by operations, "
            f"{by_bytes * 1e3:.6f} by bytes)")
