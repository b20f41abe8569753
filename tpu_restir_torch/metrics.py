"""Image statistics, per-pass timing and the analytic ray count of a
ReSTIR frame."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Dict, List

import torch

from tpu_restir_torch import tracing


def image_mean_variance(img):
    """Mean and variance of the per-pixel channel mean (the reference's
    image statistics, pg/simpleguidx11.cpp:308-329)."""
    pix = torch.mean(img, dim=-1)
    mean = torch.mean(pix)
    return mean, torch.mean(pix * pix) - mean * mean


def sync(obj) -> None:
    """Wait for the CUDA devices of the tensors in obj (a tensor, a tuple
    or list, or a dataclass of them): the counterpart of
    jax.block_until_ready."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            sync(x)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            sync(getattr(obj, f.name))


class PassTimers:
    """Per-pass timers (reference pg/simpleguidx11.h:120-127) read from
    the ReSTIR frame's own spans: inside `frame()` each `restir.<pass>`
    span (`tracing.span`) is timed by a CUDA event pair on a CUDA
    device, by the host clock otherwise, with no synchronize. A frame's
    readings are resolved when `mean_ms` is read, or once its last event
    has completed; a pass run more than once a frame (the spatial
    passes) is summed over the frame."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.durations: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._frames: List[Dict[str, list]] = []   # not yet resolved

    def record(self, name: str, seconds: float) -> None:
        """Add one measured duration of a pass."""
        self.durations[name] = self.durations.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def frame(self):
        """Time the `restir.*` spans of the frame run inside."""
        marks: Dict[str, list] = {}
        with tracing.collecting(functools.partial(self._span, marks)):
            yield
        self._frames.append(marks)
        self._resolve(wait=False)

    @contextlib.contextmanager
    def _span(self, marks, name: str):
        if not name.startswith("restir."):
            yield
            return
        start = self._mark()
        yield
        marks.setdefault(name[len("restir."):], []).append(
            (start, self._mark()))

    def _mark(self):
        if self.device is not None and self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def _resolve(self, wait: bool) -> None:
        """Record the frames whose events have completed (all, waiting
        for them, with wait), in order."""
        while self._frames:
            marks = self._frames[0]
            ends = [b for pairs in marks.values() for _a, b in pairs]
            if not wait and not all(isinstance(b, float) or b.query()
                                    for b in ends):
                return
            self._frames.pop(0)
            for name, pairs in marks.items():
                self.record(name, sum(_seconds(a, b) for a, b in pairs))

    def mean_ms(self) -> Dict[str, float]:
        """Average per-frame milliseconds per pass."""
        self._resolve(wait=True)
        return {k: 1e3 * v / max(self.counts.get(k, 1), 1)
                for k, v in self.durations.items()}


def _seconds(start, end) -> float:
    if isinstance(start, float):
        return end - start
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def rays_per_pixel(cfg) -> int:
    """Closest-hit + occlusion queries per pixel per frame for this config
    (the reference's per-pass trace counts, SURVEY.md §3.2); the count of
    the repository's bench.py."""
    r = cfg.restir
    test_vis = 0 if r.do_visibility_pass else 1
    closest = 1 + r.m_brdf                      # G-buffer + BRDF candidates
    occl = (r.m_area + r.m_brdf + 1) * test_vis  # initial p_hats + finalize
    occl += 1 if r.do_visibility_pass else 0
    if r.do_temporal_reuse:
        occl += 5                                # 4 MIS p_hats + finalize
    if r.do_spatial_reuse:
        k = r.spatial_neighbor_count
        if r.spatial_mis == "balance":
            per_pass = (k + 1) ** 2 + 1
        elif r.spatial_mis == "pairwise":
            per_pass = 3 * k + 2
        else:
            per_pass = (k + 1) + 1
        occl += per_pass * r.spatial_pass_count
    occl += 1                                    # final shading visibility
    return closest + occl
