"""The traced part of a `--trace 1` run, read back from torch.profiler's
chrome traces into intervals that the per-layer metric readers reduce.
It runs inside the window, on the window's own units, once a quarter of
the window has passed untraced (whose unit times `idle_percent` reads):

1. a fixed number of units under the profiler with CUDA activity alone
   (kernels, copies and sets, and the runtime calls that launched them):
   the device's busy time, launches, kernel times and the breakdown are
   read from this timeline;
2. as many units again with CPU and CUDA activity, with
   `record_function` ranges wrapped around the program's functions that
   the metrics name (their SPANS), for these units only: the device time
   of the kernels inside each range is read from it, not its gaps, which
   the CPU profiler's own cost widens;
3. one unit more, not profiled, with the metrics' COUNTS wrappers, which
   count the work of each call from its inputs.

A kernel belongs to a range when the host call that launched it (found
by the CUPTI correlation id) lies inside the range.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import heapq
import importlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass(frozen=True)
class SpanSpec:
    """One function of the program to wrap in a range while tracing:
    `module.attr`, the range's name, and optionally a function of the
    call's (args, kwargs) whose result is kept per call."""

    module: str
    attr: str
    name: str
    shape: Optional[Callable] = None


class Spans:
    """Wraps the functions of a set of SpanSpecs in ranges, and puts the
    originals back. A function that no longer exists is noted in
    `missing` (by range name) and left out."""

    def __init__(self, specs, ranges: bool = True):
        self.specs = list(dict.fromkeys(specs))
        self.ranges = ranges
        self.calls: Dict[str, List] = {s.name: [] for s in self.specs}
        self.missing: Dict[str, str] = {}
        self._saved: List[Tuple[object, str, object]] = []

    def install(self) -> None:
        for s in self.specs:
            try:
                mod = importlib.import_module(s.module)
            except ImportError as e:
                self.missing[s.name] = f"{s.module}: {e}"
                continue
            fn = getattr(mod, s.attr, None)
            if not callable(fn):
                self.missing[s.name] = f"{s.module}.{s.attr} does not exist"
                continue
            self._saved.append((mod, s.attr, fn))
            setattr(mod, s.attr, self._wrap(fn, s))

    def _wrap(self, fn, s: SpanSpec):
        log = self.calls[s.name]

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if self.ranges:
                with torch.profiler.record_function(s.name):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if s.shape is not None:
                log.append(s.shape(args, kwargs))
            return out

        return inner

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


@dataclasses.dataclass
class Trace:
    """The traced units' timeline, in microseconds on the trace's clock.

    kernels: (name, device start, duration, host launch time or None);
    device_ops: (name, start, duration) of every kernel, copy and set;
    ranges: range name -> [(host start, host end)];
    host_ops: (name, start, end) of host calls and ranges;
    units: frames or steps traced."""

    kernels: List[Tuple[str, float, float, Optional[float]]]
    device_ops: List[Tuple[str, float, float]]
    ranges: Dict[str, List[Tuple[float, float]]]
    host_ops: List[Tuple[str, float, float]]
    units: int

    # --- the device timeline ----------------------------------------------
    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, sorted."""
        out: List[List[float]] = []
        for _n, s, d in sorted(self.device_ops, key=lambda x: x[1]):
            e = s + d
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    def window_us(self) -> float:
        """First device operation's start to the last one's end."""
        if not self.device_ops:
            return 0.0
        return (max(s + d for _n, s, d in self.device_ops)
                - min(s for _n, s, _d in self.device_ops))

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    # --- ranges -----------------------------------------------------------
    def has_range(self, name: str) -> bool:
        return bool(self.ranges.get(name))

    @staticmethod
    def _union(spans) -> Tuple[List[float], List[float]]:
        """Sorted intervals merged where they overlap or nest -> (starts,
        ends)."""
        starts: List[float] = []
        ends: List[float] = []
        for a, b in sorted(spans):
            if starts and a <= ends[-1]:
                ends[-1] = max(ends[-1], b)
            else:
                starts.append(a)
                ends.append(b)
        return starts, ends

    @staticmethod
    def _inside(t: float, union) -> bool:
        starts, ends = union
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]

    def kernels_in(self, name: str):
        """The kernels launched inside range `name`."""
        host = self._union(self.ranges.get(name, []))
        return [k for k in self.kernels
                if k[3] is not None and self._inside(k[3], host)]

    def range_device_ms(self, name: str) -> Optional[float]:
        """Device time (ms) of the kernels launched inside range `name`, a
        traced unit; None where the range is absent."""
        if not self.has_range(name) or self.units <= 0:
            return None
        return sum(k[2] for k in self.kernels_in(name)) / 1e3 / self.units

    def kernel_ms(self, match: Callable[[str], bool]) -> float:
        """Device time (ms) of the kernels whose name matches, in all."""
        return sum(k[2] for k in self.kernels if match(k[0])) / 1e3

    # --- the breakdown ----------------------------------------------------
    def top_device_ops(self, n: int = 10):
        tot: Dict[str, float] = {}
        for name, _s, d in self.device_ops:
            key = short_name(name)
            tot[key] = tot.get(key, 0.0) + d
        return [[k, v / 1e6] for k, v in
                sorted(tot.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The device's idle gaps inside the window, summed by what the
        host was doing at each gap's middle (the shortest host call or
        range that covers it)."""
        busy = self.busy_intervals()
        host = sorted(self.host_ops, key=lambda x: x[1])
        gaps = [(b, c) for (_a, b), (c, _d) in zip(busy, busy[1:]) if c > b]
        tot: Dict[str, float] = {}
        heap: List[Tuple[float, float, str]] = []   # (-start, end, name)
        j = 0
        for b, c in gaps:     # in order, so the middles increase
            mid = 0.5 * (b + c)
            while j < len(host) and host[j][1] <= mid:
                heapq.heappush(heap, (-host[j][1], host[j][2], host[j][0]))
                j += 1
            # the latest-started call still running is the innermost one
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            key = short_name(heap[0][2]) if heap else "(no host call)"
            tot[key] = tot.get(key, 0.0) + (c - b)
        return [[k, v / 1e6] for k, v in
                sorted(tot.items(), key=lambda x: -x[1])[:n]]


def short_name(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def parse_chrome_trace(doc: dict, units: int) -> Trace:
    """A chrome trace (torch.profiler's `export_chrome_trace`) -> Trace."""
    events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    launches: Dict[int, float] = {}
    raw_kernels = []
    device_ops = []
    ranges: Dict[str, List[Tuple[float, float]]] = {}
    host_ops = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device_ops.append((name, ts, dur))
            if cat == "kernel":
                raw_kernels.append((name, ts, dur, args.get("correlation")))
        elif cat in HOST_CATS:
            host_ops.append((name, ts, ts + dur))
            if cat in ("cuda_runtime", "cuda_driver") \
                    and args.get("correlation") is not None:
                launches.setdefault(int(args["correlation"]), ts)
            if cat == "user_annotation":
                ranges.setdefault(name, []).append((ts, ts + dur))
    kernels = [(n, s, d, None if c is None else launches.get(int(c)))
               for n, s, d, c in raw_kernels]
    return Trace(kernels=kernels, device_ops=device_ops, ranges=ranges,
                 host_ops=host_ops, units=units)


@dataclasses.dataclass
class Traced:
    """The traced units of a `--trace 1` run: `device`, the CUDA-only
    timeline; `spans`, the timeline with the metrics' ranges (None where
    no metric has one); `counts`, range name -> the COUNTS wrappers'
    records over `count_units` units; `missing`, range name -> why its
    function was not there; `stages`, the host seconds of each stage;
    `period_ms`, the mean device time a unit of the same window's units
    before the traced ones (its CUDA events), set once the window has
    closed; `range_names`, the metrics' ranges."""

    device: Trace
    spans: Optional[Trace]
    counts: Dict[str, List]
    count_units: int
    missing: Dict[str, str]
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    period_ms: float = 0.0
    range_names: List[str] = dataclasses.field(default_factory=list)

    def range_device_ms(self, name: str) -> Optional[float]:
        if self.spans is None or name in self.missing:
            return None
        return self.spans.range_device_ms(name)

    def describe(self) -> str:
        """One line for standard error: the device timeline, and on the
        ranges' timeline each range's calls and the kernels whose launch
        the trace does not hold (no range can claim them)."""
        dev = self.device
        span = dev.window_us() / 1e3 / max(dev.units, 1)
        out = (f"{dev.units} units, busy "
               f"{dev.busy_us() / 1e3 / max(dev.units, 1):.3f} ms and "
               f"traced span {span:.3f} ms a unit, untraced period "
               f"{self.period_ms:.3f} ms, idle {idle_percent(self)}%; "
               f"stages (s) "
               + ", ".join(f"{k} {v:.3f}" for k, v in self.stages.items()))
        if self.spans is not None:
            sp = self.spans
            lost = sum(k[3] is None for k in sp.kernels)
            out += (f"; ranges' timeline: {lost} of {len(sp.kernels)} "
                    f"kernels without a launch, calls "
                    + ", ".join(f"{n} {len(sp.ranges.get(n, []))}"
                                for n in self.range_names))
        return out


def idle_percent(traced: Traced) -> Optional[float]:
    """The device_idle metrics, in %: 1 - the device's busy time a traced
    unit (the union of kernel, copy and set intervals on the CUDA-only
    timeline) over the device time a unit of the same window's units
    before the traced ones. The traced span is not the denominator: the
    profiler's host cost lengthens it, by 1% to 50% a unit from run to
    run where the host sets the pace."""
    dev = traced.device
    if traced.period_ms <= 0 or dev.units <= 0 or not dev.device_ops:
        return None
    return 100.0 * (1.0 - dev.busy_us() / 1e3 / dev.units / traced.period_ms)


def _profile(run_unit, units: int, activities, sync) -> Trace:
    """run_unit() `units` times under the profiler; the device is drained
    after them, before the profiler stops."""
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        for _ in range(units):
            run_unit()
        sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return parse_chrome_trace(doc, units)


def capture(run_unit: Callable[[], None], units: int, span_specs,
            count_specs, sync: Callable[[], None]) -> Traced:
    """Runs run_unit() `units` times under the CUDA-only profile, then
    `units` times under the full profile with the span ranges installed
    (where there are any), then once with the counting wrappers installed
    (where there are any). The trace files go to the temporary directory
    and are removed."""
    from torch.profiler import ProfilerActivity
    stages: Dict[str, float] = {}
    t = time.perf_counter()
    sync()
    device = _profile(run_unit, units, [ProfilerActivity.CUDA], sync)
    stages["cuda_only"] = time.perf_counter() - t
    missing: Dict[str, str] = {}
    spans = None
    if span_specs:
        t = time.perf_counter()
        sp = Spans(span_specs)
        sp.install()
        try:
            spans = _profile(run_unit, units,
                             [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             sync)
        finally:
            sp.remove()
        missing.update(sp.missing)
        stages["with_ranges"] = time.perf_counter() - t
    counts: Dict[str, List] = {}
    count_units = 0
    if count_specs:
        t = time.perf_counter()
        cp = Spans(count_specs, ranges=False)
        cp.install()
        try:
            run_unit()
            sync()
        finally:
            cp.remove()
        counts, count_units = cp.calls, 1
        missing.update(cp.missing)
        stages["counted"] = time.perf_counter() - t
    return Traced(device=device, spans=spans, counts=counts,
                  count_units=count_units, missing=missing, stages=stages,
                  range_names=[s.name for s in span_specs or []])
