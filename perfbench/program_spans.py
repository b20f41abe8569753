"""Readers of the program's own spans (`tpu_restir_torch.tracing.span`)
on the traced timeline with CPU activity. The program opens them while a
profiler records, so they land in every profile of a `--trace 1` run;
this timeline exists while some metric of the cell wraps a function of
the program in a range (a SpanSpec), which opens the CPU+CUDA stage.

A device idle gap is charged to the innermost program range running on
the host at the gap's middle (the latest-started one), or to `(no
program span)`. A program range is any range on the timeline that no
metric's SpanSpec opened: the program's own spans, and those torch opens
itself (the optimizer's). The CPU profiler's own host cost widens these
gaps."""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

NONE = "(no program span)"


def idle_us_by_span(tl, outside=()) -> Dict[str, float]:
    """Device idle microseconds inside the traced window, summed by the
    innermost range at each gap's middle, of the ranges not named in
    `outside` (the metrics' SpanSpec ranges)."""
    busy = tl.busy_intervals()
    gaps = [(b, c) for (_a, b), (c, _d) in zip(busy, busy[1:]) if c > b]
    spans = sorted((s, e, n) for n, rs in tl.ranges.items()
                   if n not in outside for s, e in rs)
    out: Dict[str, float] = {}
    heap: List[Tuple[float, float, str]] = []   # (-start, end, name)
    j = 0
    for b, c in gaps:      # in order, so the middles increase
        mid = 0.5 * (b + c)
        while j < len(spans) and spans[j][0] <= mid:
            heapq.heappush(heap, (-spans[j][0], spans[j][1], spans[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        key = heap[0][2] if heap else NONE
        out[key] = out.get(key, 0.0) + (c - b)
    return out


def describe(traced, name: str) -> str:
    """Span `name` a traced unit: calls, kernels launched, their device
    ms, and the device idle ms charged to it; then the idle ms of every
    program span that has some."""
    tl = traced.spans
    if tl is None:
        return "no timeline with CPU activity in this cell"
    n = max(tl.units, 1)
    ks = tl.kernels_in(name)
    idle = {k: v / 1e3 / n for k, v in idle_us_by_span(
        tl, traced.range_names).items()}
    split = ", ".join(f"{k} {v:.3f}" for k, v in
                      sorted(idle.items(), key=lambda x: -x[1]))
    return (f"{name} a unit: {len(tl.ranges.get(name, [])) / n:g} calls, "
            f"{len(ks) / n:g} launches, kernels "
            f"{sum(k[2] for k in ks) / 1e3 / n:.3f} ms, device idle "
            f"{idle.get(name, 0.0):.3f} ms as the innermost program span; "
            f"device idle ms a unit by innermost program span "
            f"(CPU+CUDA profile): {split}")


def reader(name: str):
    """(read, describe) of the metric of span `name`: the device ms a
    unit of the kernels launched inside it, None where it is absent."""
    return (lambda traced: traced.range_device_ms(name),
            lambda traced: describe(traced, name))
