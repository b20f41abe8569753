"""Clusters listed a packet by the clustered traversal's phase 1: the
(packet, cluster) pairs that pass its culls over the packets built, as
`kernels/cluster_trace.py` `pack` counts them (`phase1.listed`,
`phase1.packets`) through `tpu_restir_torch.tracing.count`, over the
counted unit (not profiled). Each call is observed by wrapping `count`;
a tensor count is summed here. Nothing where the program has no such
counter."""

from perfbench.trace import SpanSpec

SPANS = []


def _shape(args, kwargs):
    name, value = args[:2]
    return (name, float(value.sum()) if hasattr(value, "sum")
            else float(value))


COUNTS = [SpanSpec("tpu_restir_torch.tracing", "count", "count.shortlist",
                   _shape)]


def _totals(trace):
    out = {}
    for name, value in trace.counts.get("count.shortlist", []):
        if name.startswith("phase1."):
            out[name] = out.get(name, 0.0) + value
    return out


def read(trace):
    t = _totals(trace)
    if t.get("phase1.packets", 0.0) <= 0:
        return None
    return t.get("phase1.listed", 0.0) / t["phase1.packets"]


def describe(trace):
    t = _totals(trace)
    n = max(trace.count_units, 1)
    listed, pairs = t.get("phase1.listed", 0.0), t.get("phase1.pairs", 0.0)
    return (f"phase 1 a unit: {t.get('phase1.packets', 0.0) / n:g} packets, "
            f"{pairs / n:g} pairs tested, {listed / n:g} listed; cull "
            f"ratio listed / tested "
            f"{listed / pairs if pairs else float('nan'):.6f}")
