"""Cluster slots a packet that phase 2 (K5/K6, `csrc/cluster_trace.cu`)
is given: each listed supercluster expands to `factor` consecutive
clusters, so the slots are the listed pairs times the supercluster
factor, as `kernels/cluster_trace.py` `pack` counts them
(`phase2.slots`, a tensor count summed here), over the packets built
(`phase1.packets`), in the counted unit (not profiled). At factor 1 it
equals `shortlist_mean.frame`. `describe` adds the kernel launches that
cull in mode 5, the per-ray slab test of each slot's box (`cull.*`).
Each call is observed by wrapping `tpu_restir_torch.tracing.count`.
Nothing where the program has no such counter."""

from perfbench.trace import SpanSpec

SPANS = []


def _shape(args, kwargs):
    name, value = args[:2]
    return (name, float(value.sum()) if hasattr(value, "sum")
            else float(value))


COUNTS = [SpanSpec("tpu_restir_torch.tracing", "count", "count.slots",
                   _shape)]


def _totals(trace):
    out = {}
    for name, value in trace.counts.get("count.slots", []):
        out[name] = out.get(name, 0.0) + value
    return out


def read(trace):
    t = _totals(trace)
    if t.get("phase1.packets", 0.0) <= 0 or "phase2.slots" not in t:
        return None
    return t["phase2.slots"] / t["phase1.packets"]


def describe(trace):
    t = _totals(trace)
    n = max(trace.count_units, 1)
    return (f"phase 2 a unit: {t.get('phase2.slots', 0.0) / n:g} slots "
            f"over {t.get('phase1.packets', 0.0) / n:g} packets; launches "
            f"culled in mode 5: closest hit (K5) "
            f"{t.get('cull.trace_closest', 0.0) / n:g} of "
            f"{t.get('launch.trace_closest', 0.0) / n:g}, any hit (K6) "
            f"{t.get('cull.trace_any', 0.0) / n:g} of "
            f"{t.get('launch.trace_any', 0.0) / n:g}")
