"""Cluster slots a closest-hit packet that K5 (`csrc/cluster_trace.cu`)
staged in shared memory and tested, after its early exit and its mode-5
slab vote: the slots every closest-hit launch wrote (`phase2.staged`, a
tensor count summed here) over the packets launched
(`phase2.closest_packets`), as `kernels/cluster_trace.py` `_launch`
counts them, in the counted unit (not profiled). `describe` prints it
against the clusters listed a packet (`shortlist_mean.frame`'s reading)
and the slots given a packet (`slots_mean.frame`'s: at factor F > 1 a
listed supercluster gives F slots), and the closest-hit launches that
cull in mode 5. Each call is observed by wrapping
`tpu_restir_torch.tracing.count`. Nothing where the program has no such
counter."""

from perfbench.trace import SpanSpec

SPANS = []


def _shape(args, kwargs):
    name, value = args[:2]
    return (name, float(value.sum()) if hasattr(value, "sum")
            else float(value))


COUNTS = [SpanSpec("tpu_restir_torch.tracing", "count", "count.staged",
                   _shape)]


def _totals(trace):
    out = {}
    for name, value in trace.counts.get("count.staged", []):
        out[name] = out.get(name, 0.0) + value
    return out


def read(trace):
    t = _totals(trace)
    if t.get("phase2.closest_packets", 0.0) <= 0 \
            or "phase2.staged" not in t:
        return None
    return t["phase2.staged"] / t["phase2.closest_packets"]


def describe(trace):
    t = _totals(trace)
    n = max(trace.count_units, 1)
    packets = t.get("phase2.closest_packets", 0.0)
    staged = t.get("phase2.staged", 0.0)
    all_packets = t.get("phase1.packets", 0.0)

    def per_packet(name):
        return t.get(name, 0.0) / all_packets if all_packets \
            else float("nan")

    return (f"closest hit a unit: {staged / n:g} slots staged over "
            f"{packets / n:g} packets, "
            f"{staged / packets if packets else float('nan'):g} a packet, "
            f"against {per_packet('phase1.listed'):g} clusters listed and "
            f"{per_packet('phase2.slots'):g} slots given a packet (every "
            f"query); launches culled in mode 5: "
            f"{t.get('cull.trace_closest', 0.0) / n:g} of "
            f"{t.get('launch.trace_closest', 0.0) / n:g}")
