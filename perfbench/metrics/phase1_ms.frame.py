"""Device ms a frame of the kernels launched inside the clustered
traversal's phase 1 (`kernels/cluster_trace.py` `pack`, which clamps the
rays and builds the packets' shortlists by `build_shortlists`)."""

from perfbench.trace import SpanSpec

SPANS = [SpanSpec("tpu_restir_torch.kernels.cluster_trace", "pack",
                  "phase1.pack")]


def read(trace):
    return trace.range_device_ms("phase1.pack")
