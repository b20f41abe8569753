"""Device ms a frame of the kernels launched inside the threefry draws
(`rng.py` `uniform`)."""

from perfbench.trace import SpanSpec

SPANS = [SpanSpec("tpu_restir_torch.rng", "uniform", "rng.uniform")]


def read(trace):
    return trace.range_device_ms("rng.uniform")
