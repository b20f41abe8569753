"""Device ms a step of the kernels launched inside the gradient step's
backward call (`harness.backward`: autograd through the frame, with K4 as
the tap gather's transpose)."""

from perfbench.trace import SpanSpec

SPANS = [SpanSpec("perfbench.harness", "backward", "perfbench.backward")]


def read(trace):
    return trace.range_device_ms("perfbench.backward")
