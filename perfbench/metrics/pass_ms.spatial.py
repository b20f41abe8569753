"""Device ms a frame of the kernels launched inside the spatial reuse
pass (`restir/spatial.py` `spatial_pass`, called by the pipeline)."""

from perfbench.trace import SpanSpec

SPANS = [SpanSpec("tpu_restir_torch.render.integrators.restir.pipeline",
                  "spatial_pass", "pass.spatial")]


def read(trace):
    return trace.range_device_ms("pass.spatial")
