"""Device ms a frame of the kernels launched inside the G-buffer pass
(`restir/gbuffer.py` `gbuffer_fill`, where the ReSTIR frame's `calc_i_m`
runs)."""

from perfbench.trace import SpanSpec

SPANS = [SpanSpec("tpu_restir_torch.render.integrators.restir.gbuffer",
                  "gbuffer_fill", "pass.gbuffer")]


def read(trace):
    return trace.range_device_ms("pass.gbuffer")
