"""Device ms a frame of the kernels launched inside `calc_i_m` as the
path tracers' BRDF calls it (`render/brdf.py`, from
`mathx/special.calc_i_m`)."""

from perfbench.trace import SpanSpec

SPANS = [SpanSpec("tpu_restir_torch.render.brdf", "calc_i_m", "calc_i_m")]


def read(trace):
    return trace.range_device_ms("calc_i_m")
