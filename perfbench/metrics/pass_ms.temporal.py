"""Device ms a frame of the kernels launched inside the program's span
`restir.temporal`: the temporal reuse pass (`restir/temporal.py`
`temporal_pass`), as `tpu_restir_torch.tracing.span` marks it. Nothing
where the program has no such span."""

from perfbench import program_spans

SPANS = []
read, describe = program_spans.reader("restir.temporal")
