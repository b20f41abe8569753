"""Device ms a frame of the kernels launched inside the program's span
`phase1.interval`: phase 1's interval pass (`kernels/cluster_trace.py`
`_interval_pass_entry`), as `tpu_restir_torch.tracing.span` marks it.
Nothing where the program has no such span."""

from perfbench import program_spans

SPANS = []
read, describe = program_spans.reader("phase1.interval")
