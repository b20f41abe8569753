"""Device ms a frame of the kernels launched inside the program's span
`phase1.sort`: phase 1's stable sort of the keys
(`kernels/cluster_trace.py` `build_shortlists`), as
`tpu_restir_torch.tracing.span` marks it. Nothing where the program has
no such span."""

from perfbench import program_spans

SPANS = []
read, describe = program_spans.reader("phase1.sort")
