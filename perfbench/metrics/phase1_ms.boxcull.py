"""Device ms a frame of the kernels launched inside the program's span
`phase1.boxcull`: phase 1's swept sub-box cull
(`kernels/cluster_trace.py` `box_overlap` and its mask), as
`tpu_restir_torch.tracing.span` marks it. Nothing where the program has
no such span."""

from perfbench import program_spans

SPANS = []
read, describe = program_spans.reader("phase1.boxcull")
