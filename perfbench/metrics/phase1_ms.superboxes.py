"""Device ms a frame of the kernels launched inside the program's span
`phase1.superboxes`: the supercluster boxes and the scene box that the
clustered traversal's `pack` (`kernels/cluster_trace.py`) builds from the
cluster boxes on every query (`_super_boxes`, then their least and
greatest corner), as `tpu_restir_torch.tracing.span` marks it. At factor
1 only the scene box's two reductions run. Nothing where the program has
no such span."""

from perfbench import program_spans

SPANS = []
read, describe = program_spans.reader("phase1.superboxes")
