"""Device ms a frame of the kernels launched inside the program's span
`phase1.keys`: phase 1's sort keys by K9 on CUDA tensors
(`kernels/cluster_trace.py` `packet_keys`, `csrc/cluster_trace.cu`
`shortlist_keys_kernel`), as `tpu_restir_torch.tracing.span` marks it.
Nothing where the program has no such span."""

from perfbench import program_spans

SPANS = []
read, describe = program_spans.reader("phase1.keys")
