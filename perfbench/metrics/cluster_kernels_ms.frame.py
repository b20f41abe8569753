"""Device ms a frame of K5 and K6 (`csrc/cluster_trace.cu`,
`trace_kernel<true, false>` and `trace_kernel<false, false>`); nothing
where no such kernel ran."""

import re

SPANS = []
_NAME = re.compile(r"trace_kernel<\s*(true|false)\s*,\s*false\s*>")


def read(trace):
    dev = trace.device
    if dev.units <= 0 or not any(_NAME.search(k[0]) for k in dev.kernels):
        return None
    return dev.kernel_ms(lambda n: bool(_NAME.search(n))) / dev.units
