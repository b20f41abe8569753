"""Kernel launches a traced frame: the kernels on the traced timeline
over the frames traced."""

SPANS = []


def read(trace):
    dev = trace.device
    if not dev.kernels or dev.units <= 0:
        return None
    return len(dev.kernels) / dev.units
