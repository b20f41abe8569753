"""The port's spans and counters, in one place.

`span(name)` marks a part of the work: the frame (`frame`, the body of
`Renderer.step`), each ReSTIR pass (`restir.*`, `restir_step`) and the
parts of the clustered traversal's phase 1 (`phase1.*`,
`kernels/cluster_trace.py`). While torch.profiler records, a span is a
`record_function` range, so it lands in the profiler's trace on the clock
of its kernel and runtime records; while a pass collector is active
(`collecting`, the per-pass timers of `profile_passes`), the collector
sees it too. Otherwise it is a shared null context, after two flag reads.

`count(name, value)` is the one counter registry, `COUNTS`: kernel
launches of the CUDA wrappers (`launch.*`, each read 0 from the import
of its module), the clustered kernels' launches that cull in mode 5
(`cull.*`), host reads of the plain backends' loop conditions
(`sync.*`), phase 1's shortlists (`phase1.*`), the slots phase 2 is
given (`phase2.slots`), and the slots the closest-hit kernels staged
over their packets (`phase2.staged`, `phase2.closest_packets`), and the
rays of every intersection query (`rays.<kind>.<backend>`, one count a
query, `render/intersect.py`). An int value is always added. A tensor
value, a count that lives on the device, is never touched here, so it
launches nothing and waits for nothing: callers look `count` up on this
module at each call, so a wrapper put in its place sees every call and
may sum it.

`recording()` reads what one block of work counted, call by call: it
yields a list, and every `count(name, value)` inside the block appends
(name, value) to it, a tensor value as it is. The ray census of a frame
is its `rays.` entries, one a query in query order
(`intersect.queries`, `roofline.summarize_query_log`).
"""

from __future__ import annotations

import collections
import contextlib

import torch
from torch.autograd import profiler as _profiler

COUNTS: collections.Counter = collections.Counter()

_NULL = contextlib.nullcontext()
_collector = None   # callable(name) -> context manager, or None
_recording = None   # the list of the open recording(), or None


def span(name: str):
    """A context manager around one part of the work (see the module's
    text)."""
    if _collector is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _recorded(name)


@contextlib.contextmanager
def _recorded(name: str):
    with contextlib.ExitStack() as stack:
        if _profiler._is_profiler_enabled:
            stack.enter_context(torch.profiler.record_function(name))
        if _collector is not None:
            stack.enter_context(_collector(name))
        yield


def count(name: str, value) -> None:
    """Add an int value to COUNTS[name]; leave a tensor value untouched;
    append (name, value) to the open recording (see the module's text)."""
    if isinstance(value, int):
        COUNTS[name] += value
    if _recording is not None:
        _recording.append((name, value))


def counted(prefix: str) -> dict:
    """The counts whose names start with prefix, as a dict."""
    return {k: v for k, v in COUNTS.items() if k.startswith(prefix)}


@contextlib.contextmanager
def collecting(collector):
    """Make collector(name), a context manager, enter every span opened
    inside this block."""
    global _collector
    prev, _collector = _collector, collector
    try:
        yield
    finally:
        _collector = prev


@contextlib.contextmanager
def recording():
    """Yield a list of the (name, value) of every count() call inside this
    block, in call order; inside a recording opened within it, that one
    gets them."""
    global _recording
    rec = []
    prev, _recording = _recording, rec
    try:
        yield rec
    finally:
        _recording = prev
