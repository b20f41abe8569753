"""The pieces that every traffic kind (`perfbench/kinds/<kind>.py`) shares:
the port's objects for a cell, the measured window, the timing events
and the outcome a kind hands back to `perfbench.run`."""

from __future__ import annotations

import dataclasses
import time

import torch

from perfbench import harness

GIB = float(2 ** 30)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def event(device):
    """A timing event on the card; on the CPU (the tests) a host clock
    stand-in with the same method."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return _HostEvent()


class _HostEvent:
    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def interval_ms(events) -> list:
    """Milliseconds between successive events (the first is the window's
    start)."""
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


class Program:
    """The port's objects for one cell: its scene on the device and its
    render settings, from the configuration's raw arrays."""

    def __init__(self, cell, seeds, device, size=None):
        from tpu_restir_torch import config as pcfg
        from tpu_restir_torch.scene.materials import MaterialSpec
        from tpu_restir_torch.scene.scene import build_scene
        if device.type == "cuda":
            from tpu_restir_torch.kernels import build
            build.load_kernels()
        v, m, specs = harness.scene_arrays(cell.config)
        self.scene = build_scene(v, m, [MaterialSpec(**d) for d in specs],
                                 device)
        self.cfg = harness.render_config(pcfg, cell.config, cell.traffic,
                                         seeds.render, size)
        self.device = device


@dataclasses.dataclass
class Window:
    """What the measured window saw: units completed, seconds from its
    first call to the device's end, a timing event before the first unit
    and after each, what `trace` returned and the units it ran
    [first, end)."""

    units: int
    seconds: float
    events: list
    traced: object = None
    traced_units: tuple = (0, 0)

    def unit_ms(self) -> list:
        return interval_ms(self.events)

    def untraced_unit_ms(self) -> list:
        """The unit times before the traced units: once the profiler has
        run, the host pays for it on every launch."""
        ms = self.unit_ms()
        return ms[:self.traced_units[0]] if self.traced is not None else ms


def run_window(unit, seconds: float, device, keep=None,
               trace=None) -> Window:
    """Runs unit(i) for i = 0, 1, ... until `seconds` have passed on the
    host clock, a timing event after each. keep(i, out) sees each unit's
    output. trace(one), where given, runs once at least two units and a
    quarter of the seconds have passed, inside the window: each call
    one() runs the next unit as the loop does (the traced units of a
    `--trace 1` run)."""
    sync(device)
    events = [event(device)]
    t0 = time.perf_counter()
    n = 0

    def one():
        nonlocal n
        out = unit(n)
        events.append(event(device))
        if keep is not None:
            keep(n, out)
        n += 1

    traced, traced_units = None, (0, 0)
    while True:
        elapsed = time.perf_counter() - t0
        if trace is not None and traced is None and n >= 2 \
                and elapsed >= seconds / 4:
            first = n
            traced = trace(one)
            traced_units = (first, n)
            elapsed = time.perf_counter() - t0
        if n >= 1 and elapsed >= seconds \
                and (trace is None or traced is not None):
            break
        one()
    sync(device)
    return Window(n, time.perf_counter() - t0, events, traced, traced_units)


@dataclasses.dataclass
class Outcome:
    """What a traffic kind's run hands back once the port's objects are
    gone: the window's counts and end-to-end numbers, the trace, and a
    function that runs the reference and returns the numbers compared."""

    attempted: int
    failed: int
    e2e: dict
    peak_bytes: int
    traced: object
    numbers: object
    window: Window = None
