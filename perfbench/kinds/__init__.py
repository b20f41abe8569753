"""The traffic kinds: `<kind>.py` here runs every traffic mix whose file
says `"kind": "<kind>"`, found by that name (`harness.kind_module`). Each
has `run(cell, seeds, seconds, device, size, tracing, t_start)`, which
sets up the port, drives the window and returns a `window.Outcome`."""
