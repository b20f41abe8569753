"""Checkpoint and resume of progressive renders (counterpart of
`tpu_restir.io.checkpoint`).

The resumable state is the accumulator, the frame counters, the render
time and the ReSTIR state (last frame's reservoirs and G-buffer), written
with one np.savez under the JAX package's keys: `accumulator`, `acc_ctr`,
`frame_ctr`, `render_time`, and, for the ReSTIR integrator, `restir_0`
... `restir_{n-1}` with `restir_n`, the RestirState leaves in the JAX
pytree's order (the dataclass fields depth first, in declaration order).
The naive and NEE path tracers hold no ReSTIR state: their checkpoints
have no `restir_*` keys, and a renderer of theirs ignores those keys, as
the JAX package does. So a checkpoint of either package resumes in the
other. The port also writes `moment2`, the
luminance second moment that guides the SVGF denoiser (the JAX package
does not save it, so after its resume the variance estimate is 0 and the
filter passes the image through); a checkpoint without it resumes with a
zero moment, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch


def _leaves(obj):
    """Tensor leaves of a dataclass tree, fields depth first."""
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in _leaves(getattr(obj, f.name))]
    return [obj]


def _rebuild(obj, leaves):
    """The dataclass tree obj with its leaves replaced, in _leaves order."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), leaves)
            for f in dataclasses.fields(obj)})
    return leaves.pop(0)


def save(renderer, path: str) -> None:
    flat = {"accumulator": renderer.accumulator.cpu().numpy(),
            "moment2": renderer.moment2.cpu().numpy(),
            "acc_ctr": np.asarray(renderer.acc_ctr),
            "frame_ctr": np.asarray(renderer.frame_ctr),
            "render_time": np.asarray(renderer.render_time)}
    if renderer._restir_state is not None:
        leaves = _leaves(renderer._restir_state)
        for i, leaf in enumerate(leaves):
            flat[f"restir_{i}"] = leaf.cpu().numpy()
        flat["restir_n"] = np.asarray(len(leaves))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def try_restore(renderer, path: str) -> bool:
    """Load path (or path.npz) into renderer if it exists -> whether it
    did."""
    p = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(p) and not os.path.exists(path):
        return False
    dev = renderer.device
    with np.load(p if os.path.exists(p) else path) as data:
        renderer.accumulator = torch.from_numpy(data["accumulator"]).to(dev)
        renderer.moment2 = (torch.from_numpy(data["moment2"]).to(dev)
                            if "moment2" in data
                            else torch.zeros_like(renderer.moment2))
        renderer.acc_ctr = int(data["acc_ctr"])
        renderer.frame_ctr = int(data["frame_ctr"])
        renderer.render_time = float(data["render_time"])
        # resume wall-clock accounting from the saved total
        renderer._time_base = renderer.render_time
        renderer._t_reset = time.perf_counter()
        if renderer._restir_state is not None and "restir_n" in data:
            n = int(data["restir_n"])
            state = renderer._restir_state
            if n != len(_leaves(state)):
                raise ValueError(f"checkpoint {p}: {n} ReSTIR state leaves, "
                                 f"the renderer has {len(_leaves(state))}")
            renderer._restir_state = _rebuild(
                state, [torch.from_numpy(data[f"restir_{i}"]).to(dev)
                        for i in range(n)])
    return True
