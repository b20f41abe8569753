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

A row-sharded renderer writes the same full-height file (its rows
gathered onto rank 0, which writes it; every rank must call `save`), and
each of its ranks restores its own rows of such a file, so a checkpoint
resumes across 1 and N ranks as well as across the two packages. Every
rank must see the same file: a restore that the ranks disagree on raises
on all of them.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tpu_restir_torch.dist import mesh as mesh_mod
from tpu_restir_torch.render.integrators.restir.pipeline import (
    tree_leaves, tree_rebuild)


def save(renderer, path: str) -> None:
    acc = renderer.full_rows(renderer.accumulator)
    m2 = renderer.full_rows(renderer.moment2)
    state = (renderer.full_rows(renderer._restir_state)
             if renderer._restir_state is not None else None)
    if not renderer.is_root:
        return
    flat = {"accumulator": acc.cpu().numpy(),
            "moment2": m2.cpu().numpy(),
            "acc_ctr": np.asarray(renderer.acc_ctr),
            "frame_ctr": np.asarray(renderer.frame_ctr),
            "render_time": np.asarray(renderer.render_time)}
    if state is not None:
        leaves = tree_leaves(state)
        for i, leaf in enumerate(leaves):
            flat[f"restir_{i}"] = leaf.cpu().numpy()
        flat["restir_n"] = np.asarray(len(leaves))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def _agree(renderer, path: str, data) -> None:
    """Every rank of a multi-rank renderer must restore the same
    checkpoint (a rank that cannot see rank 0's file would start afresh,
    and its frame seeds and accumulator weights would differ from the
    others' without an error): raise on every rank when the ranks differ
    in whether they found one or in its counters."""
    mesh = renderer.mesh
    if mesh is None or mesh.size == 1:
        return
    mine = ([1, int(data["acc_ctr"]), int(data["frame_ctr"])]
            if data is not None else [0, 0, 0])
    ranks = mesh_mod.all_gather(mesh, torch.tensor(
        [mine], dtype=torch.int64, device=mesh.device)).cpu()
    if not bool((ranks == ranks[0]).all()):
        raise RuntimeError(
            f"checkpoint {path}: the ranks disagree on it ((found, acc_ctr, "
            f"frame_ctr) by rank: {ranks.tolist()})")


def try_restore(renderer, path: str) -> bool:
    """Load path (or path.npz) into renderer if it exists -> whether it
    did. Every rank of a multi-rank renderer calls it, and they must all
    find the same file."""
    p = path if path.endswith(".npz") else path + ".npz"
    src = next((q for q in (p, path) if os.path.exists(q)), None)
    if src is None:
        _agree(renderer, path, None)
        return False
    with np.load(src) as data:
        _agree(renderer, path, data)
        renderer.accumulator = renderer.own_rows(
            torch.from_numpy(data["accumulator"]))
        renderer.moment2 = (renderer.own_rows(torch.from_numpy(
            data["moment2"])) if "moment2" in data
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
            if n != len(tree_leaves(state)):
                raise ValueError(f"checkpoint {p}: {n} ReSTIR state leaves, "
                                 f"the renderer has {len(tree_leaves(state))}")
            renderer._restir_state = renderer.own_rows(tree_rebuild(
                state, [torch.from_numpy(data[f"restir_{i}"]).to(
                    renderer.device) for i in range(n)]))
    return True
