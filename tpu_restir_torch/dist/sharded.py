"""Row-sharded ReSTIR rendering (counterpart of `tpu_restir.dist.sharded`).

Pixel rows shard over the row mesh; the scene, its acceleration
structures and light tables are replicated; the passes that read other
pixels (temporal and spatial reuse) receive them through the halo
exchange of `dist.halo`. Every draw is PCG4D keyed by global pixel
coordinates, so the sharded frame equals the one-device frame bit for
bit (tests/test_torch_dist.py).
"""

from __future__ import annotations

from tpu_restir_torch.dist import mesh as mesh_mod
from tpu_restir_torch.render.integrators.restir.pipeline import (map_pixels,
                                                                 restir_step)


def make_sharded_restir_step(mesh, cfg):
    """(scene, cam, frame_seed, state, frame_ctr) -> (frame, state) of
    this rank's rows, for the ReSTIR config cfg over mesh."""
    h = cfg.camera.height
    if h % mesh.size != 0:
        raise ValueError(f"height {h} not divisible by {mesh.size} devices")

    def step(scene, cam, frame_seed, state, frame_ctr):
        return restir_step(scene, cam, cfg, frame_seed, state, frame_ctr,
                           mesh=mesh)

    return step


def row_slice(mesh, full_h: int) -> slice:
    """The global rows of this rank."""
    n = full_h // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def split_rows(obj, mesh, full_h: int):
    """This rank's rows of a full-height tensor or ReSTIR state (the
    counterpart of device_put_row_sharded), on the rank's device."""
    rows = row_slice(mesh, full_h)
    if hasattr(obj, "shape"):
        return obj[rows].to(mesh.device)
    return map_pixels(obj, lambda ts: [t[rows].to(mesh.device) for t in ts])


def gather_full(obj, mesh):
    """Full rows of a row-sharded tensor or ReSTIR state on rank 0 (None
    on the others, which must call it too). For display, export and
    checkpoints; no gradient flows back."""
    def full(t):
        return mesh_mod.gather(mesh, t.detach(), 0)

    if hasattr(obj, "shape"):
        return full(obj)
    out = map_pixels(obj, lambda ts: [full(t) for t in ts])
    return out if mesh.rank == 0 else None
