"""The row mesh of sharded rendering on torch.distributed (counterpart of
`tpu_restir.dist.mesh`).

Pixel rows shard over a 1-D group of ranks, one rank per shard; the scene,
its acceleration structures and light tables are replicated on every
rank. The JAX package's single-controller mesh and its multi-host mesh
both map onto this one form: every rank runs the same program on its own
rows and talks to the others through collectives.

The transport is the group's backend and is never switched silently:
- NCCL where each rank has a card of its own;
- gloo for ranks on the CPU, and for ranks that share one card (NCCL
  refuses two ranks on one device). gloo's point-to-point operations take
  host tensors, so a gloo group whose ranks render on a card stages every
  buffer it sends or receives through host memory, explicitly, and counts
  the bytes (`Mesh.stats`). Rendering stays on the card.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

# torch's tiled all-gather: `all_gather_single` where it exists (newer
# torch deprecates `all_gather_into_tensor` in its favour), else
# `all_gather_into_tensor` (torch 2.11 has only that one)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def pick_backend(device_type: str, local_world_size: int) -> str:
    """gloo for CPU ranks and for more ranks than cards on this host,
    else NCCL (a card for each rank)."""
    if device_type == "cpu":
        return "gloo"
    if local_world_size > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_distributed(backend=None, device_type: str = "cuda") -> bool:
    """Join the process group described by the usual torchrun environment
    (RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), with
    the backend of `pick_backend` unless one is given -> whether it made
    the group. A no-op when the group exists already or for a single
    process, as the JAX package's is."""
    if dist.is_initialized():
        return False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return False
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    dist.init_process_group(backend or pick_backend(device_type, local),
                            init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)
    return True


def local_device(device_type: str) -> torch.device:
    """The rank's own device under torchrun: cuda:LOCAL_RANK, which must
    exist, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local} has no card: "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", local)


@dataclasses.dataclass
class Mesh:
    """One rank's view of the row mesh: its group (None: the default
    group), rank, world size, device, axis name and backend, and the
    bytes it has sent through collectives (`sent_bytes`) and staged
    between the card and the host for gloo (`staged_bytes`)."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str
    backend: str
    stats: dict = dataclasses.field(
        default_factory=lambda: {"sent_bytes": 0, "staged_bytes": 0})

    @property
    def staged(self) -> bool:
        """Buffers of this rank go through host memory (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(n_devices: int, axis: str, device) -> Mesh:
    """The row mesh of this process: the default group, whose world size
    must be n_devices (one process and no group for n_devices == 1), and
    the rank's device, which must exist."""
    device = torch.device(device)
    if device.type == "cuda":
        idx = device.index if device.index is not None else 0
        if idx >= torch.cuda.device_count():
            raise RuntimeError(f"{device}: no such card "
                               f"({torch.cuda.device_count()} present)")
        device = torch.device("cuda", idx)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if n_devices != 1:
            raise ValueError(f"{n_devices} devices need a process group of "
                             f"{n_devices} ranks (torchrun, or the CLI's "
                             "--devices); this process has none")
        return Mesh(None, 0, 1, device, axis, "none")
    size = dist.get_world_size()
    if size != n_devices:
        raise ValueError(f"requested {n_devices} devices, the process "
                         f"group has {size} ranks")
    return Mesh(None, dist.get_rank(), size, device, axis,
                dist.get_backend())


def _to_wire(mesh: Mesh, t):
    if mesh.staged:
        mesh.stats["staged_bytes"] += t.numel() * t.element_size()
        return t.cpu()
    return t


def _from_wire(mesh: Mesh, t):
    if mesh.staged:
        mesh.stats["staged_bytes"] += t.numel() * t.element_size()
        return t.to(mesh.device)
    return t


def exchange(mesh: Mesh, to_prev, to_next):
    """Send to_prev to rank - 1 and to_next to rank + 1, and receive from
    each the buffer it sends this way: (from_prev, from_next), None at a
    global edge. The buffers of one call have one shape and dtype on
    every rank. Every rank posts its operations in one order: those with
    rank - 1, then those with rank + 1."""
    ops, got = [], {}
    for peer, send in ((mesh.rank - 1, to_prev), (mesh.rank + 1, to_next)):
        if not 0 <= peer < mesh.size:
            continue
        wire = _to_wire(mesh, send.contiguous())
        got[peer] = torch.empty_like(wire)
        mesh.stats["sent_bytes"] += wire.numel() * wire.element_size()
        if peer < mesh.rank:
            ops += [dist.P2POp(dist.isend, wire, peer, mesh.group),
                    dist.P2POp(dist.irecv, got[peer], peer, mesh.group)]
        else:
            ops += [dist.P2POp(dist.irecv, got[peer], peer, mesh.group),
                    dist.P2POp(dist.isend, wire, peer, mesh.group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return tuple(_from_wire(mesh, got[p]) if p in got else None
                 for p in (mesh.rank - 1, mesh.rank + 1))


def all_gather(mesh: Mesh, t):
    """(n, ...) on every rank -> (size * n, ...), ranks in order."""
    if mesh.size == 1:
        return t
    wire = _to_wire(mesh, t.contiguous())
    out = wire.new_empty((mesh.size * wire.shape[0],) + wire.shape[1:])
    mesh.stats["sent_bytes"] += wire.numel() * wire.element_size()
    _ALL_GATHER(out, wire, group=mesh.group)
    return _from_wire(mesh, out)


def gather(mesh: Mesh, t, dst: int):
    """(n, ...) on every rank -> (size * n, ...) on rank dst, None on the
    others."""
    if mesh.size == 1:
        return t
    wire = _to_wire(mesh, t.contiguous())
    mesh.stats["sent_bytes"] += wire.numel() * wire.element_size()
    parts = ([torch.empty_like(wire) for _ in range(mesh.size)]
             if mesh.rank == dst else None)
    dist.gather(wire, parts, dst=dst, group=mesh.group)
    return _from_wire(mesh, torch.cat(parts)) if parts is not None else None


def all_reduce(mesh: Mesh, t):
    """The sum of t over the ranks, on every rank."""
    if mesh.size == 1:
        return t
    wire = _to_wire(mesh, t.contiguous().clone())
    mesh.stats["sent_bytes"] += wire.numel() * wire.element_size()
    dist.all_reduce(wire, group=mesh.group)
    return _from_wire(mesh, wire)


def barrier(mesh: Mesh) -> None:
    if mesh.size > 1:
        dist.barrier(group=mesh.group)
