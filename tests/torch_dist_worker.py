"""Ranks of a gloo process group on the CPU for tests/test_torch_dist.py and
tests/test_torch_dist_renderer.py. Imports nothing of JAX.

`spawn(jobs, n, outdir)` starts n processes (start method spawn) that
join one group over localhost, build the row mesh and run each job in
`jobs` in order, every rank the same; each rank writes what its jobs
return to outdir/rank<r>.npz. A job is the name of a function below and
its keyword arguments.
"""

import contextlib
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpu_restir_torch import rng
from tpu_restir_torch.config import (CameraConfig, RenderConfig,
                                     RenderParams, RestirParams)
from tpu_restir_torch.dist import halo, mesh as mesh_mod
from tpu_restir_torch.dist.diff import make_sharded_value_and_grad
from tpu_restir_torch.dist.sharded import (gather_full,
                                           make_sharded_restir_step,
                                           split_rows)
from tpu_restir_torch.diff.params import extract_params
from tpu_restir_torch.render import camera as cam_mod
from tpu_restir_torch.render.integrators.restir.pipeline import (
    init_restir_state)
from tpu_restir_torch.scene.cornell import cornell_box

TIMEOUT_S = 240


def restir_cfg(size, radius, neighbors=4, n_devices=1, height=None):
    """The JAX sharding tests' config: Cornell, m_area 2, m_brdf 1,
    temporal and pairwise spatial reuse."""
    return RenderConfig(
        camera=CameraConfig(width=size, height=height or size,
                            fov_y_deg=45.0, view_from=(0.0, -3.9, 1.0),
                            view_at=(0.0, 0.0, 1.0), pixel_sampler="random"),
        params=RenderParams(use_skybox=False),
        restir=RestirParams(m_area=2, m_brdf=1, do_temporal_reuse=True,
                            do_spatial_reuse=True,
                            spatial_neighbor_count=neighbors,
                            spatial_reuse_radius=radius,
                            spatial_mis="pairwise"),
        integrator="restir", n_devices=n_devices)


def int_field(h, w, seed):
    """An integer-valued float field (sums of such are exact)."""
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(-8, 9, (h, w)).astype(np.float32))


def extend(mesh, h, w, halo_rows):
    """extend_rows on a float, an int32 and a bool field, and the gradient
    of sum(ext * weights) w.r.t. the float rows (weights: int_field of
    seed 100 + rank, the extended shape); gather_rows likewise (weights of
    seed 200 + rank)."""
    x = torch.arange(h * w, dtype=torch.float32).reshape(h, w)
    rows = split_rows(x, mesh, h)
    xi = split_rows((x * 3).to(torch.int32), mesh, h)
    xb = split_rows(x.to(torch.int64) % 3 == 0, mesh, h)
    leaf = rows.clone().requires_grad_(True)
    ext = halo.extend_rows([leaf, xi, xb], halo_rows, mesh)
    wts = int_field(ext[0].shape[0], w, 100 + mesh.rank)
    (g_ext,) = torch.autograd.grad((ext[0] * wts).sum(), [leaf])
    full = halo.gather_rows([leaf, xi], mesh)
    wts2 = int_field(h, w, 200 + mesh.rank)
    (g_full,) = torch.autograd.grad((full[0] * wts2).sum(), [leaf])
    return dict(ext=ext[0].detach().numpy(), ext_i=ext[1].numpy(),
                ext_b=ext[2].numpy(), g_ext=g_ext.numpy(),
                full=full[0].detach().numpy(), full_i=full[1].numpy(),
                g_full=g_full.numpy())


def frames(mesh, size, radius, n_frames=3, views=None, height=None):
    """n_frames sharded ReSTIR frames from a fresh state (the camera of
    views[f] for frame f, if given), gathered on rank 0, with the final
    state's reservoirs; the halo and staged bytes of this rank."""
    cfg = restir_cfg(size, radius, n_devices=mesh.size, height=height)
    scene = cornell_box("cpu")
    step = make_sharded_restir_step(mesh, cfg)
    state = split_rows(init_restir_state(cfg.camera.height, size, "cpu"),
                       mesh, cfg.camera.height)
    out = {}
    for f in range(n_frames):
        vf, va = views[f] if views else (None, None)
        cam = cam_mod.make_camera(cfg.camera, "cpu", vf, va)
        frame, state = step(scene, cam, rng.make_frame_seed(0, f), state, f)
        full = gather_full(frame, mesh)
        if full is not None:
            out[f"frame{f}"] = full.numpy()
    res = gather_full(state.res_prev, mesh)
    if res is not None:
        out.update(point=res.sample.point.numpy(),
                   valid=res.sample.valid.numpy(), w=res.w.numpy())
    out.update(sent=mesh.stats["sent_bytes"],
               staged=mesh.stats["staged_bytes"])
    return out


def grads(mesh, size, radius):
    """Sharded value_and_grad of the JAX test's estimator (seeds 0 and 1,
    target uniform of seed 5) w.r.t. the material table."""
    cfg = restir_cfg(size, radius, neighbors=3, n_devices=mesh.size)
    scene = cornell_box("cpu")
    cam = cam_mod.make_camera(cfg.camera, "cpu")
    target = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (size, size, 3)).astype(np.float32))
    loss, g = make_sharded_value_and_grad(scene, cam, cfg, (0, 1), target,
                                          mesh)(extract_params(scene))
    return dict(loss=loss.numpy(), **{f"g_{k}": v.numpy()
                                      for k, v in g.items()})


def renderer_cfg(n_devices=1, integrator="restir"):
    """tests/test_torch_dist_renderer.py's config: 32x16, temporal and
    pairwise spatial reuse at radius 4, the SVGF denoiser (ReSTIR only)."""
    cfg = restir_cfg(32, 4.0, n_devices=n_devices, height=16)
    return cfg.replace(params=RenderParams(use_skybox=False,
                                           denoise=integrator == "restir"),
                       integrator=integrator, direct_strategy="mis")


def renderer(mesh, outdir, frames=3, more=2):
    """A 2-rank Renderer: `frames` frames, then stats, export and
    checkpoint (rank 0 writes outdir/sharded.png and sharded_ck.npz); a
    fresh one resumed from outdir/one_ck.npz (written by one device) for
    `more` frames; a restore that only rank 0 can see (rank 1 is given a
    missing path), which must raise on both; one naive frame. Returns the
    accumulators gathered on rank 0, the stats and whether the one-sided
    restore raised."""
    from tpu_restir_torch.io.checkpoint import save, try_restore
    from tpu_restir_torch.renderer import Renderer

    scene = cornell_box("cpu")
    r = Renderer(scene, renderer_cfg(mesh.size), "cpu")
    r.run(frames)
    mean, var = r.stats()
    r.export(os.path.join(outdir, "sharded.png"))
    save(r, os.path.join(outdir, "sharded_ck"))
    acc = r.full_rows(r.accumulator)
    r2 = Renderer(scene, renderer_cfg(mesh.size), "cpu")
    assert try_restore(r2, os.path.join(outdir, "one_ck"))
    r2.run(more)
    resumed = r2.full_rows(r2.accumulator)
    r3 = Renderer(scene, renderer_cfg(mesh.size), "cpu")
    seen = "one_ck" if mesh.rank == 0 else "no_such_ck"
    try:
        try_restore(r3, os.path.join(outdir, seen))
        one_sided_raised = False
    except RuntimeError as e:
        one_sided_raised = "the ranks disagree" in str(e)
    naive = Renderer(scene, renderer_cfg(mesh.size, "naive"), "cpu")
    naive.run(1)
    img = naive.display()
    out = dict(mean=mean, var=var, one_sided_raised=one_sided_raised)
    if mesh.rank == 0:
        out.update(acc=acc.numpy(), resumed=resumed.numpy(), naive=img)
    else:
        assert acc is None and resumed is None and img is None
    return out


JOBS = dict(extend=extend, frames=frames, grads=grads, renderer=renderer)


def _rank(rank, n, port, jobs, outdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    try:
        mesh = mesh_mod.make_mesh(n, "tiles", "cpu")
        out = {}
        for i, (name, kw) in enumerate(jobs):
            if name == "renderer":
                kw = dict(kw, outdir=str(outdir))
            for k, v in JOBS[name](mesh, **kw).items():
                out[f"{i}.{k}"] = v
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(jobs, n, outdir):
    """Run jobs on n gloo ranks -> a list (per rank) of dicts (per job)
    of the arrays each job returned."""
    ctx = mp.start_processes(_rank, args=(n, free_port(), jobs, str(outdir)),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks did not finish "
                                   f"{[j[0] for j in jobs]} in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out = []
    for r in range(n):
        with np.load(os.path.join(str(outdir), f"rank{r}.npz")) as d:
            per = [dict() for _ in jobs]
            for key in d.files:
                i, k = key.split(".", 1)
                per[int(i)][k] = d[key]
            out.append(per)
    return out
