"""Headless progressive renderer CLI of the port (counterpart of
`tpu_restir.cli`, the same flags plus --device).

Replaces the reference's interactive ImGui loop with a config/flag-driven
batch renderer (SURVEY.md §5.6): every knob the reference exposes in its
GUI is a flag here; output is the same PNG + sidecar pair. It renders on
--device (default cuda, which must be present: there is no fallback to
the CPU).

--devices N (N > 1) shards the ReSTIR frame's rows over N ranks of a
torch.distributed group (`tpu_restir_torch.dist`). Under torchrun the
process joins the group of its environment and renders on cuda:LOCAL_RANK
(or the CPU with --device cpu); otherwise the CLI spawns N local ranks
itself, on cuda:0..N-1 (it raises when fewer cards exist) or, with
--device cpu, on the CPU under gloo. Rank 0 writes the image, the sidecar
and the checkpoint.

Examples:
    python -m tpu_restir_torch.cli --scene cornell --size 256x256 \
        --temporal --spatial --spatial-mis pairwise --frames 64 \
        --out out/cornell.png
    python -m tpu_restir_torch.cli --devices 2 --device cpu --size 64x64 \
        --temporal --spatial --spatial-mis pairwise --out out/sharded.png
    torchrun --nproc-per-node 2 -m tpu_restir_torch.cli --devices 2 \
        --temporal --spatial --spatial-mis pairwise --out out/sharded.png
    python -m tpu_restir_torch.cli --scene assets/demo/demo.obj \
        --skybox assets/demo/env.pfm --fov 50 --view-from 0,-6.0,2.1 \
        --view-at 0,0.4,0.7 --temporal --spatial --spatial-mis pairwise \
        --m-area 2 --out out/demo.png
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from tpu_restir_torch.config import (CameraConfig, RenderConfig,
                                     RenderParams, RestirParams, SpatialMis)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tpu_restir_torch",
                                description="ReSTIR renderer in PyTorch")
    p.add_argument("--config", default=None,
                   help="TOML/JSON render config; explicit CLI flags "
                        "override file values")
    p.add_argument("--scene", default="cornell",
                   help="cornell | cornell-glossy | many-lights[:N] | "
                        "terrain[:N_TRIS] | soup[:N_TRIS] | path/to.obj")
    p.add_argument("--size", default="256x256", help="WIDTHxHEIGHT")
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--view-from", default="0,-3.9,1.0")
    p.add_argument("--view-at", default="0,0,1.0")
    p.add_argument("--integrator", default="restir",
                   choices=["naive", "nee", "restir"])
    p.add_argument("--direct", default="mis",
                   choices=["area", "brdf", "mis", "ris"],
                   help="NEE direct-lighting strategy")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--bounces", type=int, default=5)
    p.add_argument("--pixel-sampler", default="random",
                   choices=["center", "random", "stratified"])
    p.add_argument("--m-area", type=int, default=1)
    p.add_argument("--m-brdf", type=int, default=1)
    p.add_argument("--visibility-pass", action="store_true")
    p.add_argument("--temporal", action="store_true")
    p.add_argument("--spatial", action="store_true")
    p.add_argument("--spatial-passes", type=int, default=1)
    p.add_argument("--neighbors", type=int, default=5)
    p.add_argument("--radius", type=float, default=30.0)
    p.add_argument("--spatial-mis", default=SpatialMis.CONSTANT,
                   choices=list(SpatialMis.ALL))
    p.add_argument("--reject-dissimilar", action="store_true")
    p.add_argument("--confidence-cap", type=float, default=20.0)
    p.add_argument("--no-tonemap", action="store_true")
    p.add_argument("--no-gamma", action="store_true")
    p.add_argument("--skybox", default=None, help="equirect HDR path")
    p.add_argument("--bg", default="0.5,0.5,0.5")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--devices", type=int, default=1,
                   help="shard pixel rows over N devices")
    p.add_argument("--denoise", action="store_true",
                   help="joint-bilateral denoise of the display image")
    p.add_argument("--out", default="out/render.png")
    p.add_argument("--export-every", type=int, default=0,
                   help="also export every N frames")
    p.add_argument("--checkpoint", default=None,
                   help="path to save/resume renderer state")
    p.add_argument("--view", action="store_true",
                   help="live in-terminal progressive display")
    p.add_argument("--orbit", type=float, default=0.0,
                   help="orbit the camera N degrees per frame (with --view)")
    p.add_argument("--profile-passes", action="store_true",
                   help="per-pass device timing (slower; single-chip)")
    p.add_argument("--debug-reprojection", action="store_true",
                   help="paint temporal-rejection reasons into the frame")
    p.add_argument("--show-weights", action="store_true",
                   help="NEE/MIS: render MIS weights as R/G colors")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:N or cpu)")
    return p


def _vec3(s):
    x = [float(v) for v in s.split(",")]
    if len(x) != 3:
        raise ValueError(f"expected three comma-separated numbers, got {s!r}")
    return tuple(x)


def load_scene(name: str, device):
    """A named scene on device: cornell, cornell-glossy, many-lights[:N],
    terrain[:N_TRIS] or soup[:N_TRIS]; any other name is an OBJ path."""
    from tpu_restir_torch.scene.cornell import cornell_box, many_lights_scene

    if name == "cornell":
        return cornell_box(device)
    if name == "cornell-glossy":
        return cornell_box(device, glossy_box=True)
    if name.startswith("many-lights"):
        n = int(name.split(":")[1]) if ":" in name else 1000
        return many_lights_scene(device, n)
    if name.startswith("terrain"):
        from tpu_restir_torch.scene.procedural import terrain_scene

        n = int(name.split(":")[1]) if ":" in name else 100_000
        return terrain_scene(device, n)
    if name.startswith("soup"):
        from tpu_restir_torch.scene.procedural import triangle_soup

        n = int(name.split(":")[1]) if ":" in name else 10_000
        return triangle_soup(device, n)
    from tpu_restir_torch.scene.objloader import load_obj_scene

    return load_obj_scene(name, device)


def config_from_args(a, parser=None) -> RenderConfig:
    if a.config:
        from tpu_restir_torch.config import load_config_file, replace

        base = load_config_file(a.config)
        # CLI overrides: only flags whose value differs from the parser
        # default touch the file config
        defaults = parser.parse_args([]) if parser else a
        w, h = (int(v) for v in a.size.lower().split("x"))

        def ov(name, value, transform=lambda x: x):
            return transform(value) if getattr(a, name) != getattr(
                defaults, name) else None

        cam_kw = {k: v for k, v in dict(
            width=ov("size", w), height=ov("size", h),
            fov_y_deg=ov("fov", a.fov),
            view_from=ov("view_from", a.view_from, _vec3),
            view_at=ov("view_at", a.view_at, _vec3),
            pixel_sampler=ov("pixel_sampler", a.pixel_sampler),
        ).items() if v is not None}
        params_kw = {k: v for k, v in dict(
            max_bounce_count=ov("bounces", a.bounces),
            denoise=ov("denoise", a.denoise),
            bg_color=ov("bg", a.bg, _vec3),
            use_skybox=ov("skybox", a.skybox is not None),
            tonemap=ov("no_tonemap", not a.no_tonemap),
            gamma_correct=ov("no_gamma", not a.no_gamma),
        ).items() if v is not None}
        restir_kw = {k: v for k, v in dict(
            m_area=ov("m_area", a.m_area), m_brdf=ov("m_brdf", a.m_brdf),
            do_visibility_pass=ov("visibility_pass", a.visibility_pass),
            do_temporal_reuse=ov("temporal", a.temporal),
            do_spatial_reuse=ov("spatial", a.spatial),
            spatial_pass_count=ov("spatial_passes", a.spatial_passes),
            spatial_mis=ov("spatial_mis", a.spatial_mis),
            spatial_neighbor_count=ov("neighbors", a.neighbors),
            spatial_reuse_radius=ov("radius", a.radius),
            confidence_cap=ov("confidence_cap", a.confidence_cap),
            reject_dissimilar_neighbors=ov("reject_dissimilar",
                                           a.reject_dissimilar),
            debug_reprojection=ov("debug_reprojection",
                                  a.debug_reprojection),
        ).items() if v is not None}
        top_kw = {k: v for k, v in dict(
            integrator=ov("integrator", a.integrator),
            direct_strategy=ov("direct", a.direct),
            seed=ov("seed", a.seed),
            n_devices=ov("devices", a.devices),
            show_weights=ov("show_weights", a.show_weights),
            profile_passes=ov("profile_passes", a.profile_passes),
        ).items() if v is not None}
        return base.replace(
            camera=replace(base.camera, **cam_kw),
            params=replace(base.params, **params_kw),
            restir=replace(base.restir, **restir_kw), **top_kw)

    w, h = (int(v) for v in a.size.lower().split("x"))
    return RenderConfig(
        camera=CameraConfig(width=w, height=h, fov_y_deg=a.fov,
                            view_from=_vec3(a.view_from),
                            view_at=_vec3(a.view_at),
                            pixel_sampler=a.pixel_sampler),
        params=RenderParams(max_bounce_count=a.bounces,
                            bg_color=_vec3(a.bg),
                            use_skybox=a.skybox is not None,
                            tonemap=not a.no_tonemap,
                            gamma_correct=not a.no_gamma,
                            denoise=a.denoise),
        restir=RestirParams(m_area=a.m_area, m_brdf=a.m_brdf,
                            do_visibility_pass=a.visibility_pass,
                            do_temporal_reuse=a.temporal,
                            do_spatial_reuse=a.spatial,
                            spatial_pass_count=a.spatial_passes,
                            spatial_neighbor_count=a.neighbors,
                            spatial_reuse_radius=a.radius,
                            spatial_mis=a.spatial_mis,
                            reject_dissimilar_neighbors=a.reject_dissimilar,
                            confidence_cap=a.confidence_cap,
                            debug_reprojection=a.debug_reprojection),
        integrator=a.integrator, direct_strategy=a.direct, seed=a.seed,
        n_devices=a.devices, show_weights=a.show_weights,
        profile_passes=a.profile_passes)


def device_from_args(a) -> torch.device:
    """The --device to render on; CUDA must be there when asked for."""
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {a.device}: CUDA is not available "
                           "(pass --device cpu to render on the CPU)")
    return dev


def _local_rank(rank: int, n: int, port: int, argv) -> None:
    """One rank spawned by main: the torchrun environment, then main."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n))
    main(argv)


def _spawn(a, argv, n: int) -> int:
    """Run this command line on n local ranks (start method spawn): on
    cuda:0..n-1, which must exist, with the kernels built here first so
    that the ranks do not build them at once; or on the CPU."""
    import socket

    import torch.multiprocessing as mp

    if torch.device(a.device).type == "cuda":
        device_from_args(a)
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"--devices {n}: only "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        from tpu_restir_torch.kernels import build

        build.load_kernels()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_local_rank, args=(n, port, argv), nprocs=n,
                       start_method="spawn")
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    a = parser.parse_args(argv)
    cfg = config_from_args(a, parser)
    joined = False
    if cfg.n_devices > 1:
        if "WORLD_SIZE" not in os.environ:
            return _spawn(a, argv, cfg.n_devices)
        from tpu_restir_torch.dist.mesh import init_distributed, local_device

        dev_type = torch.device(a.device).type
        joined = init_distributed(device_type=dev_type)
        dev = local_device(dev_type)
    else:
        dev = device_from_args(a)
    try:
        return _render(a, cfg, dev)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _render(a, cfg: RenderConfig, dev) -> int:
    scene = load_scene(a.scene, dev)
    if a.skybox:
        from tpu_restir_torch.scene.envmap import with_sky

        scene = with_sky(scene, a.skybox)

    from tpu_restir_torch.renderer import Renderer

    r = Renderer(scene, cfg, device=dev)
    if a.checkpoint:
        from tpu_restir_torch.io.checkpoint import try_restore

        try_restore(r, a.checkpoint)
    if a.view:
        from tpu_restir_torch.view import run_view

        run_view(r, a.frames, orbit_deg_per_frame=a.orbit,
                 refresh_every=max(a.export_every, 1))
    else:
        for i in range(a.frames):
            r.step()
            if a.export_every and (i + 1) % a.export_every == 0:
                r.export(a.out)
                stats = r.stats()
                if r.is_root:
                    print(f"frame {i + 1}/{a.frames} exported; "
                          f"mean/var = {stats}")
    r.export(a.out)
    if a.checkpoint:
        from tpu_restir_torch.io.checkpoint import save

        save(r, a.checkpoint)
    mean, var = r.stats()
    if r.is_root:
        print(f"done: {a.out}  frames={a.frames}  mean={mean:.6g} "
              f"var={var:.6g}  time={r.render_time:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
