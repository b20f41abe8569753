"""The port never imports JAX: a fresh interpreter imports tpu_restir_torch,
renders a 16x16 frame on the CPU and exports it, renders naive and NEE
frames (with their threefry draws) and their gradient, takes its gradient
w.r.t. the material table (`diff`), builds a clustered terrain and renders
it through the clustered traversal (and a cluster-size-128 terrain through
its Woop variant), queries the terrain under each fallback backend, loads
`roofline`, runs the CLI with a denoised, profiled, checkpointed
16x16 render and with the demo asset and its sky, takes the demo's
roughness and texel gradients, runs the row-sharded step and
value_and_grad of `dist` on a one-rank mesh, reads a Radiance .hdr sky,
runs the bench's functions at 16x16 on small scenes and imports its
terrain1M child and the whole-frame roofline (`tpu_restir_torch.tools`),
runs the ptrace and phase-1 profilers on the terrain and builds the
scaling bench's configuration, and neither JAX nor the JAX package
(`tpu_restir`) may be loaded, nor an imaging package (PIL, imageio). It runs in a subprocess because the test
session itself has JAX loaded (the root conftest configures it).

The port keeps its own copy of the config dataclasses; the second test
holds it to `tpu_restir.config` field by field, defaults included."""

import dataclasses
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = """
import sys
assert "jax" not in sys.modules, "jax was loaded before the test began"
import tpu_restir_torch
from tpu_restir_torch import RenderConfig, CameraConfig, RenderParams
from tpu_restir_torch import RestirParams, cornell_box
from tpu_restir_torch.renderer import Renderer
cfg = RenderConfig(
    camera=CameraConfig(width=16, height=16, pixel_sampler="random",
                        view_from=(0.0, -3.9, 1.0), view_at=(0.0, 0.0, 1.0)),
    params=RenderParams(use_skybox=False),
    restir=RestirParams(do_temporal_reuse=True, do_spatial_reuse=True,
                        spatial_mis="pairwise"))
r = Renderer(cornell_box("cpu"), cfg, device="cpu")
r.run(2)
mean, var = r.stats()
assert mean > 0.0 and var >= 0.0, (mean, var)
import os, tempfile
tmp = tempfile.mkdtemp()
r.export(os.path.join(tmp, "frame.png"))
assert os.path.exists(os.path.join(tmp, "frame.png.txt"))
import torch
from tpu_restir_torch.diff import optimize, params, render
from tpu_restir_torch.render.integrators.restir.pipeline import (
    init_restir_state)
from tpu_restir_torch.render.camera import make_camera
scene = cornell_box("cpu")
loss, grads = render.make_value_and_grad(
    scene, make_camera(cfg.camera, "cpu"), cfg, (1,),
    torch.zeros((16, 16, 3)))(params.extract_params(scene))
assert torch.isfinite(loss) and len(grads) == 4
for integ in ("naive", "nee"):
    pcfg = cfg.replace(integrator=integ, direct_strategy="ris")
    r = Renderer(scene, pcfg, device="cpu")
    r.run(2)
    assert r.stats()[0] > 0.0
    loss, grads = render.make_value_and_grad(
        scene, make_camera(pcfg.camera, "cpu"), pcfg, (1,),
        torch.zeros((16, 16, 3)))(params.extract_params(scene))
    assert torch.isfinite(loss) and len(grads) == 4
from tpu_restir_torch.accel import bvh, fcluster
from tpu_restir_torch.kernels import cluster_trace
from tpu_restir_torch.scene.procedural import terrain_scene, triangle_soup
from tpu_restir_torch.scene.cornell import many_lights_scene
terrain = terrain_scene("cpu", 600)
assert terrain.cluster_tris is not None
r = Renderer(terrain, cfg.replace(camera=cfg.camera.__class__(
    width=32, height=8, pixel_sampler="random", view_from=(0.0, -7.0, 4.0),
    view_at=(0.0, 0.0, 0.5))), device="cpu")
r.run(1)
assert r.stats()[0] > 0.0
from tpu_restir_torch.scene.procedural import TERRAIN_SPECS
from tpu_restir_torch.scene.scene import build_scene
woop = build_scene(terrain.tri_v.numpy(), terrain.tri_mat.numpy(),
                   TERRAIN_SPECS, "cpu", cluster_size=128)
hit = cluster_trace.trace_closest(
    woop.cluster_tris, woop.cluster_min, woop.cluster_max,
    torch.tensor([[0.0, -7.0, 4.0]]), torch.tensor([[0.0, 0.8, -0.6]]),
    torch.tensor([1e-3]), torch.tensor([1e4]), cwoop=woop.cluster_woop)
assert int(hit[3][0]) >= 0
from tpu_restir_torch import roofline
from tpu_restir_torch.config import IntersectorConfig
from tpu_restir_torch.render import intersect
o1, d1 = torch.tensor([[0.0, -7.0, 4.0]]), torch.tensor([[0.0, 0.8, -0.6]])
for b in ("brute", "woop_mxu", "cluster", "fcluster", "bvh"):
    assert bool(intersect.intersect_closest(
        terrain, o1, d1, 1e-3, 1e4, IntersectorConfig(backend=b)).hit[0]), b
assert roofline.summarize_query_log([])["total_rays"] == 0
from tpu_restir_torch import cli
assert cli.main(["--size", "16x16", "--frames", "2", "--temporal",
                 "--denoise", "--profile-passes", "--device", "cpu",
                 "--checkpoint", os.path.join(tmp, "ck"),
                 "--out", os.path.join(tmp, "cli.png")]) == 0
assert cli.main(["--scene", "assets/demo/demo.obj", "--skybox",
                 "assets/demo/env.pfm", "--size", "16x8", "--frames", "1",
                 "--device", "cpu", "--out", os.path.join(tmp, "demo.png")]) == 0
from tpu_restir_torch.scene.objloader import load_obj_scene
demo = load_obj_scene("assets/demo/demo.obj", "cpu")
loss, grads = render.make_value_and_grad(
    demo, make_camera(cfg.camera, "cpu"), cfg, (1,),
    torch.zeros((16, 16, 3)))(params.extract_params(
        demo, ("roughness", "tex_data")))
assert torch.isfinite(loss) and torch.isfinite(grads["tex_data"]).all()
from tpu_restir_torch.dist import diff as ddiff, halo, mesh, sharded
one = mesh.make_mesh(1, "tiles", "cpu")
step = sharded.make_sharded_restir_step(one, cfg)
frame, _ = step(scene, make_camera(cfg.camera, "cpu"), 1,
                sharded.split_rows(init_restir_state(16, 16, "cpu"), one, 16),
                0)
assert frame.shape == (16, 16, 3) and halo.halo_width(30.0) == 7
loss, grads = ddiff.make_sharded_value_and_grad(
    scene, make_camera(cfg.camera, "cpu"), cfg, (1,), torch.zeros((16, 16, 3)),
    one)(params.extract_params(scene))
assert torch.isfinite(loss) and len(grads) == 4
from tpu_restir_torch.scene.envmap import with_sky
with open(os.path.join(tmp, "sky.hdr"), "wb") as f:
    f.write(b"#?RADIANCE\\nFORMAT=32-bit_rle_rgbe\\n\\n-Y 1 +X 2\\n"
            + bytes([128, 64, 32, 129, 128, 64, 32, 131]))
assert float(with_sky(scene, os.path.join(tmp, "sky.hdr")).envmap.max()) > 4.0
from tpu_restir_torch import bench
from tpu_restir_torch.tools import bench_terrain1m, roofline_frame
small = dict(bench.SCENES,
             lights1k=(lambda d: many_lights_scene(d, 50), bench.CORNELL_VIEW),
             terrain100k=(lambda d: terrain_scene(d, 600), bench.TERRAIN_VIEW))
line, _rep = bench.run_bench(
    "cpu", 16, 16, scenes=small, n_frames=1, n_steps=1, n_secondary=1,
    child=[sys.executable, "-c", "print('TERRAIN1M 1.0 rpp 28.0')"])
assert "failed:" not in line["unit"] and "rpp 28.0 traced/28" in line["unit"]
assert bench_terrain1m.scene_info(terrain)["factor"] == 1
assert roofline_frame.INNER == 4
from tpu_restir_torch.tools import profile_phase1, profile_ptrace, scaling_bench
assert profile_ptrace.measure("cpu", scene=terrain, width=32, height=8,
                              reps=1)["rays"] == 256
assert profile_phase1.measure("cpu", scene=terrain, width=32, height=8,
                              reps=1)["full_sort_mismatches"] == 0
assert scaling_bench.scaling_cfg(16, 16, 4.0).restir.spatial_mis == "pairwise"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_restir"))
print("LOADED", bad)
print("DECODERS", sorted(m for m in sys.modules
                         if m.split(".")[0] in ("PIL", "imageio")))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    # the demo's PNG textures and PFM sky load by the port's own readers
    assert "DECODERS []" in out.stdout, out.stdout


def _fields(cls):
    """(name, default) pairs; nested config defaults compared as dicts."""
    return [(f.name, dataclasses.asdict(f.default)
             if dataclasses.is_dataclass(f.default) else f.default)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["RenderParams", "RestirParams",
                                  "CameraConfig", "IntersectorConfig",
                                  "RenderConfig"])
def test_port_config_matches_the_jax_config(name):
    from tpu_restir import config as jcfg
    from tpu_restir_torch import config as tcfg
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))
    for kind in ("SpatialMis", "PixelSamplerKind", "DirectStrategy"):
        a, b = getattr(tcfg, kind), getattr(jcfg, kind)
        assert {k: v for k, v in vars(a).items() if k.isupper()} \
            == {k: v for k, v in vars(b).items() if k.isupper()}
