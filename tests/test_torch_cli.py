"""The port's config files, CLI and terminal viewer on the CPU, against the
JAX package's (tpu_restir.config loaders, tpu_restir.cli,
tpu_restir.view): configs equal field by field, viewer helpers equal
exactly (the same float64 numpy), and `cli.main` rendering, exporting and
resuming a 16x16 frame with --device cpu."""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from tpu_restir import cli as jcli
from tpu_restir import config as jconfig
from tpu_restir import view as jview
from tpu_restir_torch import cli as tcli
from tpu_restir_torch import config as tconfig
from tpu_restir_torch import view as tview

_TOML = """
integrator = "restir"
seed = 7

[camera]
width = 32
height = 24
fov_y_deg = 50.0
view_from = [0.0, -3.9, 1.0]
pixel_sampler = "random"

[params]
use_skybox = false
max_bounce_count = 3

[restir]
m_area = 2
do_temporal_reuse = true
spatial_mis = "pairwise"

[intersector]
ptrace_mxu = true
"""

_SMALL = ["--size", "16x16", "--temporal", "--spatial", "--spatial-mis",
          "pairwise", "--bg", "0,0,0", "--device", "cpu"]


def _same(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


@pytest.mark.parametrize("suffix,text", [
    (".toml", _TOML),
    (".json", '{"seed": 9, "camera": {"width": 16, "height": 16, '
              '"view_at": [0, 0, 1]}, "restir": {"m_brdf": 2}}')])
def test_config_files_match_jax(tmp_path, suffix, text):
    p = tmp_path / f"render{suffix}"
    p.write_text(text)
    cfg = tconfig.load_config_file(str(p))
    _same(cfg, jconfig.load_config_file(str(p)))
    assert isinstance(cfg, tconfig.RenderConfig)
    if suffix == ".toml":
        assert cfg.camera.view_from == (0.0, -3.9, 1.0)
        assert cfg.intersector.ptrace_mxu and cfg.seed == 7
    bad = tmp_path / "bad.json"
    bad.write_text('{"camera": {"zoom": 2}}')
    with pytest.raises(KeyError, match="zoom"):
        tconfig.load_config_file(str(bad))
    with pytest.raises(ValueError, match="toml or .json"):
        tconfig.load_config_file(str(tmp_path / "render.yaml"))


@pytest.mark.parametrize("argv", [
    [],
    ["--m-area", "4", "--size", "40x20", "--denoise", "--no-gamma"],
    ["--temporal", "--spatial", "--spatial-mis", "balance", "--neighbors",
     "3", "--view-from", "1,2,3", "--profile-passes", "--seed", "5"]])
@pytest.mark.parametrize("with_file", [False, True])
def test_config_from_args_matches_jax(tmp_path, argv, with_file):
    """Flags alone, and flags over a TOML file (only flags that differ
    from the parser's defaults override the file), as the JAX CLI."""
    if with_file:
        p = tmp_path / "render.toml"
        p.write_text(_TOML)
        argv = ["--config", str(p)] + argv
    tp, jp = tcli.build_parser(), jcli.build_parser()
    cfg = tcli.config_from_args(tp.parse_args(argv), tp)
    _same(cfg, jcli.config_from_args(jp.parse_args(argv), jp))
    if with_file and "--m-area" in argv:
        assert cfg.restir.m_area == 4 and cfg.restir.do_temporal_reuse


def test_cli_renders_exports_and_resumes(tmp_path):
    """cli.main at 16x16 on the CPU: PNG, sidecar with pass times, and a
    checkpoint; a second run resumes it (3 + 2 iterations)."""
    from PIL import Image

    out = str(tmp_path / "img" / "t.png")
    ck = str(tmp_path / "ck")
    argv = _SMALL + ["--denoise", "--profile-passes", "--checkpoint", ck,
                     "--out", out]
    assert tcli.main(argv + ["--frames", "3"]) == 0
    assert os.path.exists(ck + ".npz")
    img = np.asarray(Image.open(out))
    assert img.shape == (16, 16, 4) and img[..., 3].min() == 255
    assert 0 < img[..., :3].mean() < 255
    assert tcli.main(argv + ["--frames", "2", "--export-every", "1"]) == 0
    side = open(out + ".txt").read()
    assert "Iteration count: 5\n" in side
    assert "Pass times (ms):\n" in side and "\tspatial: " in side
    assert "Temporal reuse: True" in side


_DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "demo")


@pytest.mark.parametrize("argv,match", [
    (["--scene", os.path.join(_DEMO, "demo.obj")], "item 11"),
    (["--skybox", os.path.join(_DEMO, "env.pfm")], "item 11"),
    (["--devices", "2"], "item 12")])
def test_cli_refuses_what_is_not_ported(tmp_path, argv, match):
    """OBJ scenes and --skybox (item 11) and --devices 2 (item 12, two
    ranks spawned on the CPU), once refused, render."""
    out = str(tmp_path / "x.png")
    run = _SMALL + ["--frames", "1", "--out", out] + argv
    assert tcli.main(run + ["--bg", "0,0,0"]) == 0
    side = open(out + ".txt").read()
    mean = float(side.split("Image mean:")[1].split()[0])
    assert np.isfinite(mean) and mean > 0.0


def test_cli_device_cuda_needs_cuda(tmp_path):
    """--device cuda (the default) never falls back to the CPU."""
    a = tcli.build_parser().parse_args(["--device", "cuda"])
    if torch.cuda.is_available():
        assert tcli.device_from_args(a).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--size", "16x16", "--frames", "1", "--out",
                       str(tmp_path / "x.png")])
    assert tcli.build_parser().parse_args([]).device == "cuda"


def test_load_scene_names():
    """The named scenes of the JAX CLI, the same triangles."""
    for name in ("cornell", "cornell-glossy", "many-lights:20",
                 "terrain:600", "soup:100"):
        scene = tcli.load_scene(name, "cpu")
        want = jcli.load_scene(name)
        np.testing.assert_array_equal(scene.tri_v.numpy(),
                                      np.asarray(want.tri_v), err_msg=name)
        assert (scene.cluster_tris is None) == (want.cluster_tris is None)


def test_viewer_helpers_match_jax():
    img = np.random.default_rng(0).uniform(0, 1, (32, 64, 3))
    s = tview.ansi_preview(img, max_cols=32, max_rows=8)
    assert s == jview.ansi_preview(img, max_cols=32, max_rows=8)
    assert "\x1b[38;2;" in s and s.count("\n") >= 7
    for deg in (90.0, 5.0, -30.0):
        assert tview.orbit_camera((0.0, -3.9, 1.0), (0.0, 0.0, 1.0), deg) \
            == jview.orbit_camera((0.0, -3.9, 1.0), (0.0, 0.0, 1.0), deg)
    cfg = tconfig.RenderConfig()
    jcfg = jconfig.RenderConfig()
    for key in "tsvmMbBnNpdax":
        got, want = tview.apply_key(cfg, key), jview.apply_key(jcfg, key)
        if want is None:
            assert got is None
        else:
            _same(got, want)
    assert tview.KEY_HELP == jview.KEY_HELP


def test_run_view_smoke():
    from tpu_restir_torch.renderer import Renderer
    from tpu_restir_torch.scene.cornell import cornell_box

    parser = tcli.build_parser()
    cfg = tcli.config_from_args(parser.parse_args(_SMALL), parser)
    r = Renderer(cornell_box("cpu"), cfg, device="cpu")
    buf = io.StringIO()
    tview.run_view(r, 2, orbit_deg_per_frame=5.0, refresh_every=1, out=buf)
    text = buf.getvalue()
    assert "frame 2/2" in text and "mean=" in text and r.acc_ctr == 2
    assert r.cam.pos[0] != 0.0               # the camera orbited
