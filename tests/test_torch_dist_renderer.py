"""The row-sharded Renderer, checkpoints and CLI of the port on gloo ranks
on the CPU (tests/torch_dist_worker.py), against one device. Imports
nothing of JAX.

  * Renderer with n_devices = 2 (32x16, temporal and pairwise spatial
    reuse, the SVGF denoiser): the accumulator equals the one-device one
    bit for bit; stats() equal the one-device stats within rtol 1e-6 (the
    sharded renderer all-reduces float64 sums where one device averages
    in float32); the exported PNG equals the one-device PNG pixel for
    pixel and the sidecar line for line, apart from the image name, the
    render time and the mean and variance, which are held at rtol 1e-5
    as printed.
  * A checkpoint written by 2 ranks resumes in 1 process, and one written
    by 1 process resumes in 2 ranks: either way the accumulator after 2
    more frames equals 5 uninterrupted one-device frames, bit for bit.
    A checkpoint that only rank 0 can see raises on both ranks.
  * The naive path tracer with n_devices = 2 renders the whole image on
    every rank: rank 0's display equals one device's.
  * `cli.main(["--devices", "2", "--device", "cpu", ...])` spawns two
    ranks and writes the PNG of `--devices 1`.
  * The refusals of row sharding are gone, and so is the one of the
    fallback intersection backends.
"""

import os

import numpy as np
import pytest

import torch_dist_worker as wk
from tpu_restir_torch import cli
from tpu_restir_torch.io.checkpoint import save, try_restore
from tpu_restir_torch.io.png import read_png_rgb
from tpu_restir_torch.renderer import Renderer
from tpu_restir_torch.scene.cornell import cornell_box

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpu_restir_torch")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_renderer")
    scene = cornell_box("cpu")
    one = Renderer(scene, wk.renderer_cfg(), "cpu")
    one.run(3)
    one.export(str(out / "one.png"))
    save(one, str(out / "one_ck"))
    ranks = wk.spawn([("renderer", dict(frames=3, more=2))], 2, out)
    return dict(out=out, one=one, ranks=[r[0] for r in ranks])


def _sidecar(path):
    return open(str(path) + ".txt").read().splitlines()


def test_sharded_renderer_stats_and_export_equal_one_device(run):
    one, got = run["one"], run["ranks"]
    np.testing.assert_array_equal(got[0]["acc"], one.accumulator.numpy())
    mean, var = one.stats()
    for g in got:   # stats are global: every rank has them
        np.testing.assert_allclose([g["mean"], g["var"]], [mean, var],
                                   rtol=1e-6)
    out = run["out"]
    np.testing.assert_array_equal(read_png_rgb(str(out / "sharded.png")),
                                  read_png_rgb(str(out / "one.png")))
    a, b = _sidecar(out / "sharded.png"), _sidecar(out / "one.png")
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        if la.startswith(("Image name:", "Render time:")):
            continue
        if la.startswith(("Image mean:", "Image variance:")):
            np.testing.assert_allclose(float(la.split(":")[1]),
                                       float(lb.split(":")[1]), rtol=1e-5)
            continue
        assert la == lb


@pytest.mark.parametrize("direction", ["2_to_1", "1_to_2"])
def test_checkpoint_resumes_across_rank_counts(run, direction):
    scene = cornell_box("cpu")
    straight = Renderer(scene, wk.renderer_cfg(), "cpu")
    straight.run(5)
    if direction == "2_to_1":
        r = Renderer(scene, wk.renderer_cfg(), "cpu")
        assert try_restore(r, str(run["out"] / "sharded_ck"))
        assert r.acc_ctr == 3 and r.frame_ctr == 3
        r.run(2)
        got = r.accumulator.numpy()
    else:
        got = run["ranks"][0]["resumed"]
    np.testing.assert_array_equal(got, straight.accumulator.numpy())


def test_checkpoint_seen_by_one_rank_raises_on_every_rank(run):
    assert [bool(r["one_sided_raised"]) for r in run["ranks"]] == [True, True]


def test_naive_with_two_devices_gives_the_one_device_image(run):
    r = Renderer(cornell_box("cpu"), wk.renderer_cfg(1, "naive"), "cpu")
    r.run(1)
    np.testing.assert_array_equal(run["ranks"][0]["naive"], r.display())


def test_cli_devices_two_on_cpu(tmp_path):
    argv = ["--device", "cpu", "--size", "32x16", "--temporal", "--spatial",
            "--spatial-mis", "pairwise", "--radius", "4", "--frames", "2"]
    assert cli.main(argv + ["--devices", "2",
                            "--out", str(tmp_path / "two.png")]) == 0
    assert cli.main(argv + ["--out", str(tmp_path / "one.png")]) == 0
    np.testing.assert_array_equal(read_png_rgb(str(tmp_path / "two.png")),
                                  read_png_rgb(str(tmp_path / "one.png")))


def test_sharding_refusals_are_gone():
    for rel in ("renderer.py", "cli.py",
                "render/integrators/restir/pipeline.py"):
        src = open(os.path.join(PKG, rel)).read()
        assert "ROADMAP item 12" not in src and "NotImplementedError" \
            not in src, rel
    src = open(os.path.join(PKG, "render", "intersect.py")).read()
    assert "ROADMAP item 13" not in src and "NotImplementedError" not in src
