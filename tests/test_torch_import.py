"""The port never imports JAX: a fresh interpreter imports tpu_restir_torch
and renders a 16x16 frame on the CPU, and neither JAX nor the JAX package
(`tpu_restir`) may be loaded. It runs in a subprocess because the test
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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_restir"))
print("LOADED", bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


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
