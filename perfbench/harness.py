"""The general pieces of the benchmark: the specification and the files
it names, the scene and render settings of a configuration, the seeds
of a run, and the module check.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell lives in a file of its own under this folder, found by
the name that BENCHMARK.json gives: `configs/<config>.json`,
`scenes/<scene>.py`, `traffic/<traffic>.json`, `kinds/<kind>.py` (the
kind a traffic file names), `metrics/<metric>.py`, `limits/<cell>.json`.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_FILE = ROOT / "BENCHMARK.json"
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_restir")


def load_spec(path: Path = SPEC_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def data_file(kind: str, name: str) -> dict:
    """perfbench/<kind>/<name>.json."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list    # the spec's end-to-end entries this cell reports
    per_layer: list     # the spec's per-layer entries this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(spec: dict, name: str) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_file = ROOT / configs[w["config"]]["file"]
    with open(cfg_file) as f:
        config = json.load(f)
    return Cell(
        name=name, config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=data_file("traffic", w["traffic"]),
        chips=int(w["chips"]), limits=data_file("limits", name),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def scene_arrays(config: dict):
    """(vertices, material ids, material spec dicts) of a configuration,
    from its scene generator `scenes/<scene>.py`."""
    gen = importlib.import_module(f"perfbench.scenes.{config['scene']}")
    return gen.arrays(**config.get("scene_args", {}))


def render_config(cfg_mod, config: dict, traffic: dict, seed: int,
                  size=None):
    """A RenderConfig of `cfg_mod` (the program's `config` module or the
    reference's copy, which have the same fields) from a configuration
    and a traffic mix. size: (width, height) in place of the
    configuration's, for the CPU tests only."""
    cam = dict(config["camera"])
    for k in ("view_from", "view_at"):
        cam[k] = tuple(cam[k])
    if size is not None:
        cam["width"], cam["height"] = size
    kw = dict(
        camera=cfg_mod.CameraConfig(**cam),
        params=cfg_mod.RenderParams(**config.get("params", {})),
        restir=cfg_mod.RestirParams(**config.get("restir", {})),
        intersector=cfg_mod.IntersectorConfig(
            **config.get("intersector", {})),
        integrator=traffic["integrator"], seed=int(seed))
    if "direct_strategy" in traffic:
        kw["direct_strategy"] = traffic["direct_strategy"]
    return cfg_mod.RenderConfig(**kw)


@dataclasses.dataclass
class Seeds:
    """The numbers a run draws from --seed: the renderer's seed, the frame
    seeds of the gradient steps, the draw of the window frame to check,
    and the seed of the starting parameters."""

    render: int
    step0: int
    check_draw: int
    params: int


def run_seeds(seed: int) -> Seeds:
    """Any whole number -> the run's seeds, by numpy's SeedSequence (so
    seeds beyond 32 bits mix whole)."""
    ss = np.random.SeedSequence(abs(int(seed)), spawn_key=(int(seed < 0),))
    a, b, c, d = (int(x) for x in ss.generate_state(4))
    return Seeds(render=a % (2 ** 31 - 1), step0=b % (2 ** 30),
                 check_draw=c, params=d)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose whole top-level name is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".")[0] in FORBIDDEN)


def kind_module(kind: str):
    """The runner of traffic kind `kind`: perfbench/kinds/<kind>.py."""
    return importlib.import_module(f"perfbench.kinds.{kind}")


def metric_module(name: str):
    """The reader of per-layer metric `name`: perfbench/metrics/<name>.py
    (the name may hold dots, so it is loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def backward(loss) -> None:
    """The gradient step's backward call, a function of its own so that a
    traced run can wrap it in a range."""
    loss.backward()
