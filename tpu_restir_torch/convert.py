"""State carried across between the two packages.

`from_tree` maps a numpy tree of a JAX pytree (the JAX object with its
leaves passed through `np.asarray`, e.g. `jax.tree.map(np.asarray, x)`)
to the port's dataclass on a device; `to_numpy` maps a port dataclass to
nested dicts of numpy arrays. Leaves are read by field name, so this
module never sees a JAX array or imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_restir_torch.render.integrators.restir.gbuffer import GBuffer
from tpu_restir_torch.render.integrators.restir.pipeline import RestirState
from tpu_restir_torch.render.integrators.restir.reservoir import (
    LightSample, Reservoir)
from tpu_restir_torch.scene.lights import EmissiveCDF
from tpu_restir_torch.scene.materials import MaterialTable
from tpu_restir_torch.scene.scene import SceneArrays

# dataclass fields that hold nested dataclasses
_NESTED = {
    (SceneArrays, "materials"): MaterialTable,
    (SceneArrays, "lights"): EmissiveCDF,
    (Reservoir, "sample"): LightSample,
    (RestirState, "res_prev"): Reservoir,
    (RestirState, "gb_prev"): GBuffer,
}


def from_tree(cls, tree, device):
    """Numpy tree with the fields of `cls` -> `cls` with tensors on device.
    Scenes with cluster blocks (large scenes) are refused."""
    if cls is SceneArrays and getattr(tree, "cluster_tris", None) is not None:
        raise NotImplementedError(
            "clustered (large) scenes are not ported yet (ROADMAP item 8)")
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(tree, f.name)
        sub = _NESTED.get((cls, f.name))
        if sub is not None:
            kw[f.name] = from_tree(sub, v, device)
        elif isinstance(v, (np.ndarray, np.generic)):
            kw[f.name] = torch.from_numpy(np.array(v)).to(device)
        else:
            kw[f.name] = v          # static fields and absent resources
    return cls(**kw)


def to_numpy(obj):
    """Port dataclass -> nested dict of numpy arrays (static fields kept)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj
