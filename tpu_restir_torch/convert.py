"""State carried across between the two packages.

`from_tree` maps a numpy tree of a JAX pytree (the JAX object with its
leaves passed through `np.asarray`, e.g. `jax.tree.map(np.asarray, x)`)
to the port's dataclass on a device; `to_numpy` maps a port dataclass to
nested dicts of numpy arrays. `params_from_numpy` and `params_to_numpy`
carry a parameter dict of the differentiable path (`diff.params`) both
ways. Leaves are read by field name, so this module never sees a JAX
array or imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_restir_torch.accel.wide import BVH8Arrays
from tpu_restir_torch.render.integrators.restir.gbuffer import GBuffer
from tpu_restir_torch.render.integrators.restir.pipeline import RestirState
from tpu_restir_torch.render.integrators.restir.reservoir import (
    LightSample, Reservoir)
from tpu_restir_torch.scene.lights import EmissiveCDF
from tpu_restir_torch.scene.materials import MaterialTable
from tpu_restir_torch.scene.scene import SceneArrays
from tpu_restir_torch.scene.textures import TextureStack

# dataclass fields that hold nested dataclasses
_NESTED = {
    (SceneArrays, "materials"): MaterialTable,
    (SceneArrays, "lights"): EmissiveCDF,
    (SceneArrays, "textures"): TextureStack,
    (SceneArrays, "bvh"): BVH8Arrays,
    (Reservoir, "sample"): LightSample,
    (RestirState, "res_prev"): Reservoir,
    (RestirState, "gb_prev"): GBuffer,
}


def from_tree(cls, tree, device):
    """Numpy tree with the fields of `cls` -> `cls` with tensors on device.
    A clustered scene's (C, B, 128) cluster blocks keep their first 9
    channels (v0, e1, e2), the port's (C, B, 9) layout, and its (C, 8, 384)
    Woop blocks their 4 meaningful rows, the port's (C, 4, 384); its wide
    BVH (`bvh`) comes across whole. A nested field that is None (a scene
    without a texture stack) stays None."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(tree, f.name)
        if cls is SceneArrays and f.name == "cluster_tris" and v is not None:
            v = np.asarray(v)[..., :9]
        if cls is SceneArrays and f.name == "cluster_woop" and v is not None:
            v = np.asarray(v)[:, :4]
        sub = _NESTED.get((cls, f.name))
        if sub is not None:
            kw[f.name] = None if v is None else from_tree(sub, v, device)
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


def params_from_numpy(tree, device):
    """{field: numpy array} -> {field: float32 leaf on device that
    requires grad}, the form `diff.params.extract_params` returns."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=device).requires_grad_(True)
            for k, v in tree.items()}


def params_to_numpy(params):
    """{field: tensor} (parameters or gradients) -> {field: numpy array}."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
