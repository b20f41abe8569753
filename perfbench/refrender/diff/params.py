"""Differentiable scene parameters (counterpart of
`tpu_restir.diff.params`): a dict of material columns and texture texels
that require grad, and their injection into the scene.

Resampling decisions are boolean selects whose gradients are zero almost
everywhere, so autograd through ReSTIR is the detached-resampling
estimator: selection treated as constant, gradients flowing through the
shading f and the contribution weights. Emission gradients hold while the
emissive set is unchanged: the light CDF is built with the scene and does
not depend on the emission's magnitude (pg/TriangleCDF.cpp).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from perfbench.refrender import mathx

DEFAULT_FIELDS = ("diffuse", "specular", "shininess", "emission")

# the full set (BASELINE config 4): + GGX roughness (MaterialTS) and the
# raw texels of the texture stack (albedo, specular and roughness maps)
ALL_FIELDS = DEFAULT_FIELDS + ("roughness", "tex_data")


def _check_field(name: str) -> None:
    if name not in ALL_FIELDS:
        raise ValueError(f"unknown parameter field {name!r}; expected one "
                         f"of {ALL_FIELDS}")


def extract_params(scene, fields: Sequence[str] = DEFAULT_FIELDS
                   ) -> Dict[str, torch.Tensor]:
    """Material columns (and, for "tex_data", the texture stack's texels)
    as fresh leaves that require grad."""
    out = {}
    for f in fields:
        _check_field(f)
        if f == "tex_data":
            if scene.textures is None:
                raise ValueError("scene has no texture stack to optimize")
            val = scene.textures.data
        else:
            val = getattr(scene.materials, f)
        out[f] = val.detach().clone().requires_grad_(True)
    return out


def apply_params(scene, params: Dict[str, torch.Tensor]):
    """The scene with its material columns and texels replaced by
    `params`, clipped into physical range as the JAX function clips them
    (jnp.clip and jnp.maximum, whose gradient splits 0.5/0.5 at a bound:
    emission 0 and specular 0 sit on one for most Cornell materials;
    roughness stays in [1e-3, 4] so the GGX D stays finite). The material
    rows are repacked at every `gather_materials` call, so replacing the
    columns is enough."""
    upd = {}
    for name, val in params.items():
        _check_field(name)
        if name == "tex_data":
            scene = dataclasses.replace(scene, textures=dataclasses.replace(
                scene.textures, data=mathx.maximum(val, 0.0)))
        elif name in ("diffuse", "specular"):
            upd[name] = mathx.clip(val, 0.0, 1.0)
        elif name == "roughness":
            upd[name] = mathx.clip(val, 1e-3, 4.0)
        else:       # shininess, emission
            upd[name] = mathx.maximum(val, 0.0)
    if upd:
        scene = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, **upd))
    return scene
