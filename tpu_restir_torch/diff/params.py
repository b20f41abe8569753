"""Differentiable scene parameters (counterpart of
`tpu_restir.diff.params`): a dict of material columns that require grad,
and their injection into the scene.

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

from tpu_restir_torch import mathx

DEFAULT_FIELDS = ("diffuse", "specular", "shininess", "emission")

# the JAX package's full set adds GGX roughness (MaterialTS) and the
# texture texels, neither ported yet
ALL_FIELDS = DEFAULT_FIELDS + ("roughness", "tex_data")


def _check_field(name: str) -> None:
    if name not in ALL_FIELDS:
        raise ValueError(f"unknown parameter field {name!r}; expected one "
                         f"of {ALL_FIELDS}")
    if name not in DEFAULT_FIELDS:
        raise NotImplementedError(
            f"parameter field {name!r} needs textures or MaterialTS, not "
            "ported yet (ROADMAP item 11)")


def extract_params(scene, fields: Sequence[str] = DEFAULT_FIELDS
                   ) -> Dict[str, torch.Tensor]:
    """Material columns as fresh leaves that require grad."""
    out = {}
    for f in fields:
        _check_field(f)
        out[f] = getattr(scene.materials, f).detach().clone() \
            .requires_grad_(True)
    return out


def apply_params(scene, params: Dict[str, torch.Tensor]):
    """The scene with its material columns replaced by `params`, clipped
    into physical range as the JAX function clips them (jnp.clip and
    jnp.maximum, whose gradient splits 0.5/0.5 at a bound: emission 0 and
    specular 0 sit on one for most Cornell materials). The material rows
    are repacked at every `gather_materials` call, so replacing the
    columns is enough."""
    upd = {}
    for name, val in params.items():
        _check_field(name)
        if name in ("diffuse", "specular"):
            upd[name] = mathx.clip(val, 0.0, 1.0)
        else:       # shininess, emission
            upd[name] = mathx.maximum(val, 0.0)
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **upd))
