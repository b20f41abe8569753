"""Material table: columns of tensors indexed by material id.

The counterpart of `tpu_restir.scene.materials`: dynamic dispatch over
material classes becomes one `mat_type` column plus dense parameter
columns, consumed branchlessly by `tpu_restir_torch.render.brdf`. Type ids
match the reference's enum (pg/enums.h:3-12).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


class MatType:
    NORMAL = 0      # tag-only base class: zero BRDF, no valid bounce
    LAMBERT = 1
    PHONG = 2
    MIRROR = 3
    DIELECTRIC = 4
    TRANSPARENT = 5
    UNSUPPORTED = 6
    TS = 7          # Torrance-Sparrow GGX; reports LAMBERT to ReSTIR


class VertexType:
    """Path vertex tags (reference pg/enums.h:14-21)."""

    INVALID = -1
    CAMERA = 0
    DIFFUSE = 1
    SPECULAR = 2
    MIRROR = 3
    REFRACTIVE = 4


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material record (builder input); the fields of
    tpu_restir.scene.materials.MaterialSpec."""

    name: str = "default"
    mat_type: int = MatType.LAMBERT
    ambient: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    diffuse: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    shininess: float = 1.0
    ior: float = 1.5
    reflectivity: float = 1.0
    roughness: float = 1.0
    attenuation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    tex_diffuse: int = -1
    tex_specular: int = -1
    tex_shininess: int = -1
    tex_normal: int = -1


@dataclasses.dataclass
class MaterialTable:
    diffuse: torch.Tensor       # (M, 3)
    specular: torch.Tensor      # (M, 3)
    emission: torch.Tensor      # (M, 3)
    ambient: torch.Tensor       # (M, 3)
    attenuation: torch.Tensor   # (M, 3)
    shininess: torch.Tensor     # (M,)
    ior: torch.Tensor           # (M,)
    reflectivity: torch.Tensor  # (M,)
    roughness: torch.Tensor     # (M,)
    mat_type: torch.Tensor      # (M,) int32
    tex_index: torch.Tensor     # (M, 4) int32
    # sorted distinct mat_type values of the table (static; selects the
    # slim reuse payload); () = unknown
    types_present: Tuple[int, ...] = ()

    @property
    def count(self) -> int:
        return self.diffuse.shape[0]

    def is_emissive(self) -> torch.Tensor:
        """emission > 0 on any channel (reference Material::isEmitter)."""
        return torch.any(self.emission > 0.0, dim=-1)


def build_material_table(specs: List[MaterialSpec], device) -> MaterialTable:
    def col(field):
        return torch.tensor(np.array([getattr(s, field) for s in specs],
                                     dtype=np.float32), device=device)

    tex = np.array([[s.tex_diffuse, s.tex_specular, s.tex_shininess,
                     s.tex_normal] for s in specs], dtype=np.int32)
    return MaterialTable(
        diffuse=col("diffuse"), specular=col("specular"),
        emission=col("emission"), ambient=col("ambient"),
        attenuation=col("attenuation"), shininess=col("shininess"),
        ior=col("ior"), reflectivity=col("reflectivity"),
        roughness=col("roughness"),
        mat_type=torch.tensor(np.array([s.mat_type for s in specs],
                                       dtype=np.int32), device=device),
        tex_index=torch.tensor(tex, device=device),
        types_present=tuple(sorted({s.mat_type for s in specs})))


def gather_materials(table: MaterialTable, mat_id) -> MaterialTable:
    """Per-ray material columns for an array of material ids: one row
    select of the packed (M, 24) table (int columns are small ints, exact
    as float32)."""
    from tpu_restir_torch import mathx

    i = torch.clamp(mat_id, 0, table.count - 1)
    packed = torch.cat([
        table.diffuse, table.specular, table.emission, table.ambient,
        table.attenuation, table.shininess[:, None], table.ior[:, None],
        table.reflectivity[:, None], table.roughness[:, None],
        table.mat_type.to(torch.float32)[:, None],
        table.tex_index.to(torch.float32)], dim=1)
    r = mathx.take_rows(packed, i)
    return MaterialTable(
        diffuse=r[..., 0:3], specular=r[..., 3:6], emission=r[..., 6:9],
        ambient=r[..., 9:12], attenuation=r[..., 12:15],
        shininess=r[..., 15], ior=r[..., 16], reflectivity=r[..., 17],
        roughness=r[..., 18], mat_type=r[..., 19].to(torch.int32),
        tex_index=r[..., 20:24].to(torch.int32),
        types_present=table.types_present)


def _no_textures(scene):
    if scene.textures is not None:
        raise NotImplementedError(
            "textured materials are not ported yet (ROADMAP item 11)")


def apply_textures(scene, m: MaterialTable, uv) -> MaterialTable:
    """Texture-backed material values at hit UVs; the identity without
    textures (the only case ported)."""
    _no_textures(scene)
    return m


def apply_normal_map(scene, m: MaterialTable, normal, tangent, uv):
    """Tangent-space normal mapping; the identity without textures."""
    _no_textures(scene)
    return normal
