"""SceneArrays: the whole scene as one dataclass of tensors on one device
(counterpart of `tpu_restir.scene.scene`): triangle vertices, per-vertex
attributes, per-triangle material ids, the emissive CDF and the Woop rows
of the ray/triangle kernels."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from tpu_restir_torch.kernels.woop import build_woop_matrices
from tpu_restir_torch.scene.lights import EmissiveCDF, build_emissive_cdf
from tpu_restir_torch.scene.materials import (MaterialSpec, MaterialTable,
                                              build_material_table)


@dataclasses.dataclass
class SceneArrays:
    tri_v: torch.Tensor        # (N, 3, 3) vertex positions
    tri_v0: torch.Tensor       # (N, 3)
    tri_e1: torch.Tensor       # (N, 3) v1 - v0
    tri_e2: torch.Tensor       # (N, 3) v2 - v0
    tri_area: torch.Tensor     # (N,)
    vtx_normal: torch.Tensor   # (N, 3, 3)
    vtx_uv: torch.Tensor       # (N, 3, 2)
    vtx_tangent: torch.Tensor  # (N, 3, 3)
    tri_mat: torch.Tensor      # (N,) int32
    materials: MaterialTable
    lights: EmissiveCDF
    woop: torch.Tensor         # (N, 3, 4) Woop affine maps
    textures: Optional[torch.Tensor] = None
    envmap: Optional[torch.Tensor] = None

    @property
    def num_tris(self) -> int:
        return self.tri_v.shape[0]


def build_scene(vertices: np.ndarray, material_ids: np.ndarray,
                specs: List[MaterialSpec], device,
                vertex_normals: Optional[np.ndarray] = None,
                vertex_uvs: Optional[np.ndarray] = None,
                vertex_tangents: Optional[np.ndarray] = None,
                cluster_size: int = 64) -> SceneArrays:
    """Host-side build (numpy), then one copy to `device`. Scenes above
    `cluster_size` triangles need the clustered traversal, not ported."""
    v = np.asarray(vertices, np.float32)
    n_tris = v.shape[0]
    if n_tris > cluster_size:
        raise NotImplementedError(
            f"scenes above {cluster_size} triangles need the clustered "
            f"traversal (got {n_tris}); not ported yet (ROADMAP item 8)")
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    if vertex_normals is None:
        fn = np.cross(e1, e2)
        fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        vertex_normals = np.repeat(fn[:, None, :], 3, axis=1)
    if vertex_uvs is None:
        vertex_uvs = np.zeros((n_tris, 3, 2), np.float32)
    if vertex_tangents is None:
        t = e1 / np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-20)
        vertex_tangents = np.repeat(t[:, None, :], 3, axis=1)

    mat_ids = np.asarray(material_ids, np.int32)
    emissive_mat = np.array(
        [any(c > 0 for c in s.emission) for s in specs], bool)

    def dev(a, dtype=np.float32):
        return torch.tensor(np.asarray(a, dtype), device=device)

    return SceneArrays(
        tri_v=dev(v), tri_v0=dev(v[:, 0]), tri_e1=dev(e1), tri_e2=dev(e2),
        tri_area=dev(areas), vtx_normal=dev(vertex_normals),
        vtx_uv=dev(vertex_uvs), vtx_tangent=dev(vertex_tangents),
        tri_mat=dev(mat_ids, np.int32),
        materials=build_material_table(specs, device),
        lights=build_emissive_cdf(areas.astype(np.float32),
                                  emissive_mat[mat_ids], device),
        woop=dev(build_woop_matrices(v)))
