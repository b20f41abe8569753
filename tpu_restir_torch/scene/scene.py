"""SceneArrays: the whole scene as one dataclass of tensors on one device
(counterpart of `tpu_restir.scene.scene`): triangle vertices, per-vertex
attributes, per-triangle material ids, the emissive CDF, the Woop rows
of the ray/triangle kernels and, for scenes above `cluster_size`
triangles, the cluster blocks of the clustered traversal (and, at
`cluster_size` 128, the Woop blocks of its Woop variant) and the wide BVH
of the 'bvh' backend; optionally the texture stack and the equirect
environment map."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from tpu_restir_torch.accel.wide import BVH8Arrays, collapse_bvh8
from tpu_restir_torch.kernels.cluster_trace import (WOOP_BLOCK,
                                                    build_cluster_woop)
from tpu_restir_torch.kernels.woop import build_woop_matrices
from tpu_restir_torch.scene.lights import EmissiveCDF, build_emissive_cdf
from tpu_restir_torch.scene.materials import (MaterialSpec, MaterialTable,
                                              build_material_table)
from tpu_restir_torch.scene.textures import TextureStack


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
    # clustered scenes (> cluster_size triangles, in BVH leaf order)
    cluster_min: Optional[torch.Tensor] = None   # (C, 3) cluster AABBs
    cluster_max: Optional[torch.Tensor] = None   # (C, 3)
    cluster_tris: Optional[torch.Tensor] = None  # (C, B, 9) v0/e1/e2 xyz
    cluster_size: int = 0                        # B (0: not clustered)
    # (C, 4, 384) Woop blocks of K7/K8, built only at B = 128
    cluster_woop: Optional[torch.Tensor] = None
    bvh: Optional[BVH8Arrays] = None           # wide BVH (accel/wide.py)
    textures: Optional[TextureStack] = None   # native-size padded stack
    envmap: Optional[torch.Tensor] = None      # (He, We, 3) float32 equirect

    @property
    def num_tris(self) -> int:
        return self.tri_v.shape[0]


def build_scene(vertices: np.ndarray, material_ids: np.ndarray,
                specs: List[MaterialSpec], device,
                vertex_normals: Optional[np.ndarray] = None,
                vertex_uvs: Optional[np.ndarray] = None,
                vertex_tangents: Optional[np.ndarray] = None,
                textures=None, envmap: Optional[np.ndarray] = None,
                cluster_size: int = 64) -> SceneArrays:
    """Host-side build (numpy), then one copy to `device`. `textures` is
    a TextureStack or a uniform (T, H, W, 3) image stack, `envmap` an
    (He, We, 3) image; both go to `device`. Scenes above
    `cluster_size` triangles are put in BVH2 leaf order (every per-triangle
    array permuted alike) and get the cluster blocks of the clustered
    traversal (`kernels/cluster_trace.py`) and the wide BVH collapsed from
    the same BVH2 (`accel/wide.py`), as at tpu_restir/scene/scene.py:80-107;
    at cluster_size 128 also the Woop blocks of its Woop variant
    (`ptrace_mxu`, K7/K8)."""
    v = np.asarray(vertices, np.float32)
    n_tris = v.shape[0]
    cluster_min = cluster_max = cluster_tris = cluster_woop = bvh8 = None
    if n_tris > cluster_size:
        from tpu_restir_torch.accel.bvh import build_bvh2

        # the collapse keeps the BVH2's order (its leaf order)
        bvh8 = collapse_bvh8(build_bvh2(v, leaf_size=4))
        perm = bvh8.order
        v = v[perm]
        material_ids = np.asarray(material_ids)[perm]
        if vertex_normals is not None:
            vertex_normals = np.asarray(vertex_normals)[perm]
        if vertex_uvs is not None:
            vertex_uvs = np.asarray(vertex_uvs)[perm]
        if vertex_tangents is not None:
            vertex_tangents = np.asarray(vertex_tangents)[perm]
        cluster_min, cluster_max, cluster_tris = build_clusters(
            v, cluster_size)
        if cluster_size == WOOP_BLOCK:
            cluster_woop = build_cluster_woop(build_woop_matrices(v),
                                              cluster_size)
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
        woop=dev(build_woop_matrices(v)),
        cluster_min=None if cluster_min is None else dev(cluster_min),
        cluster_max=None if cluster_max is None else dev(cluster_max),
        cluster_tris=None if cluster_tris is None else dev(cluster_tris),
        cluster_size=0 if cluster_min is None else cluster_size,
        cluster_woop=None if cluster_woop is None else dev(cluster_woop),
        bvh=None if bvh8 is None else bvh8.to_device(device),
        textures=_as_texture_stack(textures, device),
        envmap=None if envmap is None else dev(envmap))


def _as_texture_stack(textures, device) -> Optional[TextureStack]:
    """A TextureStack (moved to device) or a uniform (T, H, W, 3) image
    stack (every texture its full size, CLAMP), as
    tpu_restir/scene/scene.py:160-169."""
    if textures is None:
        return None
    if isinstance(textures, TextureStack):
        return textures.to(device)
    arr = np.asarray(textures, np.float32)
    t, h, w = arr.shape[0], arr.shape[1], arr.shape[2]
    return TextureStack(
        data=torch.tensor(arr, device=device),
        sizes=torch.tensor([[h, w]] * t, dtype=torch.int32, device=device),
        modes=torch.zeros((t,), dtype=torch.int32, device=device))


def build_clusters(v: np.ndarray, block: int):
    """Leaf-ordered triangles (N, 3, 3) float32 -> (cluster_min,
    cluster_max (C, 3), cluster_tris (C, B, 9)) over consecutive chunks of
    B = block triangles. The AABBs pad the last chunk by repeating the last
    triangle; the blocks pad it with zero rows (zero edges: det = 0, never
    hit). Channels: v0, e1 = v1 - v0, e2 = v2 - v0, xyz each (the first 9
    lanes of the JAX package's (C, B, 128) blocks)."""
    n = v.shape[0]
    c = -(-n // block)
    pad = c * block - n
    vp = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) if pad else v
    vc = vp.reshape(c, block * 3, 3)
    tris = np.zeros((c * block, 9), np.float32)
    tris[:n, 0:3] = v[:, 0]
    tris[:n, 3:6] = v[:, 1] - v[:, 0]
    tris[:n, 6:9] = v[:, 2] - v[:, 0]
    return (vc.min(axis=1).astype(np.float32),
            vc.max(axis=1).astype(np.float32), tris.reshape(c, block, 9))
