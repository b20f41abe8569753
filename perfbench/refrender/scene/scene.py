"""The reference's scene: the triangles in the order given, their
attributes, the material table, the emissive CDF and the Woop maps, and
for scenes above `intersect.FUSED_MAX` triangles the reference's own
clusters (consecutive runs of `intersect.CLUSTER` triangles in the order
of their centroids' 30-bit Morton codes, each with its box, and a box
over each run of `intersect.GROUP` clusters)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from perfbench.refrender.render.intersect import CLUSTER, FUSED_MAX, GROUP
from perfbench.refrender.scene.lights import EmissiveCDF, build_emissive_cdf
from perfbench.refrender.scene.materials import (MaterialSpec, MaterialTable,
                                                 build_material_table)


@dataclasses.dataclass
class Clusters:
    cmin: torch.Tensor    # (C, 3) box of each cluster
    cmax: torch.Tensor    # (C, 3)
    tris: torch.Tensor    # (C, B, 9) v0, e1, e2 (zero rows pad the last)
    ids: torch.Tensor     # (C, B) int32 triangle index (-1 on a pad row)
    smin: torch.Tensor    # (S, 3) box of each run of GROUP clusters
    smax: torch.Tensor    # (S, 3)


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
    clusters: Optional[Clusters] = None
    textures: Optional[object] = None
    envmap: Optional[torch.Tensor] = None

    @property
    def num_tris(self) -> int:
        return self.tri_v.shape[0]


def build_woop_matrices(tri_v: np.ndarray) -> np.ndarray:
    """(N, 3, 3) vertices -> (N, 3, 4) float32 maps, built in float64:
    the affine map sending each triangle to the unit triangle, its third
    row along the unscaled normal; degenerate triangles never hit."""
    v = np.asarray(tri_v, np.float64)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    a = np.stack([e1, e2, n], axis=-1)
    ok = np.abs(np.linalg.det(a)) > 1e-18
    inv = np.linalg.inv(np.where(ok[:, None, None], a, np.eye(3)[None]))
    trans = -np.einsum("nij,nj->ni", inv, v[:, 0])
    m = np.concatenate([inv, trans[:, :, None]], axis=-1)
    m[~ok] = 0.0
    m[~ok, 0, 3] = np.inf
    m[~ok, 1, 3] = np.inf
    return m.astype(np.float32)


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points (N, 3), scaled into their box."""
    lo, hi = c.min(0), c.max(0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-30) * 1023.0).astype(np.uint64)
    code = np.zeros(len(c), np.uint64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> np.uint64(bit)) & np.uint64(1)) \
                << np.uint64(3 * bit + axis)
    return code


def build_clusters(v: np.ndarray, device) -> Clusters:
    n = v.shape[0]
    order = np.argsort(_morton(v.mean(axis=1)), kind="stable")
    c = -(-n // CLUSTER)
    pad = c * CLUSTER - n
    ids = np.concatenate([order, np.full(pad, -1)]).astype(np.int32)
    vs = v[np.concatenate([order, np.repeat(order[-1:], pad)])]
    vc = vs.reshape(c, CLUSTER * 3, 3)
    tris = np.zeros((c * CLUSTER, 9), np.float32)
    tris[:n, 0:3] = v[order, 0]
    tris[:n, 3:6] = v[order, 1] - v[order, 0]
    tris[:n, 6:9] = v[order, 2] - v[order, 0]
    cmin, cmax = vc.min(axis=1), vc.max(axis=1)
    sc = -(-c // GROUP)
    spad = sc * GROUP - c
    smin = np.concatenate([cmin, np.repeat(cmin[-1:], spad, axis=0)])
    smax = np.concatenate([cmax, np.repeat(cmax[-1:], spad, axis=0)])
    return Clusters(
        cmin=torch.tensor(cmin, device=device),
        cmax=torch.tensor(cmax, device=device),
        smin=torch.tensor(smin.reshape(sc, GROUP, 3).min(axis=1),
                          device=device),
        smax=torch.tensor(smax.reshape(sc, GROUP, 3).max(axis=1),
                          device=device),
        tris=torch.tensor(tris.reshape(c, CLUSTER, 9), device=device),
        ids=torch.tensor(ids.reshape(c, CLUSTER), device=device))


def build_ref_scene(vertices: np.ndarray, material_ids: np.ndarray,
                    specs: List[MaterialSpec], device) -> SceneArrays:
    """Host-side build from the raw arrays (flat normals, zero uvs,
    tangents along the first edge), then one copy to `device`."""
    v = np.asarray(vertices, np.float32)
    n_tris = v.shape[0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    fn = np.cross(e1, e2)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    t = e1 / np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-20)
    mat_ids = np.asarray(material_ids, np.int32)
    emissive_mat = np.array(
        [any(c > 0 for c in s.emission) for s in specs], bool)

    def dev(a, dtype=np.float32):
        return torch.tensor(np.asarray(a, dtype), device=device)

    return SceneArrays(
        tri_v=dev(v), tri_v0=dev(v[:, 0]), tri_e1=dev(e1), tri_e2=dev(e2),
        tri_area=dev(areas),
        vtx_normal=dev(np.repeat(fn[:, None, :], 3, axis=1)),
        vtx_uv=dev(np.zeros((n_tris, 3, 2))),
        vtx_tangent=dev(np.repeat(t[:, None, :], 3, axis=1)),
        tri_mat=dev(mat_ids, np.int32),
        materials=build_material_table(specs, device),
        lights=build_emissive_cdf(areas.astype(np.float32),
                                  emissive_mat[mat_ids], device),
        woop=dev(build_woop_matrices(v)),
        clusters=(build_clusters(v, device) if n_tris > FUSED_MAX
                  else None))
