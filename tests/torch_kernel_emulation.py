"""What the CPU emulations of the clustered kernels' skips share: a warp's
vote (`per_group`) and the Woop terrain they run on (`woop_terrain`).
Shared by tests/test_torch_closest_skips.py (K7),
tests/test_torch_any_skips.py (K6, K8) and tests/test_torch_k5_cull.py
(K5)."""

import functools

import chip_smoke
from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.scene.procedural import terrain_scene


def per_group(x):
    """(A, ..., P) -> the same shape: any lane of the ray's group of 32
    (a warp) along the last axis."""
    shape = x.shape
    g = x.reshape(*shape[:-1], ct.P // 32, 32).any(-1, keepdim=True)
    return g.expand(*shape[:-1], ct.P // 32, 32).reshape(shape)


@functools.cache
def woop_terrain():
    """terrain_scene(10_000) rebuilt at cluster size 128: 79 clusters,
    built once per test process."""
    return chip_smoke._woop_rebuild(terrain_scene("cpu", 10_000), "cpu")
