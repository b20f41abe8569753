"""The port's clustered-scene build against the JAX package's, on the CPU.

The leaf order of a clustered scene decides every triangle id the
clustered traversal reports, so it must be the JAX package's exactly: the
port compiles the JAX package's own native builder with its flags
(`tpu_restir_torch.accel.bvh`). Everything built from that order (the
permuted triangle arrays, the cluster AABBs and blocks, the light CDF) is
then the same numpy arithmetic on both sides and is compared exactly, as
are the packet summaries of phase 1 (`accel.fcluster`).

Scenes: terrain_scene(5_000) (79 clusters: the any-hit query culls per
ray), many_lights_scene(500) (9 clusters: no cull) and
triangle_soup(1_500) (24 clusters, incoherent geometry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir.accel import fcluster as jfc
from tpu_restir.accel.bvh import build_bvh2 as j_build_bvh2
from tpu_restir.scene.cornell import many_lights_scene as j_many_lights
from tpu_restir.scene.procedural import terrain_scene as j_terrain
from tpu_restir.scene.procedural import triangle_soup as j_soup
from tpu_restir_torch import convert
from tpu_restir_torch.accel import bvh as tbvh
from tpu_restir_torch.accel import fcluster as tfc
from tpu_restir_torch.scene.cornell import many_lights_scene as t_many_lights
from tpu_restir_torch.scene.procedural import terrain_scene as t_terrain
from tpu_restir_torch.scene.procedural import triangle_soup as t_soup
from tpu_restir_torch.scene.scene import SceneArrays

SCENES = {
    "terrain5k": (lambda: j_terrain(5_000), lambda: t_terrain("cpu", 5_000),
                  79),
    "lights500": (lambda: j_many_lights(500),
                  lambda: t_many_lights("cpu", 500), 9),
    "soup1500": (lambda: j_soup(1_500), lambda: t_soup("cpu", 1_500), 24),
}


@pytest.fixture(scope="module")
def built():
    return {k: (j(), t()) for k, (j, t, _c) in SCENES.items()}


def _compare_scene(port: SceneArrays, ref):
    """Every field of the port's scene against the JAX scene, exactly; the
    port's cluster blocks are the first 9 channels of the JAX ones."""
    for name, val in convert.to_numpy(port).items():
        want = getattr(ref, name)
        if isinstance(val, dict):
            for sub, x in val.items():
                w = getattr(want, sub)
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(x, np.asarray(w),
                                                  err_msg=f"{name}.{sub}")
                else:
                    assert x == w, f"{name}.{sub}"
        elif name == "cluster_tris":
            np.testing.assert_array_equal(val, np.asarray(want)[..., :9])
            assert not np.asarray(want)[..., 9:].any()
        elif isinstance(val, np.ndarray):
            np.testing.assert_array_equal(val, np.asarray(want),
                                          err_msg=name)
        else:
            assert val == want, name


@pytest.mark.parametrize("name", list(SCENES))
def test_bvh2_matches_jax(name):
    """The port's builder gives the JAX builder's tree: same nodes, same
    primitive order."""
    # the scene's triangles in a shuffled order, so that the tree is built
    # from scratch and not from an order the builder has made
    v = np.asarray(SCENES[name][0]().tri_v)
    shuffled = v[np.random.default_rng(5).permutation(v.shape[0])]
    want = j_build_bvh2(shuffled, leaf_size=4)
    got = tbvh.build_bvh2(shuffled, leaf_size=4)
    for f in ("order", "node_min", "node_max", "left", "right", "start",
              "count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.max_depth == want.max_depth
    assert sorted(got.order.tolist()) == list(range(v.shape[0]))


@pytest.mark.parametrize("name", list(SCENES))
def test_clustered_scene_matches_jax(built, name):
    js, ts = built[name]
    c = SCENES[name][2]
    assert ts.cluster_tris.shape == (c, 64, 9)
    assert ts.cluster_size == js.cluster_size == 64
    _compare_scene(ts, js)


def test_convert_carries_clustered_scenes(built):
    """from_tree maps a JAX terrain scene's cluster arrays into the port's
    layout; the result equals the port's own build field by field."""
    js, ts = built["terrain5k"]
    got = convert.from_tree(SceneArrays, jax.tree.map(np.asarray, js), "cpu")
    want = convert.to_numpy(ts)
    for name, val in convert.to_numpy(got).items():
        if isinstance(val, dict):
            for sub, x in val.items():
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(x, want[name][sub],
                                                  err_msg=f"{name}.{sub}")
                else:
                    assert x == want[name][sub], f"{name}.{sub}"
        elif isinstance(val, np.ndarray):
            assert val.dtype == want[name].dtype, name
            np.testing.assert_array_equal(val, want[name], err_msg=name)
        else:
            assert val == want[name], name


def test_bvh_build_failure_raises(monkeypatch, tmp_path):
    """A builder that does not compile raises; nothing falls back."""
    bad = tmp_path / "accel.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tbvh, "_SRC", bad)
    monkeypatch.setattr(tbvh, "_LIB", None)
    monkeypatch.setattr(tbvh, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tbvh.build_bvh2(np.zeros((70, 3, 3), np.float32))


def _packet_rays(seed, n, dead_share):
    g = np.random.default_rng(seed)
    o = g.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tn = np.full(n, 1e-3, np.float32)
    tf = g.uniform(0.5, 20.0, n).astype(np.float32)
    dead = g.random(n) < dead_share
    tf[dead] = -1.0
    d[g.random(n) < 0.01] = np.nan          # NaN rays stay out of the hull
    return o, d, tn, tf


@pytest.mark.parametrize("dead_share", [0.0, 0.3])
def test_packet_bounds_and_clamp_match_jax(built, dead_share):
    js, ts = built["terrain5k"]
    o, d, tn, tf = _packet_rays(7, 1024, dead_share)
    lo = np.asarray(js.cluster_min).min(0)
    hi = np.asarray(js.cluster_max).max(0)
    want = np.asarray(jfc._clamp_tfar_bbox(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tn), jnp.asarray(tf),
        jnp.asarray(lo), jnp.asarray(hi)))
    got = tfc._clamp_tfar_bbox(*(torch.from_numpy(x) for x in (o, d, tn, tf)),
                               ts.cluster_min.amin(0), ts.cluster_max.amax(0))
    np.testing.assert_array_equal(got.numpy(), want)
    jb = jfc._packet_bounds(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tn),
                            jnp.asarray(want), 256)
    tb = tfc._packet_bounds(*(torch.from_numpy(x) for x in (o, d, tn)),
                            got, 256)
    for i, (g, w) in enumerate(zip(tb, jb)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=str(i))
