"""The port's clustered traversal ("ptrace": phase 1 and the plain versions
of K5/K6 and of their Woop variant K7/K8, `kernels/cluster_trace.py`, and
its use in `render/intersect.py`) against the JAX package's, whose Pallas
kernels run in the interpreter on the CPU as tests/test_ptrace.py runs
them.

Tolerances:
  * phase 1 (tfar clamp, packet counts, shortlists, entry distances) is
    the same float32 arithmetic in the same order: exact;
  * hit ids and occlusion masks are exact, except on rays whose
    barycentric, t-range or tie margin is under 1e-6 over every triangle
    of the scene (there one rounding decides: XLA may contract a multiply
    and an add that PyTorch rounds apart); those are counted and must stay
    under 0.1% of the rays. t: allclose at 1e-5. u, v: within 1e-5 plus
    16 float32 ulps of the test's cancellation, |o - v0| |e| / |det|: u
    is a difference of products of size |o - v0| |e| divided by det, so a
    ray that passes far from a small triangle (t = 7 against edges of 0.1
    on terrain_scene(20_000)) turns one rounding of either side into
    1e-5 of u;
  * gradients of the detached winner: rtol 2e-4, atol 2e-5, as
    tests/test_ptrace.py holds the JAX backends to each other;
  * the Woop variant (K7/K8, terrain_scene(5_000) rebuilt at cluster size
    128 as tests/test_ptrace.py builds it): the JAX kernels take the six
    dot products as jnp.dot at HIGHEST precision, which XLA on the CPU may
    sum in another order or with FMA; a Woop term o_x w_0 reaches ~400 on
    that terrain (w ~ 1 / edge), so one rounding of a sum moves u, v or t
    by up to ~1e-4. Ids and masks are exact except on rays within
    WOOP_MARGIN = 1e-4 of a barycentric bound (u, v, u + v against the
    1e-5 slack), of the t range or of a t tie over every triangle of the
    scene, and those may be at most 0.1% of the rays (on 640 rays: none);
    t within rtol 1e-5, u and v within the conditioning bound above.

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir.config import IntersectorConfig as JIntersectorConfig
from tpu_restir.kernels import cluster_trace as jct
from tpu_restir.kernels.woop import build_woop_matrices as j_build_woop
from tpu_restir.render import intersect as jintersect
from tpu_restir.scene.materials import MaterialSpec as JMaterialSpec
from tpu_restir.scene.materials import MatType as JMatType
from tpu_restir.scene.procedural import terrain_scene as j_terrain
from tpu_restir.scene.procedural import triangle_soup as j_soup
from tpu_restir.scene.scene import build_scene as j_build_scene
from tpu_restir_torch import convert, tracing
from tpu_restir_torch.config import IntersectorConfig
from tpu_restir_torch.kernels import cluster_trace as tct
from tpu_restir_torch.render import intersect as tintersect
from tpu_restir_torch.scene.cornell import cornell_box as t_cornell_box
from tpu_restir_torch.scene.procedural import TERRAIN_SPECS
from tpu_restir_torch.scene.procedural import terrain_scene as t_terrain
from tpu_restir_torch.scene.procedural import triangle_soup as t_soup
from tpu_restir_torch.scene.scene import SceneArrays, build_scene

MARGIN = 1e-6
WOOP_MARGIN = 1e-4
MAX_MARGIN_SHARE = 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
J_PT = JIntersectorConfig(backend="ptrace")
T_PT = IntersectorConfig(backend="ptrace")
J_MXU = JIntersectorConfig(backend="ptrace", ptrace_mxu=True)
T_MXU = IntersectorConfig(backend="ptrace", ptrace_mxu=True)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jct.INTERPRET = True
    yield
    jct.INTERPRET = False


_BUILDERS = {
    "terrain3k": (lambda: j_terrain(3_000), lambda: t_terrain("cpu", 3_000)),
    "soup1500": (lambda: j_soup(1_500), lambda: t_soup("cpu", 1_500)),
    "terrain5k": (lambda: j_terrain(5_000), lambda: t_terrain("cpu", 5_000)),
    "terrain20k": (lambda: j_terrain(20_000),
                   lambda: t_terrain("cpu", 20_000)),
}
_BUILT = {}


def _scenes(name):
    """(JAX scene, port scene), built once per test process. "woop5k" is
    terrain5k rebuilt at cluster size 128 with the terrain's materials,
    the scene of tests/test_ptrace.py's Woop-variant test."""
    if name not in _BUILT:
        if name == "woop5k":
            js, ts = _scenes("terrain5k")
            jspecs = [JMaterialSpec(s.name, JMatType.LAMBERT,
                                    diffuse=s.diffuse, emission=s.emission)
                      for s in TERRAIN_SPECS]
            _BUILT[name] = (
                j_build_scene(np.asarray(js.tri_v), np.asarray(js.tri_mat),
                              jspecs, cluster_size=128),
                build_scene(ts.tri_v.numpy(), ts.tri_mat.numpy(),
                            TERRAIN_SPECS, "cpu", cluster_size=128))
        else:
            j, t = _BUILDERS[name]
            _BUILT[name] = (j(), t())
    return _BUILT[name]


def _random_rays(seed, n, extent, tfar=1e4):
    g = np.random.default_rng(seed)
    o = g.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o, d, np.full(n, 1e-3, np.float32),
            np.full(n, tfar, np.float32))


def _grid_rays(seed, h, w):
    """Rays of one eye through random points of the terrain, (h, w, 3)."""
    g = np.random.default_rng(seed)
    o = np.tile(np.array([0.0, -6.0, 4.0], np.float32), (h * w, 1))
    at = g.uniform(-4, 4, (h * w, 3)).astype(np.float32)
    at[:, 2] = 0.3
    d = at - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.reshape(h, w, 3), d.reshape(h, w, 3)


# (scene, rays, shadow tfar, factor): 700 rays is not a packet multiple;
# every third ray of "dead" has tfar = -1; "factor4" forces superclusters
# (closest-hit cull mode 5 at C = 313)
CASES = {
    "soup700": ("soup1500", lambda: _random_rays(31, 700, 2.0), 1.5, 1),
    "terrain_dead": ("terrain5k", lambda: _dead(_random_rays(33, 512, 4.0)),
                     2.0, 1),
    "terrain20k_factor4": ("terrain20k", lambda: _random_rays(35, 768, 5.0),
                           3.0, 4),
}


def _dead(rays):
    o, d, tn, tf = rays
    tf = tf.copy()
    tf[::3] = -1.0
    return o, d, tn, tf


def _margin(ts, o, d, tn, tf):
    """Per ray: the least distance of any triangle's test to a decision
    boundary (barycentric edges, the t range, t ties), from the plain
    test over every triangle of the scene."""
    tr = ts.cluster_tris.reshape(1, -1, 9)
    out = []
    for s in range(0, o.shape[0], 128):
        sl = slice(s, s + 128)
        ch = [torch.from_numpy(np.ascontiguousarray(x[sl]))[None, None]
              for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                        d[:, 2], tn, tf)]
        t, u, v, ok = (x[0].numpy().astype(np.float64).T
                       for x in tct._mt(tr, *ch))
        fin = np.isfinite(t) & (np.abs(t) < 1e30)
        tt = np.where(fin, t, 0.0)
        with np.errstate(invalid="ignore"):
            m = np.minimum.reduce([
                np.abs(u), np.abs(v), np.abs(1.0 - u - v),
                np.abs(tt - tn[sl, None]),
                np.where(np.isfinite(tf[sl, None]),
                         np.abs(tt - tf[sl, None]), np.inf)])
        m = np.where(fin, np.nan_to_num(m, nan=0.0), np.inf).min(axis=1)
        ts_ = np.sort(np.where(ok > 0, t, np.inf), axis=1)
        with np.errstate(invalid="ignore"):
            tie = np.abs(ts_[:, 1] - ts_[:, 0]) \
                / np.maximum(np.abs(ts_[:, 0]), 1.0)
        out.append(np.minimum(m, np.where(np.isfinite(tie), tie, np.inf)))
    return np.concatenate(out)


def _uv_tol(ts, o, d, tri):
    """Per ray: the u, v tolerance of the module docstring, for the
    winning triangle tri (>= 0)."""
    tr = ts.cluster_tris.reshape(-1, 9)[torch.from_numpy(tri).long()] \
        .numpy().astype(np.float64)
    e1, e2 = tr[:, 3:6], tr[:, 6:9]
    det = np.abs(np.sum(e1 * np.cross(d, e2), -1))
    scale = np.linalg.norm(o - tr[:, 0:3], axis=-1) * np.maximum(
        np.linalg.norm(e1, axis=-1), np.linalg.norm(e2, axis=-1))
    return 1e-5 + 16 * np.finfo(np.float32).eps * scale / det


def _check_closest(ts, got, want, o, d, tn, tf, what):
    """Ids within the margin rules; t, u, v of the rays with the same
    winner within the module docstring's tolerances. -> rays compared."""
    same = _check_ids(got[3], want[3], _margin(ts, o, d, tn, tf), what)
    hit = same & (want[3] >= 0)
    np.testing.assert_allclose(got[0][hit], want[0][hit], **TOL)
    tol = _uv_tol(ts, o[hit], d[hit], want[3][hit])
    for g, w in zip(got[1:3], want[1:3]):
        assert np.all(np.abs(g[hit] - w[hit]) <= tol), what
    return hit


def _check_ids(got, want, margin, what):
    bad = got != want
    assert np.all(margin[bad] < MARGIN), \
        f"{what}: {int(bad.sum())} mismatches, some away from any margin"
    assert bad.sum() <= MAX_MARGIN_SHARE * len(got), what
    return ~bad


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("case", list(CASES))
def test_shortlists_match_jax(case):
    """tfar clamp, padding, packet counts, shortlists and entry distances
    of phase 1, exactly; the JAX package pads to 8 packets, the port to 1,
    and the JAX package's extra packets are empty."""
    name, rays, _tfs, factor = CASES[case]
    js, ts = _scenes(name)
    o, d, tn, tf = rays()
    scmin, scmax = jct._super_boxes(js.cluster_min, js.cluster_max, factor)
    _r, cnt, sl, ent, _b, _rp, _n = jct._pack(*_j(o, d, tn, tf), scmin,
                                             scmax, scmin, scmax)
    pk = tct.pack(ts.cluster_min, ts.cluster_max, *_t(o, d, tn, tf), factor)
    rp = pk.count.shape[0]
    assert rp == -(-o.shape[0] // tct.P) and pk.n_rays == o.shape[0]
    np.testing.assert_array_equal(pk.count.numpy(), np.asarray(cnt)[:rp, 0])
    assert not np.asarray(cnt)[rp:].any()
    np.testing.assert_array_equal(pk.shortlist.numpy(), np.asarray(sl)[:rp])
    np.testing.assert_array_equal(pk.entry.numpy(), np.asarray(ent)[:rp])
    assert int(pk.count.max()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_trace_closest_plain_matches_jax(case):
    name, rays, _tfs, factor = CASES[case]
    js, ts = _scenes(name)
    o, d, tn, tf = rays()
    want = [np.asarray(x) for x in jct.trace_closest(
        js.cluster_tris, js.cluster_min, js.cluster_max, *_j(o, d, tn, tf),
        factor=factor)]
    before = tracing.counted("launch.")
    got = [x.numpy() for x in tct.trace_closest(
        ts.cluster_tris, ts.cluster_min, ts.cluster_max, *_t(o, d, tn, tf),
        factor=factor)]
    assert tracing.counted("launch.") == before          # the plain version launches none
    assert got[3].dtype == np.int32 and got[0].shape == (o.shape[0],)
    hit = _check_closest(ts, got, want, o, d, tn, tf, case)
    assert hit.sum() > 20
    assert np.all(np.isinf(got[0][got[3] < 0]))
    assert not (got[3][tf < tn] >= 0).any()      # dead rays miss


@pytest.mark.parametrize("case", list(CASES))
def test_trace_any_plain_matches_jax(case):
    name, rays, tfs, factor = CASES[case]
    js, ts = _scenes(name)
    o, d, tn, tf = rays()
    tf = np.where(tf < tn, tf, np.float32(tfs)).astype(np.float32)
    want = np.asarray(jct.trace_any(
        js.cluster_tris, js.cluster_min, js.cluster_max, *_j(o, d, tn, tf),
        factor=factor))
    got = tct.trace_any(ts.cluster_tris, ts.cluster_min, ts.cluster_max,
                        *_t(o, d, tn, tf), factor=factor).numpy()
    assert got.dtype == np.bool_
    _check_ids(got, want, _margin(ts, o, d, tn, tf), case)
    assert 0 < got.sum() < got.size
    assert not got[tf < tn].any()                # dead rays are visible


def test_supercluster_factor_matches_flat():
    """factor 4 (superclusters, closest-hit cull mode 5) gives the flat
    factor-1 result exactly: the same clusters are tested, in groups."""
    _js, ts = _scenes("terrain20k")
    o, d, tn, tf = _t(*_random_rays(35, 768, 5.0))
    args = (ts.cluster_tris, ts.cluster_min, ts.cluster_max, o, d, tn)
    for a, b in zip(tct.trace_closest(*args, tf, factor=1),
                    tct.trace_closest(*args, tf, factor=4)):
        assert torch.equal(a, b)
    tfs = torch.full_like(tf, 3.0)
    assert torch.equal(tct.trace_any(*args, tfs, factor=1),
                       tct.trace_any(*args, tfs, factor=4))
    assert tct._skip_for("closest", ts.cluster_tris.shape[0], 4) == 5


def test_intersect_swizzled_grid_matches_jax():
    """A 16x64 pixel grid goes through the 8x32-tile swizzle on both sides;
    the port's grid query equals its own flat query exactly, and the JAX
    query within the stated rules."""
    js, ts = _scenes("terrain5k")
    o, d = _grid_rays(32, 16, 64)
    tn, tf = np.float32(1e-3), np.float32(1e4)
    hj = jintersect.intersect_closest(js, *_j(o, d), tn, tf, J_PT)
    ht = tintersect.intersect_closest(ts, *_t(o, d), tn, tf, T_PT)
    hf = tintersect.intersect_closest(ts, *_t(o.reshape(-1, 3),
                                              d.reshape(-1, 3)), tn, tf, T_PT)
    assert ht.tri.shape == (16, 64)
    for name in ("t", "u", "v", "tri", "hit"):
        assert torch.equal(getattr(ht, name).reshape(-1), getattr(hf, name))
    n = 16 * 64
    of, df = o.reshape(-1, 3), d.reshape(-1, 3)
    tnf, tff = np.full(n, tn), np.full(n, tf)
    _check_closest(ts, [getattr(ht, k).numpy().reshape(-1)
                        for k in ("t", "u", "v", "tri")],
                   [np.asarray(getattr(hj, k)).reshape(-1)
                    for k in ("t", "u", "v", "tri")], of, df, tnf, tff,
                   "grid")
    assert ht.hit.numpy().mean() > 0.5
    oj = jintersect.intersect_any(js, *_j(o, d), tn, np.float32(6.0), J_PT)
    ot = tintersect.intersect_any(ts, *_t(o, d), tn, 6.0, T_PT)
    _check_ids(ot.numpy().reshape(-1), np.asarray(oj).reshape(-1),
               _margin(ts, of, df, tnf, np.full(n, np.float32(6.0))),
               "grid any")


def test_batched_queries_swizzle_per_image():
    """A (Q, H, W) stack of queries folds each image on its own: the same
    result as each image queried alone, and as the unswizzled flat query."""
    _js, ts = _scenes("terrain5k")
    o1, d1 = _grid_rays(40, 8, 32)
    o2, d2 = _grid_rays(41, 8, 32)
    o, d = _t(np.stack([o1, o2]), np.stack([d1, d2]))
    tn, tf = torch.tensor(1e-3), torch.tensor(1e4)
    both = tintersect.intersect_closest(ts, o, d, tn, tf, T_PT)
    for q in range(2):
        one = tintersect.intersect_closest(ts, o[q], d[q], tn, tf, T_PT)
        assert torch.equal(both.tri[q], one.tri)
        assert torch.equal(both.t[q], one.t)
    flat = tintersect.intersect_closest(ts, o.reshape(-1, 3),
                                        d.reshape(-1, 3), tn, tf, T_PT)
    assert torch.equal(both.tri.reshape(-1), flat.tri)


def test_chunks_pad_like_one_query():
    """Queries cut into chunks of ptrace_chunk rays give the unchunked
    result; the tail chunk is padded with dead rays."""
    _js, ts = _scenes("soup1500")
    o, d, tn, tf = _t(*_random_rays(36, 1000, 2.0))
    whole = tintersect.intersect_closest(ts, o, d, tn, tf, T_PT)
    cut = tintersect.intersect_closest(
        ts, o, d, tn, tf, dataclasses.replace(T_PT, ptrace_chunk=256))
    assert torch.equal(whole.tri, cut.tri) and torch.equal(whole.t, cut.t)
    tfs = torch.full_like(tf, 1.5)
    assert torch.equal(
        tintersect.intersect_any(ts, o, d, tn, tfs, T_PT),
        tintersect.intersect_any(ts, o, d, tn, tfs,
                                 dataclasses.replace(T_PT, ptrace_chunk=256)))


def test_ptrace_gradient_matches_jax():
    """d(t, u, v)/d(o, d) through the ptrace query: the detached winner's
    Woop derivative, against jax.grad of the JAX ptrace query."""
    js, ts = _scenes("terrain3k")
    g = np.random.default_rng(34)
    n = 300
    o = np.tile(np.array([0.0, -5.0, 3.0], np.float32), (n, 1))
    at = g.uniform(-3, 3, (n, 3)).astype(np.float32)
    at[:, 2] = 0.2
    d = at - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w = g.standard_normal((3, n)).astype(np.float32)
    tn, tf = np.float32(1e-3), np.float32(1e4)

    def jloss(o, d):
        h = jintersect.intersect_closest(js, o, d, tn, tf, J_PT)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0) * w[0] + h.u * w[1]
                       + h.v * w[2])

    go_j, gd_j = jax.grad(jloss, argnums=(0, 1))(*_j(o, d))
    ot, dt = (x.requires_grad_(True) for x in _t(o, d))
    h = tintersect.intersect_closest(ts, ot, dt, tn, tf, T_PT)
    ww = torch.from_numpy(w)
    loss = (torch.where(h.hit, h.t, 0.0) * ww[0] + h.u * ww[1]
            + h.v * ww[2]).sum()
    go_t, gd_t = torch.autograd.grad(loss, (ot, dt))
    assert float(go_t.abs().max()) > 0.0
    np.testing.assert_allclose(go_t.numpy(), np.asarray(go_j), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(gd_t.numpy(), np.asarray(gd_j), rtol=2e-4,
                               atol=2e-5)
    occ = tintersect.intersect_any(ts, ot, dt, tn, tf, T_PT)
    assert occ.dtype == torch.bool and not occ.requires_grad


def test_backend_selection():
    """'auto' takes the small-scene kernels up to fused_max_tris triangles
    and the clustered traversal above; a backend the scene lacks the
    arrays for raises."""
    _js, big = _scenes("soup1500")
    small = t_cornell_box("cpu")
    assert tintersect._backend(small, IntersectorConfig()) == "fused"
    assert tintersect._backend(big, IntersectorConfig()) == "ptrace"
    assert tintersect._backend(
        big, IntersectorConfig(fused_max_tris=4096)) == "fused"
    with pytest.raises(ValueError, match="no cluster blocks"):
        tintersect._backend(small, T_PT)
    with pytest.raises(ValueError, match="fused_max_tris"):
        tintersect._backend(big, IntersectorConfig(backend="fused"))
    # ptrace_mxu is a variant of "ptrace" (K7/K8 where they apply)
    assert tintersect._backend(big, T_MXU) == "ptrace"
    assert tintersect._backend(
        big, IntersectorConfig(backend="fcluster")) == "fcluster"
    with tracing.recording() as rec:
        o, d, tn, tf = _t(*_random_rays(37, 10, 2.0))
        tintersect.intersect_any(big, o, d, tn, tf)
    log = tintersect.queries(rec)
    assert log == [{"kind": "any", "backend": "ptrace", "rays": 10}]


@pytest.mark.parametrize("c,factor", [(9, 1), (64, 1), (65, 1), (1569, 1),
                                      (5000, 2), (15_700, 4),
                                      (20_000, 5)])
def test_cull_mode_and_factor_match_jax(c, factor):
    """The factor and any hit's cull mode are the JAX package's; closest
    hit's too, except at factor 1 above SMALL_C clusters, where the port
    culls in mode 5 on the cluster boxes and the TPU default is 0."""
    assert tct.pick_factor(c) == jct.pick_factor(c)
    assert tct._skip_for("any", c, factor) == jct._skip_for("any", c, factor)
    want = jct._skip_for("closest", c, factor)
    if factor == 1 and c > tct.SMALL_C:
        assert want == 0
        want = 5
    assert tct._skip_for("closest", c, factor) == want


def test_plain_versions_on_cpu_only():
    """The wrappers take the plain versions only for CPU tensors and refuse
    other devices."""
    _js, ts = _scenes("soup1500")
    o, d, tn, tf = _t(*_random_rays(38, 16, 2.0))
    with pytest.raises(ValueError, match="unsupported device"):
        tct.trace_any(ts.cluster_tris.to("meta"), ts.cluster_min.to("meta"),
                      ts.cluster_max.to("meta"), o.to("meta"), d.to("meta"),
                      tn.to("meta"), tf.to("meta"))


# ---------------------------------------------------------------------------
# The Woop variant: K7/K8 (ptrace_mxu), plain versions against the JAX
# kernels `_closest_kernel_mxu` / `_any_kernel_mxu` in the interpreter
# ---------------------------------------------------------------------------

def _woop_margin(ts, o, d, tn, tf):
    """Per ray: the least distance of the Woop test of any triangle of the
    scene to a decision boundary (u, v and u + v against the 1e-5 slack,
    the t range, t ties), from the plain test over every Woop block."""
    w = ts.cluster_woop
    eps = 1e-5
    out = []
    for s in range(0, o.shape[0], 128):
        sl = slice(s, s + 128)
        ch = [torch.from_numpy(np.ascontiguousarray(x[sl]))[None, None]
              for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                        d[:, 2], tn, tf)]
        t, u, v, ok = (x.numpy().astype(np.float64)
                       .transpose(2, 0, 1).reshape(-1, w.shape[0] * 128)
                       for x in tct._woop(w, *ch))
        fin = np.isfinite(t) & (np.abs(t) < 1e30)
        tt = np.where(fin, t, 0.0)
        with np.errstate(invalid="ignore"):
            m = np.minimum.reduce([
                np.abs(u + eps), np.abs(v + eps), np.abs(1.0 + eps - u - v),
                np.abs(tt - tn[sl, None]),
                np.where(np.isfinite(tf[sl, None]),
                         np.abs(tt - tf[sl, None]), np.inf)])
        m = np.where(fin, np.nan_to_num(m, nan=0.0), np.inf).min(axis=1)
        ts_ = np.sort(np.where(ok > 0, t, np.inf), axis=1)
        with np.errstate(invalid="ignore"):
            tie = np.abs(ts_[:, 1] - ts_[:, 0]) \
                / np.maximum(np.abs(ts_[:, 0]), 1.0)
        out.append(np.minimum(m, np.where(np.isfinite(tie), tie, np.inf)))
    return np.concatenate(out)


def _check_woop_ids(got, want, margin, what):
    bad = got != want
    assert np.all(margin[bad] < WOOP_MARGIN), \
        f"{what}: {int(bad.sum())} mismatches, some away from any margin"
    assert bad.sum() <= MAX_MARGIN_SHARE * len(got), what
    return ~bad


def test_woop_blocks_match_jax():
    """The (C, 4, 384) Woop blocks equal rows 0-3 of the JAX package's
    (C, 8, 384) blocks (rows 4-7 are zero padding), through build_scene
    and through convert.from_tree; a degenerate triangle's inf marker is
    zeroed, as in the JAX builder."""
    js, ts = _scenes("woop5k")
    jw = np.asarray(js.cluster_woop)
    c = ts.cluster_tris.shape[0]
    assert ts.cluster_size == 128 and ts.cluster_woop.shape == (c, 4, 384)
    np.testing.assert_array_equal(ts.cluster_woop.numpy(), jw[:, :4])
    assert not jw[:, 4:].any()
    got = convert.from_tree(SceneArrays, jax.tree.map(np.asarray, js), "cpu")
    assert torch.equal(got.cluster_woop, ts.cluster_woop)
    assert torch.equal(got.cluster_tris, ts.cluster_tris)
    v = np.random.default_rng(3).random((130, 3, 3)).astype(np.float32)
    v[5, 2] = v[5, 0]                              # degenerate
    woop = j_build_woop(v)
    assert not np.isfinite(woop[5]).all()
    want = jct.build_cluster_woop(woop, 128)
    blocks = tct.build_cluster_woop(woop, 128)
    assert np.isfinite(blocks).all()
    np.testing.assert_array_equal(blocks, want[:, :4])
    with pytest.raises(ValueError, match="128"):
        tct.build_cluster_woop(woop, 64)


def test_trace_closest_mxu_plain_matches_jax():
    """Plain K7 against `_trace_closest_mxu` (the JAX kernel in the
    interpreter) on tests/test_ptrace.py's rays (seed 41, 640 rays)."""
    js, ts = _scenes("woop5k")
    o, d, tn, tf = _random_rays(41, 640, 4.0)
    want = [np.asarray(x) for x in jct._trace_closest_mxu(
        js.cluster_woop, js.cluster_min, js.cluster_max, *_j(o, d, tn, tf),
        128)]
    pk = tct.pack(ts.cluster_min, ts.cluster_max, *_t(o, d, tn, tf), 1)
    got = [x[:640].numpy() for x in tct.trace_closest_mxu_ref(
        ts.cluster_woop, pk)]
    assert got[3].dtype == np.int32
    same = _check_woop_ids(got[3], want[3], _woop_margin(ts, o, d, tn, tf),
                           "closest")
    hit = same & (want[3] >= 0)
    assert hit.sum() > 100
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-5,
                               atol=1e-5)
    tol = _uv_tol(ts, o[hit], d[hit], want[3][hit])
    for g, w in zip(got[1:3], want[1:3]):
        assert np.all(np.abs(g[hit] - w[hit]) <= tol)
    assert np.all(np.isinf(got[0][got[3] < 0]))


def test_trace_any_mxu_plain_matches_jax():
    """Plain K8 against `_trace_any_mxu`, shadow segments of half the
    range and a third of them dead."""
    js, ts = _scenes("woop5k")
    o, d, tn, tf = _dead(_random_rays(41, 640, 4.0))
    tf = np.where(tf < tn, tf, np.float32(2.0)).astype(np.float32)
    want = np.asarray(jct._trace_any_mxu(
        js.cluster_woop, js.cluster_min, js.cluster_max, *_j(o, d, tn, tf),
        128))
    pk = tct.pack(ts.cluster_min, ts.cluster_max, *_t(o, d, tn, tf), 1)
    got = tct.trace_any_mxu_ref(ts.cluster_woop, pk)[:640].numpy()
    assert got.dtype == np.bool_
    _check_woop_ids(got, want, _woop_margin(ts, o, d, tn, tf), "any")
    assert 0 < got.sum() < got.size
    assert not got[tf < tn].any()


def test_intersect_ptrace_mxu_grid_matches_jax():
    """A 16x64 pixel grid through the query with ptrace_mxu on both sides
    (8x32-tile swizzle, the Woop kernels): ids within the Woop margin
    rules, and the occlusion query likewise."""
    js, ts = _scenes("woop5k")
    o, d = _grid_rays(32, 16, 64)
    tn, tf = np.float32(1e-3), np.float32(1e4)
    hj = jintersect.intersect_closest(js, *_j(o, d), tn, tf, J_MXU)
    ht = tintersect.intersect_closest(ts, *_t(o, d), tn, tf, T_MXU)
    n = 16 * 64
    of, df = o.reshape(-1, 3), d.reshape(-1, 3)
    tnf, tff = np.full(n, tn), np.full(n, tf)
    same = _check_woop_ids(ht.tri.numpy().reshape(-1),
                           np.asarray(hj.tri).reshape(-1),
                           _woop_margin(ts, of, df, tnf, tff), "grid")
    hit = same & (np.asarray(hj.tri).reshape(-1) >= 0)
    assert hit.mean() > 0.5
    np.testing.assert_allclose(ht.t.numpy().reshape(-1)[hit],
                               np.asarray(hj.t).reshape(-1)[hit], rtol=1e-5,
                               atol=1e-5)
    oj = jintersect.intersect_any(js, *_j(o, d), tn, np.float32(6.0), J_MXU)
    ot = tintersect.intersect_any(ts, *_t(o, d), tn, 6.0, T_MXU)
    _check_woop_ids(ot.numpy().reshape(-1), np.asarray(oj).reshape(-1),
                    _woop_margin(ts, of, df, tnf,
                                 np.full(n, np.float32(6.0))), "grid any")


def _spy(monkeypatch):
    """Record which plain phase-2 function each query takes."""
    calls = []
    for name in ("closest_packets", "any_packets", "closest_packets_mxu",
                 "any_packets_mxu"):
        fn = getattr(tct, name)

        def rec(*a, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*a)

        monkeypatch.setattr(tct, name, rec)
    return calls


def test_woop_selection_rule(monkeypatch):
    """K7/K8 run when Woop blocks are given, B is 128 and the factor is 1
    (cluster_trace.py:1122-1127); otherwise K5/K6, with results equal to
    the query without the blocks: at B = 64 (no blocks: the port's
    terrain5k under ptrace_mxu, or blocks beside 64-row clusters), and at
    B = 128 once the scene needs superclusters (SUPER_MAX lowered so that
    pick_factor gives 3) or a factor is forced."""
    calls = _spy(monkeypatch)
    _js, ts = _scenes("woop5k")
    _js, t64 = _scenes("terrain5k")
    o, d, tn, tf = _t(*_random_rays(42, 300, 4.0))
    args = (ts.cluster_tris, ts.cluster_min, ts.cluster_max, o, d, tn, tf)
    tct.trace_closest(*args, cwoop=ts.cluster_woop)
    tct.trace_any(*args, cwoop=ts.cluster_woop)
    assert calls == ["closest_packets_mxu", "any_packets_mxu"]
    calls.clear()

    plain = tct.trace_closest(*args)
    forced = tct.trace_closest(*args, cwoop=ts.cluster_woop, factor=4)
    monkeypatch.setattr(tct, "SUPER_MAX", 16)
    assert tct.pick_factor(ts.cluster_tris.shape[0]) == 3
    sup = tct.trace_closest(*args, cwoop=ts.cluster_woop)
    assert calls == ["closest_packets"] * 3
    for a, b, c in zip(plain, forced, sup):
        assert torch.equal(a, b) and torch.equal(a, c)
    monkeypatch.setattr(tct, "SUPER_MAX", 4096)
    calls.clear()

    fake = torch.zeros((t64.cluster_tris.shape[0], 4, 384))
    a64 = (t64.cluster_tris, t64.cluster_min, t64.cluster_max, o, d, tn, tf)
    for x, y in zip(tct.trace_closest(*a64),
                    tct.trace_closest(*a64, cwoop=fake)):
        assert torch.equal(x, y)
    assert t64.cluster_woop is None
    h0 = tintersect.intersect_closest(t64, o, d, tn, tf, T_PT)
    h1 = tintersect.intersect_closest(t64, o, d, tn, tf, T_MXU)
    assert torch.equal(h0.tri, h1.tri) and torch.equal(h0.t, h1.t)
    assert set(calls) == {"closest_packets"}


def test_ptrace_mxu_gradient_matches_jax():
    """d(t, u, v)/d(o, d) through the ptrace_mxu query: the detached
    winner's Woop derivative (the same VJP as K5's), against jax.grad of
    the JAX ptrace_mxu query."""
    js, ts = _scenes("woop5k")
    g = np.random.default_rng(44)
    n = 300
    o = np.tile(np.array([0.0, -5.0, 3.0], np.float32), (n, 1))
    at = g.uniform(-3, 3, (n, 3)).astype(np.float32)
    at[:, 2] = 0.2
    d = at - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w = g.standard_normal((3, n)).astype(np.float32)
    tn, tf = np.float32(1e-3), np.float32(1e4)

    def jloss(o, d):
        h = jintersect.intersect_closest(js, o, d, tn, tf, J_MXU)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0) * w[0] + h.u * w[1]
                       + h.v * w[2])

    go_j, gd_j = jax.grad(jloss, argnums=(0, 1))(*_j(o, d))
    ot, dt = (x.requires_grad_(True) for x in _t(o, d))
    h = tintersect.intersect_closest(ts, ot, dt, tn, tf, T_MXU)
    ww = torch.from_numpy(w)
    loss = (torch.where(h.hit, h.t, 0.0) * ww[0] + h.u * ww[1]
            + h.v * ww[2]).sum()
    go_t, gd_t = torch.autograd.grad(loss, (ot, dt))
    assert float(go_t.abs().max()) > 0.0
    np.testing.assert_allclose(go_t.numpy(), np.asarray(go_j), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(gd_t.numpy(), np.asarray(gd_j), rtol=2e-4,
                               atol=2e-5)
