"""The port's clustered traversal ("ptrace": phase 1 and the plain versions
of K5/K6, `kernels/cluster_trace.py`, and its use in `render/intersect.py`)
against the JAX package's, whose Pallas kernels run in the interpreter on
the CPU as tests/test_ptrace.py runs them.

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
    tests/test_ptrace.py holds the JAX backends to each other.

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
from tpu_restir.render import intersect as jintersect
from tpu_restir.scene.procedural import terrain_scene as j_terrain
from tpu_restir.scene.procedural import triangle_soup as j_soup
from tpu_restir_torch.config import IntersectorConfig
from tpu_restir_torch.kernels import cluster_trace as tct
from tpu_restir_torch.render import intersect as tintersect
from tpu_restir_torch.scene.cornell import cornell_box as t_cornell_box
from tpu_restir_torch.scene.procedural import terrain_scene as t_terrain
from tpu_restir_torch.scene.procedural import triangle_soup as t_soup

MARGIN = 1e-6
MAX_MARGIN_SHARE = 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
J_PT = JIntersectorConfig(backend="ptrace")
T_PT = IntersectorConfig(backend="ptrace")


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jct.INTERPRET = True
    yield
    jct.INTERPRET = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many small tensor ops,
    where PyTorch's threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BUILDERS = {
    "terrain3k": (lambda: j_terrain(3_000), lambda: t_terrain("cpu", 3_000)),
    "soup1500": (lambda: j_soup(1_500), lambda: t_soup("cpu", 1_500)),
    "terrain5k": (lambda: j_terrain(5_000), lambda: t_terrain("cpu", 5_000)),
    "terrain20k": (lambda: j_terrain(20_000),
                   lambda: t_terrain("cpu", 20_000)),
}
_BUILT = {}


def _scenes(name):
    """(JAX scene, port scene), built once per test process."""
    if name not in _BUILT:
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
    before = dict(tct.LAUNCHES)
    got = [x.numpy() for x in tct.trace_closest(
        ts.cluster_tris, ts.cluster_min, ts.cluster_max, *_t(o, d, tn, tf),
        factor=factor)]
    assert tct.LAUNCHES == before          # the plain version launches none
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
    and the clustered traversal above; what is not ported raises."""
    _js, big = _scenes("soup1500")
    small = t_cornell_box("cpu")
    assert tintersect._backend(small, IntersectorConfig()) == "fused"
    assert tintersect._backend(big, IntersectorConfig()) == "ptrace"
    assert tintersect._backend(
        big, IntersectorConfig(fused_max_tris=4096)) == "fused"
    with pytest.raises(ValueError, match="clustered"):
        tintersect._backend(small, T_PT)
    with pytest.raises(ValueError, match="fused_max_tris"):
        tintersect._backend(big, IntersectorConfig(backend="fused"))
    with pytest.raises(NotImplementedError, match="K7/K8"):
        tintersect._backend(big, dataclasses.replace(T_PT, ptrace_mxu=True))
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        tintersect._backend(big, IntersectorConfig(backend="fcluster"))
    tintersect.QUERY_LOG = log = []
    try:
        o, d, tn, tf = _t(*_random_rays(37, 10, 2.0))
        tintersect.intersect_any(big, o, d, tn, tf)
    finally:
        tintersect.QUERY_LOG = None
    assert log == [{"kind": "any", "backend": "ptrace", "rays": 10}]


@pytest.mark.parametrize("c,factor", [(9, 1), (64, 1), (65, 1), (1569, 1),
                                      (5000, 2), (15_700, 4),
                                      (20_000, 5)])
def test_cull_mode_and_factor_match_jax(c, factor):
    assert tct.pick_factor(c) == jct.pick_factor(c)
    for kind in ("closest", "any"):
        assert tct._skip_for(kind, c, factor) == jct._skip_for(kind, c,
                                                               factor)


def test_plain_versions_on_cpu_only():
    """The wrappers take the plain versions only for CPU tensors and refuse
    other devices."""
    _js, ts = _scenes("soup1500")
    o, d, tn, tf = _t(*_random_rays(38, 16, 2.0))
    with pytest.raises(ValueError, match="unsupported device"):
        tct.trace_any(ts.cluster_tris.to("meta"), ts.cluster_min.to("meta"),
                      ts.cluster_max.to("meta"), o.to("meta"), d.to("meta"),
                      tn.to("meta"), tf.to("meta"))
