"""The port's OBJ/MTL loader and the demo asset (assets/demo: 78
triangles, all six Pc material classes, diffuse, specular and normal
maps, the HDR sky) against the JAX package's, on the CPU.

  * the loaded arrays, bit for bit (both are numpy on the host): triangle
    order (BVH2 leaf order at cluster size 32), normals, UVs, tangents,
    the material table, tex_index, the texture stack and the light CDF;
  * the G-buffer pass at 16x12 with the sky, at the tolerances of
    tests/test_torch_restir.py: rtol 1e-4, atol 1e-5 on pixels that hit
    the same material at the same depth, fewer than 1% of pixels
    otherwise, material ids exact there;
  * whole frames at 16x12 with the sky: two ReSTIR frames as
    tests/test_torch_restir.py holds them (image means within one
    standard error, fewer than 1% of reservoirs holding another sample,
    their weights at rtol 1e-3), and a NEE-MIS frame as
    tests/test_torch_integrators.py holds one (allclose at rtol 1e-4,
    atol 1e-5 on at least 99% of the pixels);
  * the CLI's demo golden of tests/test_demo_asset.py: image mean within
    2%, 4x4 display-space region means within 0.04;
  * the texel gradient through a smooth demo ReSTIR frame (16x12, one
    candidate, centre sampler, sky): finite on every texel, equal to
    JAX's value_and_grad at rtol 1e-4 plus 1e-6 of the largest entry on
    the entries where JAX's is finite (JAX's is NaN on a few specular-map
    texels: the backward of its incomplete beta is infinite at x = 1 and
    meets a zero cotangent), and within rtol 0.08 of a central finite
    difference on the three strongest texels.

The plain ray/triangle versions build (rays, triangles) tensors above
PyTorch's parallel grain; under parallel test workers each such op waits
on the thread pool unless the process runs one thread, as
`tests/conftest.py` makes every test process do (the CLI golden took
50-90 s so, 1.3 s on one thread).
"""

import dataclasses
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_restir import config as jc
from tpu_restir import rng as jrng
from tpu_restir.diff.render import loss_fn as j_loss
from tpu_restir.render import camera as jcam
from tpu_restir.render.integrators import render_nee as j_nee
from tpu_restir.render.integrators.restir import gbuffer as jgb
from tpu_restir.render.integrators.restir import pipeline as jpipe
from tpu_restir.scene.envmap import load_hdr as j_load_hdr
from tpu_restir.scene.objloader import load_obj as j_load_obj
from tpu_restir.scene.objloader import load_obj_scene as j_load
from tpu_restir_torch import cli as tcli
from tpu_restir_torch import config as tc
from tpu_restir_torch import convert
from tpu_restir_torch import rng as trng
from tpu_restir_torch import tracing
from tpu_restir_torch.diff.params import extract_params
from tpu_restir_torch.diff.render import loss_fn, make_value_and_grad
from tpu_restir_torch.io.png import read_png
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.render import intersect
from tpu_restir_torch.render.integrators import render_nee
from tpu_restir_torch.render.integrators.restir import gbuffer as tgb
from tpu_restir_torch.render.integrators.restir import pipeline as tpipe
from tpu_restir_torch.scene import objloader as tobj
from tpu_restir_torch.scene.envmap import with_sky
from tpu_restir_torch.scene.materials import MatType
from tpu_restir_torch.scene.scene import SceneArrays

_DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "demo")
OBJ = os.path.join(_DEMO, "demo.obj")
ENV = os.path.join(_DEMO, "env.pfm")
W, H = 16, 12
TOL = dict(rtol=1e-4, atol=1e-5)
MAX_DIFF_SHARE = 0.01
MIN_SHARE = 0.99
# tests/test_demo_asset.py's golden (48x32, 4 frames, seed 123)
GOLDEN_MEAN = 0.536838
GOLDEN_REGIONS = [[0.7129, 0.5927, 0.5785, 0.7047],
                  [0.6801, 0.5566, 0.5822, 0.6730],
                  [0.3819, 0.3869, 0.4031, 0.4196],
                  [0.3443, 0.4356, 0.4319, 0.3574]]


def _cfg(mod, integrator="restir", w=W, h=H):
    """The demo golden's camera and ReSTIR flags, the sky on."""
    return mod.RenderConfig(
        camera=mod.CameraConfig(width=w, height=h, fov_y_deg=50.0,
                                view_from=(0.0, -6.0, 2.1),
                                view_at=(0.0, 0.4, 0.7),
                                pixel_sampler="random"),
        params=mod.RenderParams(use_skybox=True, max_bounce_count=3),
        restir=mod.RestirParams(m_area=2, m_brdf=1, do_temporal_reuse=True,
                                do_spatial_reuse=True,
                                spatial_neighbor_count=5,
                                spatial_mis="pairwise"),
        integrator=integrator, direct_strategy="mis")


def _np(x):
    return jax.tree.map(np.asarray, x)


def _fields(obj, prefix=""):
    """{dotted field: numpy array} of a port dataclass tree."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + f.name] = v.numpy()
    return out


def _assert_same_arrays(ts, js):
    """Every array of the port's scene equals the JAX scene's, bit for
    bit (cluster blocks: the port keeps the first 9 channels)."""
    jn = _np(js)
    got = _fields(ts)
    assert len(got) > 20
    for name, a in got.items():
        b = jn
        for part in name.split("."):
            b = getattr(b, part)
        if name == "cluster_tris":
            b = b[..., :9]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ts.materials.types_present == js.materials.types_present
    assert ts.cluster_size == js.cluster_size


@pytest.fixture(scope="module")
def demo():
    js = j_load(OBJ).replace(envmap=jnp.asarray(j_load_hdr(ENV)))
    ts = with_sky(tobj.load_obj_scene(OBJ, "cpu"), ENV)
    return js, ts


def test_demo_arrays_equal_jax_bit_for_bit(demo):
    js, ts = demo
    _assert_same_arrays(ts, js)
    # 78 triangles in clusters of 32; all six Pc classes; three 64x64 maps
    assert ts.num_tris == 78 and ts.cluster_size == 32
    assert tuple(ts.cluster_tris.shape) == (3, 32, 9)
    assert set(ts.materials.types_present) == {
        MatType.NORMAL, MatType.LAMBERT, MatType.PHONG, MatType.MIRROR,
        MatType.DIELECTRIC, MatType.TRANSPARENT}
    assert ts.textures.num_textures == 3
    assert ts.textures.sizes.tolist() == [[64, 64]] * 3
    tex = ts.materials.tex_index.numpy()
    assert tex[:, 0].max() >= 0 and tex[:, 1].max() >= 0 \
        and tex[:, 3].max() >= 0
    assert ts.lights.is_valid
    assert tuple(ts.envmap.shape) == (32, 64, 3) and ts.envmap.max() > 5.0


def _write_scene(tmp_path, extra_mtl=""):
    """The small OBJ of tests/test_objloader.py, with optional extra
    material lines for the first material."""
    mtl = textwrap.dedent("""\
        newmtl lam
        Pc 1
        Kd 0.8 0.2 0.2
        Ks 0 0 0
        """) + extra_mtl + textwrap.dedent("""\
        newmtl glossy
        Pc 2
        Kd 0.4 0.4 0.4
        Ks 0.5 0.5 0.5
        Ns 64
        newmtl lamp
        Pc 1
        Kd 0.8 0.8 0.8
        Ke 10 9 8
        newmtl untyped
        Kd 0.1 0.9 0.1
        Ks 0.2 0.2 0.2
    """)
    obj = textwrap.dedent("""\
        mtllib scene.mtl
        v 0 0 0
        v 1 0 0
        v 0 1 0
        v 0 0 1
        vn 0 0 1
        usemtl lam
        f 1//1 2//1 3//1
        usemtl glossy
        f 1//1 2//1 4//1
        usemtl lamp
        f 2//1 3//1 4//1
        usemtl untyped
        f 1 3 4
    """)
    (tmp_path / "scene.mtl").write_text(mtl)
    p = tmp_path / "scene.obj"
    p.write_text(obj)
    return str(p)


def test_small_obj_equals_jax_bit_for_bit(tmp_path):
    path = _write_scene(tmp_path)
    ts, js = tobj.load_obj_scene(path, "cpu"), j_load(path)
    _assert_same_arrays(ts, js)
    assert ts.textures is None and js.textures is None
    assert ts.materials.mat_type.tolist() == [1, 2, 1, 2]
    d, jd = tobj.load_obj(path), j_load_obj(path)
    for k in ("tri_v", "tri_n", "tri_uv", "mat_ids", "tangents"):
        np.testing.assert_array_equal(d[k], jd[k], err_msg=k)


def test_missing_texture_is_dropped_as_in_jax(tmp_path):
    """A map whose file does not exist leaves its slot empty in both
    packages; a PNG map that exists is decoded by the port's reader."""
    extra = f"map_Kd gone.png\nmap_Ks {os.path.join(_DEMO, 'spec.png')}\n"
    path = _write_scene(tmp_path, extra)
    ts, js = tobj.load_obj_scene(path, "cpu"), j_load(path)
    _assert_same_arrays(ts, js)
    assert ts.materials.tex_index[0].tolist() == [-1, 0, -1, -1]
    assert ts.textures.num_textures == 1


def test_undecodable_texture_raises(tmp_path, monkeypatch):
    """A map that exists but that no installed decoder reads raises,
    naming the file: the port never drops it silently (the JAX package
    drops it)."""
    (tmp_path / "wood.jpg").write_bytes(b"\xff\xd8\xff")
    path = _write_scene(tmp_path, "map_Kd wood.jpg\n")
    assert j_load(path).textures is None          # the JAX package drops it
    for mod in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(RuntimeError, match="wood.jpg: no decoder"):
        tobj.load_obj_scene(path, "cpu")
    (tmp_path / "odd.png").write_bytes(b"\x89PNG\r\n\x1a\n")
    path = _write_scene(tmp_path, "map_Kd odd.png\n")
    with pytest.raises(ValueError, match="odd.png"):
        tobj.load_obj_scene(path, "cpu")


@pytest.fixture(scope="module")
def ref(demo):
    """JAX's G-buffer of frame 1 and two whole ReSTIR frames (jitted)."""
    js, _ = demo
    cfg = _cfg(jc)
    cam = jcam.make_camera(cfg.camera)
    ys, xs = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
    s1 = jrng.make_frame_seed(0, 1)
    gb1 = jax.jit(jgb.gbuffer_fill, static_argnames=("cfg",))(
        js, cam, cfg, s1, ys, xs)
    step = jax.jit(jpipe.restir_step, static_argnames=("cfg",))
    state = jpipe.init_restir_state(H, W)
    frames = []
    for f in range(2):
        frame, state = step(js, cam, cfg, jrng.make_frame_seed(0, f), state,
                            jnp.asarray(f))
        frames.append(np.asarray(frame))
    return dict(ys=torch.from_numpy(np.array(ys, np.int32)),
                xs=torch.from_numpy(np.array(xs, np.int32)),
                seed1=int(np.asarray(s1)), gb1=_np(gb1), frames=frames,
                state=_np(state))


def _gbuffer(scene, ref):
    cfg = _cfg(tc)
    return tgb.gbuffer_fill(scene, tcam.make_camera(cfg.camera, "cpu"), cfg,
                            ref["seed1"], ref["ys"], ref["xs"])


def test_gbuffer_pass(demo, ref):
    got, want = _gbuffer(demo[1], ref), ref["gb1"]
    same = got.mat_type.numpy() == want.mat_type
    same &= np.abs(got.depth.numpy() - want.depth) <= 1e-4
    assert 1.0 - same.mean() < MAX_DIFF_SHARE
    assert (want.depth > 0).mean() > 0.5
    sky = want.depth == 0
    assert sky.any() and (want.emission[sky] > 0).any()   # the env map
    for name in ("pos", "normal", "diffuse", "specular", "emission",
                 "depth", "inv_i_m", "shininess"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   getattr(want, name)[same], **TOL,
                                   err_msg=name)


def test_converted_jax_scene_renders_the_same_gbuffer(demo, ref):
    """A JAX demo scene carried across by from_tree (its TextureStack and
    envmap included) gives the G-buffer of the port's own loader."""
    js, ts = demo
    conv = convert.from_tree(SceneArrays, _np(js), "cpu")
    assert conv.textures is not None and conv.envmap is not None
    a, b = _gbuffer(conv, ref), _gbuffer(ts, ref)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_two_whole_restir_frames(demo, ref):
    ts = demo[1]
    cfg = _cfg(tc)
    cam = tcam.make_camera(cfg.camera, "cpu")
    state = tpipe.init_restir_state(H, W, "cpu")
    for f in range(2):
        frame, state = tpipe.restir_step(ts, cam, cfg,
                                         trng.make_frame_seed(0, f), state, f)
        want = ref["frames"][f]
        pix = want.mean(-1)
        assert torch.isfinite(frame).all()
        assert abs(float(frame.mean()) - want.mean()) \
            <= pix.std() / np.sqrt(pix.size)
    got, w = state.res_prev, ref["state"].res_prev
    same = (np.abs(got.sample.point.numpy() - w.sample.point).max(-1)
            <= 1e-4) & (got.sample.valid.numpy() == w.sample.valid)
    assert 1.0 - same.mean() < MAX_DIFF_SHARE, 1.0 - same.mean()
    for name in ("w_sum", "w", "confidence"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   getattr(w, name)[same], rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_nee_mis_frame(demo):
    js, ts = demo
    jcfg, tcfg = _cfg(jc, "nee"), _cfg(tc, "nee")
    with jax.disable_jit():
        want = np.asarray(j_nee(js, jcam.make_camera(jcfg.camera), jcfg,
                                jrng.frame_key(0, 5)))
    got = render_nee(ts, tcam.make_camera(tcfg.camera, "cpu"), tcfg,
                     trng.frame_key(0, 5)).numpy()
    assert np.isfinite(got).all() and want.mean() > 0.05
    share = float(np.isclose(got, want, **TOL).all(-1).mean())
    assert share >= MIN_SHARE, share


def test_forced_ptrace_equals_fused_on_the_demo(demo):
    """The demo (78 triangles, clusters of 32) goes to K1/K2 under "auto";
    forced to "ptrace" it runs the clustered traversal's plain versions
    on its clusters of 32, with the same hits."""
    ts = demo[1]
    cfg = _cfg(tc, w=64, h=32)
    o, d = tcam.generate_rays(tcam.make_camera(cfg.camera, "cpu"),
                              cfg.camera, trng.frame_key(0, 0))
    with tracing.recording() as rec:
        fused = intersect.intersect_closest(ts, o, d, 1e-4, torch.inf)
        # half of the hits lie within this reach: occluded and visible rays
        reach = float(fused.t[fused.hit].median())
        occ_f = intersect.intersect_any(ts, o, d, 1e-4, reach)
        pt = tc.IntersectorConfig(backend="ptrace")
        traced = intersect.intersect_closest(ts, o, d, 1e-4, torch.inf, pt)
        occ_p = intersect.intersect_any(ts, o, d, 1e-4, reach, pt)
    log = intersect.queries(rec)
    assert [e["backend"] for e in log] == ["fused"] * 2 + ["ptrace"] * 2
    assert torch.equal(fused.tri, traced.tri) and fused.hit.any()
    np.testing.assert_allclose(traced.t.numpy(), fused.t.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(occ_f, occ_p) and occ_f.any() and not occ_f.all()


def test_cli_demo_golden(tmp_path):
    """The argv of tests/test_demo_asset.py with --device cpu."""
    out = str(tmp_path / "demo.png")
    assert tcli.main([
        "--device", "cpu", "--scene", OBJ, "--size", "48x32", "--fov", "50",
        "--view-from", "0,-6.0,2.1", "--view-at", "0,0.4,0.7", "--frames",
        "4", "--temporal", "--spatial", "--spatial-mis", "pairwise",
        "--m-area", "2", "--skybox", ENV, "--out", out]) == 0
    text = open(out + ".txt").read()
    for field in ("Iteration count: 4", "Area samples: 2",
                  "BRDF samples: 1", "Spatial reuse: True",
                  "Temporal reuse: True", "Camera vertical FOV: 50"):
        assert field in text, field
    mean = float(text.split("Image mean:")[1].split()[0])
    assert abs(mean - GOLDEN_MEAN) < 0.02 * GOLDEN_MEAN, mean
    img = read_png(out)[..., :3].astype(np.float32) / 255.0
    reg = img.reshape(4, 8, 4, 12, 3).mean(axis=(1, 3, 4))
    np.testing.assert_allclose(reg, np.asarray(GOLDEN_REGIONS), atol=0.04)


def test_demo_texel_gradient_finite_and_matches_jax_and_fd(demo):
    js, ts = demo

    def cfg(mod):
        c = _cfg(mod)
        return c.replace(camera=dataclasses.replace(
            c.camera, pixel_sampler="center"),
            restir=mod.RestirParams(m_area=1, m_brdf=0))

    jcfg, tcfg = cfg(jc), cfg(tc)
    seeds, target = (0, 1), torch.zeros((H, W, 3))
    with jax.disable_jit():
        jv, jg = jax.value_and_grad(j_loss)(
            {"tex_data": js.textures.data}, js,
            jcam.make_camera(jcfg.camera), jcfg, seeds, jnp.zeros((H, W, 3)))
    jg = np.asarray(jg["tex_data"])
    cam = tcam.make_camera(tcfg.camera, "cpu")
    params = extract_params(ts, ("tex_data",))
    tv, tg = make_value_and_grad(ts, cam, tcfg, seeds, target)(params)
    g = tg["tex_data"].numpy()
    assert np.isfinite(g).all() and (np.abs(g) > 1e-8).sum() >= 4
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    fin = np.isfinite(jg)
    np.testing.assert_allclose(g[fin], jg[fin], rtol=1e-4,
                               atol=1e-6 * float(np.abs(jg[fin]).max()))
    for f in np.argsort(np.abs(g).ravel())[-3:]:
        idx = np.unravel_index(int(f), g.shape)
        eps = 3e-3
        hi = {"tex_data": params["tex_data"].detach().clone()}
        lo = {"tex_data": params["tex_data"].detach().clone()}
        hi["tex_data"][idx] += eps
        lo["tex_data"][idx] -= eps
        with torch.no_grad():
            fd = (float(loss_fn(hi, ts, cam, tcfg, seeds, target))
                  - float(loss_fn(lo, ts, cam, tcfg, seeds, target))) \
                / (2 * eps)
        assert np.isclose(fd, float(g[idx]), rtol=0.08, atol=1e-6), (
            idx, fd, float(g[idx]))
