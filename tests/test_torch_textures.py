"""The port's texture stack, sky, PNG reader, texture-backed materials and
texture/roughness gradients, against the JAX package's from the same
numpy inputs, on the CPU.

Tolerances:
  * the PNG reader: uint8 values equal to PIL's;
  * texture lookups: the integer corner indices equal, texels at rtol
    1e-6, atol 1e-6 (the bilinear blend is the same sequence of float32
    operations; XLA may contract it into fused multiply-adds);
  * the sky: rtol 1e-5 (atan2 and acos may differ by an ulp);
  * apply_textures at TEXEL_TOL, apply_normal_map at rtol 1e-5,
    atol 1e-6 (normalize's rsqrt);
  * gradients against JAX's value_and_grad: loss at rtol 1e-5, gradients
    at rtol 1e-4 plus 1e-6 of the field's largest entry (the smooth
    configurations: one candidate, or NEE at two bounces); texel
    gradients also sum the gathers' cotangents in another order (an
    accumulating index_put_ here, a scatter-add in XLA). Against a
    central finite difference: rtol 0.08, as tests/test_diff_glossy.py.
"""

import dataclasses
import os
import struct
import sys
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpu_restir import config as jc
from tpu_restir.diff.render import loss_fn as j_loss
from tpu_restir.render import camera as jcam
from tpu_restir.render import intersect as jisect
from tpu_restir.scene import envmap as jenv
from tpu_restir.scene import materials as jmat
from tpu_restir.scene import textures as jtex
from tpu_restir.scene.materials import MaterialSpec as JSpec
from tpu_restir.scene.objloader import load_obj_scene as j_load
from tpu_restir.scene.scene import build_scene as j_build
from tpu_restir_torch import config as tc
from tpu_restir_torch import convert
from tpu_restir_torch.diff.params import extract_params
from tpu_restir_torch.diff.render import loss_fn, make_value_and_grad
from tpu_restir_torch.io import png as tpng
from tpu_restir_torch.io.export import save_png
from tpu_restir_torch.render import camera as tcam
from tpu_restir_torch.scene import envmap as tenv
from tpu_restir_torch.scene import materials as tmat
from tpu_restir_torch.scene import textures as ttex
from tpu_restir_torch.scene.materials import MaterialSpec, MatType
from tpu_restir_torch.scene.objloader import load_obj_scene
from tpu_restir_torch.scene.scene import SceneArrays, build_scene

_DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "demo")
TEXEL_TOL = dict(rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- PNG


@pytest.mark.parametrize("name", ["checker", "spec", "normal"])
def test_png_reader_matches_pil_on_the_demo_textures(name):
    path = os.path.join(_DEMO, f"{name}.png")
    got = tpng.read_png_rgb(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, want)


def test_png_reader_round_trips_the_exporter(tmp_path):
    img = np.random.default_rng(3).uniform(-0.1, 1.1, (13, 21, 3))
    path = str(tmp_path / "x.png")
    save_png(path, img)
    got = tpng.read_png(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(
        got[..., :3], (np.clip(img, 0, 1) * 255.0).astype(np.uint8))
    assert (got[..., 3] == 255).all()


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(img, kinds, ctype):
    """A PNG of img (H, W, C) uint8 with row filter kinds[y % len(kinds)]
    (PNG spec 9.2, written out byte by byte)."""
    h, w, ch = img.shape
    rows, prior = [], [0] * (w * ch)
    for y in range(h):
        cur = img[y].reshape(-1).tolist()
        kind = kinds[y % len(kinds)]
        out = [kind]
        for i, x in enumerate(cur):
            a = cur[i - ch] if i >= ch else 0
            b = prior[i]
            c = prior[i - ch] if i >= ch else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
            out.append((x - pred) & 0xFF)
        rows.append(bytes(out))
        prior = cur

    def chunk(k, d):
        return struct.pack(">I", len(d)) + k + d + struct.pack(
            ">I", zlib.crc32(k + d) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds,ctype,ch", [
    ([0], 2, 3), ([1], 2, 3), ([2], 6, 4), ([3], 2, 3), ([4], 2, 3),
    ([0, 1, 2, 3, 4], 6, 4), ([4, 3, 1], 0, 1)])
def test_png_reader_undoes_every_filter(tmp_path, kinds, ctype, ch):
    img = np.random.default_rng(sum(kinds) + ch).integers(
        0, 256, (9, 11, ch), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_encode(img, kinds, ctype))
    got = tpng.read_png(path)
    np.testing.assert_array_equal(got, img)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got.reshape(pil.shape), pil)
    np.testing.assert_array_equal(tpng.read_png_rgb(path),
                                  np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("mode,what", [("P", "colour type 3"),
                                       ("I;16", "bit depth 16")])
def test_png_reader_refuses_other_layouts(tmp_path, mode, what):
    path = str(tmp_path / "odd.png")
    Image.new(mode, (4, 3)).save(path)
    with pytest.raises(ValueError, match=f"odd.png.*{what}"):
        tpng.read_png(path)


# ------------------------------------------------------------ sampling


def _uvs(seed, n=4096):
    """Seeded UVs in [-1.5, 2.5]^2 with the edges, exact integers and
    half-texel points among them."""
    uv = np.random.default_rng(seed).uniform(-1.5, 2.5, (n, 2))
    edge = np.array([[0, 0], [1, 1], [0, 1], [1, 0], [-1, -1], [2, 2],
                     [0.5, 0.5], [-0.25, 1.25], [1e-7, 1 - 1e-7]])
    return np.concatenate([edge, uv]).astype(np.float32)


def _stack_images(seed):
    g = np.random.default_rng(seed)
    return [g.uniform(0, 1, (h, w, 3)).astype(np.float32)
            for h, w in ((5, 7), (8, 3), (4, 4), (1, 1))]


def _jax_corners(stack, tex_id, uv):
    """The integer corners of tpu_restir/scene/textures.py:106-119."""
    t = jnp.clip(tex_id, 0, stack.num_textures - 1)
    h, w, mode = stack.sizes[t, 0], stack.sizes[t, 1], stack.modes[t]
    x = uv[..., 0] * (w - 1).astype(jnp.float32)
    y = (1.0 - uv[..., 1]) * (h - 1).astype(jnp.float32)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)

    def addr(i, n):
        return jnp.where(mode == jtex.REPEAT, jnp.abs(jnp.mod(i, n)),
                         jnp.clip(i, 0, n - 1))

    return [np.asarray(v) for v in (t, addr(y0, h), addr(y0 + 1, h),
                                    addr(x0, w), addr(x0 + 1, w))]


@pytest.mark.parametrize("address", [jtex.CLAMP, jtex.REPEAT])
def test_sample_bilinear_matches_jax(address):
    img = _stack_images(1)[0]
    uv = _uvs(2)
    want = np.asarray(jtex.sample_bilinear(jnp.asarray(img), jnp.asarray(uv),
                                           address))
    got = ttex.sample_bilinear(torch.from_numpy(img), torch.from_numpy(uv),
                               address)
    np.testing.assert_allclose(got.numpy(), want, **TEXEL_TOL)
    # the same lookup as a one-texture stack in that mode
    st = ttex.build_texture_stack([img], "cpu", modes=[address])
    via_stack = ttex.sample_stack(st, torch.zeros(len(uv), dtype=torch.int32),
                                  torch.from_numpy(uv),
                                  torch.zeros(len(uv), 3))
    np.testing.assert_array_equal(via_stack.numpy(), got.numpy())


@pytest.mark.parametrize("modes", [None, [1, 1, 1, 1], [0, 1, 1, 0]])
def test_sample_stack_matches_jax(modes):
    """Mixed native sizes in one zero-padded stack, mixed address modes,
    tex_id < 0 -> the fallback."""
    imgs = _stack_images(4)
    uv = _uvs(5)
    tex_id = np.random.default_rng(6).integers(-1, 4, len(uv)).astype(
        np.int32)
    fallback = np.random.default_rng(7).uniform(0, 1, (len(uv), 3)).astype(
        np.float32)
    js = jtex.build_texture_stack(imgs, modes)
    ts = ttex.build_texture_stack(imgs, "cpu", modes)
    for f in ("data", "sizes", "modes"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert tuple(ts.data.shape) == (4, 8, 7, 3)
    tid, tuv = torch.from_numpy(tex_id), torch.from_numpy(uv)
    got_c = ttex.stack_corners(ts, tid, tuv)[:5]
    want_c = _jax_corners(js, jnp.asarray(tex_id), jnp.asarray(uv))
    for g, w in zip(got_c, want_c):
        np.testing.assert_array_equal(g.numpy(), w)
    want = np.asarray(jtex.sample_stack(js, jnp.asarray(tex_id),
                                        jnp.asarray(uv),
                                        jnp.asarray(fallback)))
    got = ttex.sample_stack(ts, tid, tuv, torch.from_numpy(fallback))
    np.testing.assert_allclose(got.numpy(), want, **TEXEL_TOL)
    np.testing.assert_array_equal(got.numpy()[tex_id < 0],
                                  fallback[tex_id < 0])
    if modes and 1 in modes:     # REPEAT wraps negative corners upward
        wrapped = (tex_id == 1) & (uv[:, 0] < 0)
        assert wrapped.any() and (got_c[3].numpy()[wrapped] >= 0).all()


def test_area_downsample_matches_jax():
    img = np.random.default_rng(8).uniform(0, 1, (37, 50, 3)).astype(
        np.float32)
    for m in (8, 16, 64):
        np.testing.assert_array_equal(ttex._area_downsample(img, m),
                                      jtex._area_downsample(img, m))


# ----------------------------------------------------------------- sky


def _dirs(seed, n=4096):
    d = np.random.default_rng(seed).standard_normal((n, 3))
    d = np.concatenate([d, [[0, 0, 1], [0, 0, -1], [-1, 0, 0], [-1, -0.0, 0],
                            [1, 0, 0], [0, 1, 0]]])
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("use_skybox", [True, False])
def test_sky_radiance_matches_jax(use_skybox):
    env = jenv.load_hdr(os.path.join(_DEMO, "env.pfm"))
    d = _dirs(9)
    want = np.asarray(jenv.sky_radiance(
        types.SimpleNamespace(envmap=jnp.asarray(env)),
        jc.RenderParams(use_skybox=use_skybox), jnp.asarray(d)))
    got = tenv.sky_radiance(
        types.SimpleNamespace(envmap=torch.from_numpy(env)),
        tc.RenderParams(use_skybox=use_skybox), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tenv.spherical_uv(torch.from_numpy(d)).numpy(),
        np.asarray(jenv.spherical_uv(jnp.asarray(d))), rtol=1e-5, atol=1e-7)
    if use_skybox:
        assert got.numpy().max() > 5.0      # the HDR sun is seen


def test_environment_readers_match_jax(tmp_path):
    path = os.path.join(_DEMO, "env.pfm")
    got = tenv.load_hdr(path)
    np.testing.assert_array_equal(got, jenv.load_hdr(path))
    assert got.shape == (32, 64, 3) and got.max() > 5.0
    out = str(tmp_path / "w.pfm")
    tenv.write_pfm(out, got)
    np.testing.assert_array_equal(jenv.read_pfm(out), got)
    # PNG skies: the port's reader against the JAX package's imageio
    png = os.path.join(_DEMO, "checker.png")
    np.testing.assert_array_equal(tenv.load_hdr(png), jenv.load_hdr(png))


def test_load_hdr_without_a_decoder_raises(tmp_path, monkeypatch):
    """.exr needs imageio or PIL; without them the reader raises, naming
    the file, and never returns a flat sky. Radiance .hdr is read by the
    port's own reader (tests/test_torch_hdr.py), which needs neither and
    raises, naming the file, on a file it cannot read."""
    for mod in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    path = str(tmp_path / "sky.exr")
    open(path, "wb").write(b"v/1\x01")
    with pytest.raises(RuntimeError, match="sky.exr: no decoder"):
        tenv.load_hdr(path)
    path = str(tmp_path / "sky.hdr")
    open(path, "wb").write(b"#?RADIANCE\n")
    with pytest.raises(ValueError, match="sky.hdr: header has no end"):
        tenv.load_hdr(path)


# ----------------------------------------------------------- materials


@pytest.fixture(scope="module")
def demo_hits():
    """JAX's G-buffer hit records of the demo camera at 40x30: uv,
    shading normal, tangent and material id of every pixel."""
    js = j_load(os.path.join(_DEMO, "demo.obj"))
    ccfg = jc.CameraConfig(width=40, height=30, fov_y_deg=50.0,
                           view_from=(0.0, -6.0, 2.1),
                           view_at=(0.0, 0.4, 0.7), pixel_sampler="random")
    ys, xs = jnp.meshgrid(jnp.arange(30), jnp.arange(40), indexing="ij")
    o, d = jcam.generate_rays_at(jcam.make_camera(ccfg), ccfg,
                                 jnp.uint32(11), ys, xs)
    hit = jisect.intersect_closest(js, o, d, 1e-4, jnp.inf)
    hi = jisect.hit_attributes(js, o, d, hit)
    return js, load_obj_scene(os.path.join(_DEMO, "demo.obj"), "cpu"), hi


def _with_roughness_map(js, ts):
    """Both scenes with the floor's shininess slot on texture 1 (the
    roughness -> shininess branch; the demo has no such map)."""
    jt = js.materials.tex_index.at[0, 2].set(1)
    tt = ts.materials.tex_index.clone()
    tt[0, 2] = 1
    js = js.replace(materials=js.materials.replace(tex_index=jt))
    ts = dataclasses.replace(ts, materials=dataclasses.replace(
        ts.materials, tex_index=tt))
    return js, ts


@pytest.mark.parametrize("rough_map", [False, True])
def test_apply_textures_and_normal_map_match_jax(demo_hits, rough_map):
    js, ts, hi = demo_hits
    if rough_map:
        js, ts = _with_roughness_map(js, ts)
    mid = np.array(hi.mat_id)
    jm = jmat.apply_textures(js, jmat.gather_materials(js.materials,
                                                       hi.mat_id), hi.uv)
    jn = np.asarray(jmat.apply_normal_map(js, jm, hi.normal, hi.tangent,
                                          hi.uv))
    tm = tmat.apply_textures(ts, tmat.gather_materials(
        ts.materials, torch.from_numpy(mid)), torch.from_numpy(
        np.array(hi.uv)))
    tn = tmat.apply_normal_map(ts, tm, *(torch.from_numpy(np.array(x))
                                         for x in (hi.normal, hi.tangent,
                                                   hi.uv)))
    for f in ("diffuse", "specular"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), **TEXEL_TOL)
    np.testing.assert_allclose(tm.shininess.numpy(), np.asarray(jm.shininess),
                               rtol=1e-5)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-5, atol=1e-6)
    tex = ts.materials.tex_index.numpy()[mid]
    # every slot the demo wires is seen, and the maps move the values
    assert (tex[..., 0] >= 0).any() and (tex[..., 1] >= 0).any()
    mapped = tex[..., 3] >= 0
    assert mapped.any() and not np.allclose(tn.numpy()[mapped],
                                            np.asarray(hi.normal)[mapped])
    if rough_map:
        assert (tex[..., 2] >= 0).any()


def test_no_texture_stack_is_the_identity():
    from tpu_restir_torch.scene.cornell import cornell_box
    ts = cornell_box("cpu")
    m = tmat.gather_materials(ts.materials, torch.zeros(5, dtype=torch.int32))
    n = torch.randn(5, 3)
    assert tmat.apply_textures(ts, m, torch.zeros(5, 2)) is m
    assert tmat.apply_normal_map(ts, m, n, n, torch.zeros(5, 2)) is n


# ----------------------------------------------------------- gradients

SIZE = 16
GLOSSY = 1


def _quad(p0, p1, p2, p3):
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return [np.stack([p0, p1, p2]), np.stack([p0, p2, p3])]


def _glossy_scenes(ts_panel):
    """The `setup` scene of tests/test_diff_glossy.py (a checker-textured
    floor, a glossy panel, an area light) in both packages; with ts_panel
    the panel is the TS material of its `setup_ts`, roughness 0.45."""
    quv = [np.array([[0, 0], [1, 0], [1, 1]], np.float32),
           np.array([[0, 0], [1, 1], [0, 1]], np.float32)]
    tris = (_quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0))
            + _quad((-1, 1, 0), (1, 1, 0), (1, 1, 2), (-1, 1, 2))
            + _quad((-0.4, 0.4, 1.9), (0.4, 0.4, 1.9), (0.4, -0.4, 1.9),
                    (-0.4, -0.4, 1.9)))
    mats = np.array([0, 0, 1, 1, 2, 2], np.int32)
    uvs = np.stack(quv * 3)
    checker = np.indices((8, 8)).sum(0) % 2
    tex = (0.25 + 0.6 * checker)[..., None].repeat(3, -1).astype(np.float32)
    kw = [dict(name="floor", mat_type=MatType.LAMBERT,
               diffuse=(0.6, 0.55, 0.5), tex_diffuse=0),
          dict(name="glossy", mat_type=MatType.TS if ts_panel
               else MatType.PHONG, diffuse=(0.25, 0.3, 0.45),
               specular=(0.4, 0.4, 0.4), shininess=60.0,
               roughness=0.45 if ts_panel else 1.0),
          dict(name="light", mat_type=MatType.LAMBERT,
               diffuse=(0.78, 0.78, 0.78), emission=(14.0, 11.0, 6.0))]
    js = j_build(np.stack(tris), mats, [JSpec(**k) for k in kw],
                 vertex_uvs=uvs, textures=tex[None])
    ts = build_scene(np.stack(tris), mats, [MaterialSpec(**k) for k in kw],
                     "cpu", vertex_uvs=uvs, textures=tex[None])
    return js, ts


def _glossy_cfg(mod, integrator):
    return mod.RenderConfig(
        camera=mod.CameraConfig(width=SIZE, height=SIZE, fov_y_deg=55.0,
                                view_from=(0.0, -2.6, 1.0),
                                view_at=(0.0, 0.0, 0.8),
                                pixel_sampler="center"),
        params=mod.RenderParams(use_skybox=False, max_bounce_count=2),
        restir=mod.RestirParams(m_area=1, m_brdf=0), integrator=integrator,
        direct_strategy="mis")


def _grad_case(field):
    """(JAX value, JAX grad, port loss fn, port value_and_grad, params):
    roughness through NEE-MIS on the TS panel, the texels through the
    ReSTIR frame, seeds (0, 1), target 0."""
    integrator = "nee" if field == "roughness" else "restir"
    js, ts = _glossy_scenes(ts_panel=field == "roughness")
    jcfg, tcfg = _glossy_cfg(jc, integrator), _glossy_cfg(tc, integrator)
    seeds = (0, 1)
    jp = {field: js.materials.roughness if field == "roughness"
          else js.textures.data}
    jv, jg = jax.value_and_grad(j_loss)(
        jp, js, jcam.make_camera(jcfg.camera), jcfg, seeds,
        jnp.zeros((SIZE, SIZE, 3)))
    cam = tcam.make_camera(tcfg.camera, "cpu")
    target = torch.zeros((SIZE, SIZE, 3))
    params = extract_params(ts, (field,))

    def loss(p):
        with torch.no_grad():
            return float(loss_fn(p, ts, cam, tcfg, seeds, target))

    return (float(jv), np.asarray(jg[field]), loss,
            make_value_and_grad(ts, cam, tcfg, seeds, target), params)


def test_zero_cotangents_stay_zero():
    """Where a where drops a lane, its zero cotangent meets derivatives
    that overflow float32: 1/x at x = 1e-20 (the TS branch's Smith term)
    and the incomplete beta's x-derivative at x = 1 (b = 1/2). Autograd's
    own backward gives 0 * inf = NaN there; mathx.recip and ibeta_nonnorm
    keep 0 and leave the forward and every nonzero cotangent as they
    were."""
    from tpu_restir_torch import mathx
    from tpu_restir_torch.mathx.special import ibeta_nonnorm
    x = torch.tensor([1e-20, 0.5, 2.0], requires_grad=True)
    r = mathx.recip(x)
    assert torch.equal(r, 1.0 / x.detach())
    (g,) = torch.autograd.grad((r * torch.tensor([0.0, 1.0, 3.0])).sum(), x)
    assert torch.equal(g, torch.tensor([0.0, -4.0, -0.75]))
    (naive,) = torch.autograd.grad((torch.where(
        torch.tensor([False, True, True]), 1.0 / x, 0.0)).sum(), x)
    assert torch.isnan(naive[0])
    s = torch.tensor([1.0, 0.3], requires_grad=True)
    v = ibeta_nonnorm(s, torch.tensor([2.0, 2.0]), 0.5)
    (gb,) = torch.autograd.grad(torch.where(
        torch.tensor([False, True]), v, 0.0).sum(), s)
    assert torch.isfinite(gb).all() and gb[0] == 0.0
    np.testing.assert_allclose(float(gb[1]), 0.3 * 0.7 ** -0.5, rtol=1e-6)


@pytest.mark.parametrize("field", ["roughness", "tex_data"])
def test_roughness_and_texel_gradients_match_jax_and_fd(field):
    jv, jg, loss, vg, params = _grad_case(field)
    tv, tg = vg(params)
    g = tg[field].numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(float(tv), jv, rtol=1e-5)
    np.testing.assert_allclose(g, jg, rtol=1e-4,
                               atol=1e-6 * float(np.abs(jg).max()))
    if field == "roughness":
        picks = [(GLOSSY,)]
        assert abs(g[GLOSSY]) > 1e-8
        eps = 5e-3
    else:
        assert (np.abs(g) > 1e-8).sum() >= 4, "no texel received gradient"
        picks = [np.unravel_index(int(f), g.shape)
                 for f in np.argsort(np.abs(g).ravel())[-2:]]
        eps = 3e-3
    for idx in picks:
        hi = {field: params[field].detach().clone()}
        lo = {field: params[field].detach().clone()}
        hi[field][idx] += eps
        lo[field][idx] -= eps
        fd = (loss(hi) - loss(lo)) / (2 * eps)
        assert np.isclose(fd, float(g[idx]), rtol=0.08, atol=1e-6), (
            idx, fd, float(g[idx]))


def test_texture_stack_crosses_packages():
    """from_tree carries a JAX TextureStack across, and a JAX scene
    without one keeps None."""
    js, ts = _glossy_scenes(ts_panel=False)
    got = convert.from_tree(SceneArrays, jax.tree.map(np.asarray, js), "cpu")
    assert isinstance(got.textures, ttex.TextureStack) and got.envmap is None
    for f in ("data", "sizes", "modes"):
        assert torch.equal(getattr(got.textures, f), getattr(ts.textures, f))
    bare = js.replace(textures=None)
    assert convert.from_tree(SceneArrays, jax.tree.map(np.asarray, bare),
                             "cpu").textures is None
