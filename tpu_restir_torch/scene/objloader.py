"""OBJ/MTL scene loading (counterpart of `tpu_restir.scene.objloader`,
the reference's ASSIMP path, pg/ModelLoader.cpp:18-321), in numpy on the
host; the scene then goes to one device.

Triangulated OBJ geometry with per-vertex normals and UVs, MTL materials
with the reference's clearcoat-as-type convention (`Pc` selects the
material class: 0=Normal, 1=Lambert, 2=Phong, 3=Mirror, 4=Dielectric,
5=Transparent), gamma expansion of ambient/diffuse/specular colours and
of diffuse/specular textures, the four texture slots (diffuse, specular,
shininess, normal), per-face tangents from UVs, and the emissive
triangles of the light CDF (built by build_scene). Without a Pc key the
class is Phong when Ks > 0, else Lambert.

PNG textures are decoded by the port's own reader (`io.png`); other
formats need imageio or PIL (`io.image`). A texture whose file does
not exist is dropped from its slot, as in the JAX package; a texture that
exists but cannot be decoded (no decoder installed, or a layout the
reader does not take) raises, where the JAX package drops it too.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_restir_torch.scene.materials import MaterialSpec, MatType
from tpu_restir_torch.scene.scene import SceneArrays, build_scene
from tpu_restir_torch.scene.textures import TextureStack, build_texture_stack

_PC_TO_TYPE = {0: MatType.NORMAL, 1: MatType.LAMBERT, 2: MatType.PHONG,
               3: MatType.MIRROR, 4: MatType.DIELECTRIC,
               5: MatType.TRANSPARENT}


def _expand_np(c):
    c = np.clip(np.asarray(c, np.float32), 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92,
                    np.power((c + 0.055) / 1.055, 2.4)).astype(np.float32)


def _load_image(path: str, srgb: bool) -> Optional[np.ndarray]:
    """LDR as float in [0, 1] (sRGB-expanded like the reference's gamma
    handling); HDR formats as linear float without the expand (the
    reference's pixel_size > 4 path, pg/Texture.cpp:91-98). None when the
    file does not exist."""
    if not os.path.exists(path):
        return None
    if path.lower().endswith((".hdr", ".exr", ".pfm")):
        from tpu_restir_torch.scene.envmap import load_hdr

        return load_hdr(path)
    from tpu_restir_torch.io.image import read_image

    img = read_image(path).astype(np.float32) / 255.0
    if srgb:
        img = _expand_np(img)
    return img


def parse_mtl(path: str, gamma_correct: bool = True):
    """{name: material record}; texture paths resolved relative to the MTL
    file, slot -> (path, srgb) per material."""
    mats: Dict[str, dict] = {}
    cur = None
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "newmtl":
                cur = dict(name=tok[1], Ka=(0.1,) * 3, Kd=(0.5,) * 3,
                           Ks=(0.0,) * 3, Ke=(0.0,) * 3, Ns=1.0, Ni=1.5,
                           Tf=(0.0,) * 3, Pc=None, textures={})
                mats[tok[1]] = cur
            elif cur is None:
                continue
            elif key in ("Ka", "Kd", "Ks", "Ke", "Tf"):
                cur[key] = tuple(float(v) for v in tok[1:4])
            elif key == "Ns":
                cur["Ns"] = float(tok[1])
            elif key == "Ni":
                cur["Ni"] = float(tok[1])
            elif key == "Pc":
                cur["Pc"] = float(tok[1])
            elif key == "map_Kd":
                cur["textures"]["diffuse"] = (os.path.join(base, tok[-1]),
                                              True)
            elif key == "map_Ks":
                cur["textures"]["specular"] = (os.path.join(base, tok[-1]),
                                               True)
            elif key == "map_Ns":
                cur["textures"]["shininess"] = (os.path.join(base, tok[-1]),
                                                False)
            elif key in ("map_bump", "bump", "norm", "map_Kn"):
                cur["textures"]["normal"] = (os.path.join(base, tok[-1]),
                                             False)
    return mats


def _mat_spec(m: dict, tex_ids: Dict[str, int],
              gamma_correct: bool) -> MaterialSpec:
    pc = m["Pc"]
    if pc is not None and int(pc) in _PC_TO_TYPE:
        mtype = _PC_TO_TYPE[int(pc)]
    elif max(m["Ks"]) > 0.0:
        mtype = MatType.PHONG
    else:
        mtype = MatType.LAMBERT

    def gam(c):
        return tuple(_expand_np(c).tolist()) if gamma_correct else tuple(c)

    return MaterialSpec(
        name=m["name"], mat_type=mtype,
        ambient=gam(m["Ka"]), diffuse=gam(m["Kd"]), specular=gam(m["Ks"]),
        emission=tuple(m["Ke"]), shininess=m["Ns"], ior=m["Ni"],
        attenuation=tuple(m["Tf"]),
        tex_diffuse=tex_ids.get("diffuse", -1),
        tex_specular=tex_ids.get("specular", -1),
        tex_shininess=tex_ids.get("shininess", -1),
        tex_normal=tex_ids.get("normal", -1))


def _compute_tangents(v, uv):
    """Per-face tangents from the UV parametrisation (ASSIMP
    CalcTangentSpace); the first edge's direction on degenerate UVs."""
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    du1 = uv[:, 1, 0] - uv[:, 0, 0]
    dv1 = uv[:, 1, 1] - uv[:, 0, 1]
    du2 = uv[:, 2, 0] - uv[:, 0, 0]
    dv2 = uv[:, 2, 1] - uv[:, 0, 1]
    det = du1 * dv2 - du2 * dv1
    ok = np.abs(det) > 1e-12
    r = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tan = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]
    tan = np.where(ok[:, None], tan, e1)
    norm = np.maximum(np.linalg.norm(tan, axis=-1, keepdims=True), 1e-20)
    return (tan / norm).astype(np.float32)


_DEFAULT_MTL = dict(Ka=(0.1,) * 3, Kd=(0.5,) * 3, Ks=(0.0,) * 3,
                    Ke=(0.0,) * 3, Ns=1.0, Ni=1.5, Tf=(0.0,) * 3, Pc=None,
                    textures={})


def load_obj(path: str, gamma_correct: bool = True) -> dict:
    """Parse an OBJ file on the host -> dict of triangle arrays (tri_v,
    tri_n, tri_uv, tangents), material ids, specs and the texture stack
    (a TextureStack on the CPU, or None)."""
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    uvs: List[Tuple[float, float]] = []
    faces = []  # ((vi, ti, ni) x 3, material index)
    mtl: Dict[str, dict] = {}
    mat_order: List[str] = []
    cur_mat = 0

    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                positions.append(tuple(float(x) for x in tok[1:4]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in tok[1:4]))
            elif key == "vt":
                uvs.append(tuple(float(x) for x in tok[1:3]))
            elif key == "mtllib":
                p = os.path.join(base, " ".join(tok[1:]))
                if os.path.exists(p):
                    mtl.update(parse_mtl(p, gamma_correct))
            elif key == "usemtl":
                name = tok[1]
                if name not in mat_order:
                    mat_order.append(name)
                cur_mat = mat_order.index(name)
            elif key == "f":
                verts = []
                for vstr in tok[1:]:
                    parts = vstr.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    verts.append((vi, ti, ni))
                for k in range(1, len(verts) - 1):     # triangle fans
                    faces.append(((verts[0], verts[k], verts[k + 1]),
                                  cur_mat))

    if not mat_order:
        mat_order = ["default"]

    pos = np.asarray(positions, np.float32)
    nrm = np.asarray(normals, np.float32) if normals else None
    uvarr = np.asarray(uvs, np.float32) if uvs else None

    def resolve(idx, n):
        return idx - 1 if idx > 0 else n + idx

    n_f = len(faces)
    tri_v = np.zeros((n_f, 3, 3), np.float32)
    tri_n = np.zeros((n_f, 3, 3), np.float32)
    tri_uv = np.zeros((n_f, 3, 2), np.float32)
    mat_ids = np.zeros((n_f,), np.int32)
    have_n = np.zeros((n_f,), bool)
    for i, (vs, m) in enumerate(faces):
        mat_ids[i] = m
        for j, (vi, ti, ni) in enumerate(vs):
            tri_v[i, j] = pos[resolve(vi, len(pos))]
            if ti and uvarr is not None:
                tri_uv[i, j] = uvarr[resolve(ti, len(uvarr))]
            if ni and nrm is not None:
                tri_n[i, j] = nrm[resolve(ni, len(nrm))]
                have_n[i] = True
    # faces without normals get their face normal
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    tri_n[~have_n] = fn[~have_n][:, None, :]

    # textures: unique (path, srgb) in first-use order, each decoded once
    tex_keys: List[Tuple[str, bool]] = []
    images: List[np.ndarray] = []
    specs: List[MaterialSpec] = []
    for name in mat_order:
        m = mtl.get(name, dict(_DEFAULT_MTL, name=name))
        ids = {}
        for slot, (tpath, srgb) in m.get("textures", {}).items():
            keyt = (tpath, srgb)
            if keyt not in tex_keys:
                img = _load_image(tpath, srgb)
                if img is None:
                    continue
                tex_keys.append(keyt)
                images.append(img)
            ids[slot] = tex_keys.index(keyt)
        specs.append(_mat_spec(m, ids, gamma_correct))

    stack: Optional[TextureStack] = None
    if images:
        stack = build_texture_stack(images, "cpu")

    return dict(tri_v=tri_v, tri_n=tri_n, tri_uv=tri_uv, mat_ids=mat_ids,
                specs=specs, textures=stack,
                tangents=_compute_tangents(tri_v, tri_uv)[:, None, :].repeat(
                    3, axis=1))


def load_obj_scene(path: str, device, gamma_correct: bool = True,
                   cluster_size: int = 32) -> SceneArrays:
    """An OBJ scene on device, built at cluster size 32 as the JAX package
    builds it (tpu_restir/scene/objloader.py:256): above 32 triangles the
    triangles are put in BVH2 leaf order in clusters of 32, so triangle
    ids, and every tie-break of the closest hit, match the JAX package's."""
    d = load_obj(path, gamma_correct)
    return build_scene(d["tri_v"], d["mat_ids"], d["specs"], device,
                       vertex_normals=d["tri_n"], vertex_uvs=d["tri_uv"],
                       vertex_tangents=d["tangents"],
                       textures=d["textures"], cluster_size=cluster_size)
