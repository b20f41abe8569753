"""BRDF layer: sample, evaluate and pdf for every material family
(counterpart of `tpu_restir.render.brdf`).

Two APIs, as in the JAX package:

* the instance API of the path tracers (`sample_bsdf`, `eval_bsdf`,
  `pdf_bsdf`; brdf.py:171-271): every family is evaluated densely for
  every ray and the result selected by `mat_type`, the branchless form of
  the reference's virtual dispatch (pg/material.h:31-149);
* the G-buffer (screen-space) API of ReSTIR (the `gbuf_*` functions,
  brdf.py:292-330), which distinguishes only LAMBERT from everything else
  (Phong), with the pdf always Phong's (pg/ReSTIRIntegrator.h:32-59).

Conventions as the reference: `d` is the incident direction (into the
surface), `n` the shading normal flipped toward the viewer, Phong
specular uses the Mallett-Yuksel 1/I_M normalization, and the lobe pick
draws r0 ~ U(0, maxDiff + maxSpec) with the diffuse branch on r0 < maxDiff
(pg/MaterialPhong.cpp:29-56).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from perfbench.refrender import mathx, rng
from perfbench.refrender.mathx.special import calc_i_m
from perfbench.refrender.render import sampling
from perfbench.refrender.scene.materials import MatType, VertexType

_INV_PI = 1.0 / math.pi
_EPS = 1e-12


@dataclasses.dataclass
class BsdfSample:
    omega_i: torch.Tensor  # (..., 3)
    f_r: torch.Tensor      # (..., 3)
    pdf: torch.Tensor      # (...,)
    vtype: torch.Tensor    # (...,) int32 VertexType


# ---------------------------------------------------------------------------
# the Phong family (PHONG and DIELECTRIC; LAMBERT is its specular = 0 case)
# ---------------------------------------------------------------------------

def _phong_reflectances(m, n, d):
    """Per-type (diffuseReflectance, specularReflectance): PHONG and
    LAMBERT take the raw colours; DIELECTRIC scales them by Schlick's
    Fresnel with F0 = specular (pg/MaterialDielectric.cpp:16-17)."""
    spec_fresnel = mathx.schlick_f0(d, n, m.specular)
    max_sf = mathx.max_component(spec_fresnel)
    max_s = mathx.max_component(m.specular)
    scale = (1.0 - max_sf) / mathx.maximum(1.0 - max_s, _EPS)
    is_diel = (m.mat_type == MatType.DIELECTRIC)[..., None]
    d_refl = torch.where(is_diel, scale[..., None] * m.diffuse, m.diffuse)
    s_refl = torch.where(is_diel, spec_fresnel, m.specular)
    return d_refl, s_refl


def _phong_eval(d_refl, s_refl, shininess, n, d, omega_i, inv_i_m=None):
    """diffuse/pi + spec * (1/I_M) * max(wi.wr, 0)^shininess
    (pg/MaterialPhong.cpp:69-92)."""
    omega_r = mathx.normalize(mathx.reflect(d, n))
    if inv_i_m is None:
        inv_i_m = 1.0 / calc_i_m(mathx.dot(-d, n), shininess)
    lobe = mathx.safe_pow(
        mathx.maximum(mathx.dot(omega_i, omega_r), 0.0), shininess)
    return d_refl * _INV_PI + s_refl * (inv_i_m * lobe)[..., None]


def _phong_pdf(d_refl, s_refl, shininess, n, d, omega_i):
    """pdfFactor-weighted sum of cosine and cosine-lobe pdfs
    (pg/MaterialPhong.cpp:94-119)."""
    max_d = mathx.max_component(d_refl)
    max_s = mathx.max_component(s_refl)
    pdf_factor = max_d / mathx.maximum(max_d + max_s, _EPS)
    omega_r = mathx.normalize(mathx.reflect(d, n))
    pdf = sampling.pdf_cosine_hemisphere(n, omega_i) * pdf_factor
    return pdf + sampling.pdf_cosine_lobe(omega_i, omega_r, shininess) \
        * (1.0 - pdf_factor)


def _phong_sample_u(u5, d_refl, s_refl, shininess, n, d, inv_i_m=None):
    """Lobe pick + sample + combined pdf (pg/MaterialPhong.cpp:18-67).
    u5: (..., 5) uniforms [lobe pick, diff r1, diff r2, spec r1, spec r2]."""
    max_d = mathx.max_component(d_refl)
    max_s = mathx.max_component(s_refl)
    total = mathx.maximum(max_d + max_s, _EPS)
    diffuse_branch = u5[..., 0] * total < max_d

    omega_r = mathx.normalize(mathx.reflect(d, n))
    wi_d = sampling.cosine_hemisphere_from_uniforms(u5[..., 1:3], n)
    wi_s = sampling.cosine_lobe_from_uniforms(u5[..., 3:5], omega_r,
                                              shininess)
    omega_i = torch.where(diffuse_branch[..., None], wi_d, wi_s)

    if inv_i_m is None:
        inv_i_m = 1.0 / calc_i_m(mathx.dot(-d, n), shininess)
    lobe = mathx.safe_pow(
        mathx.maximum(mathx.dot(omega_i, omega_r), 0.0), shininess)
    f_r = torch.where(diffuse_branch[..., None], d_refl * _INV_PI,
                      s_refl * (inv_i_m * lobe)[..., None])

    pdf_factor = max_d / total
    pdf = sampling.pdf_cosine_hemisphere(n, omega_i) * pdf_factor \
        + sampling.pdf_cosine_lobe(omega_i, omega_r, shininess) \
        * (1.0 - pdf_factor)

    # below-horizon samples keep their pdf but contribute zero
    # (pg/MaterialPhong.cpp:62-64)
    below = mathx.dot(n, omega_i) < 0.0
    f_r = torch.where(below[..., None], 0.0, f_r)
    vtype = torch.where(diffuse_branch, VertexType.DIFFUSE,
                        VertexType.SPECULAR).to(torch.int32)
    return omega_i, f_r, pdf, vtype


def _phong_sample(key, d_refl, s_refl, shininess, n, d):
    u5 = rng.uniform(key, d_refl.shape[:-1] + (5,), d_refl.device)
    return _phong_sample_u(u5, d_refl, s_refl, shininess, n, d)


# ---------------------------------------------------------------------------
# delta materials
# ---------------------------------------------------------------------------

def _mirror_sample(m, n, d):
    """Delta reflection (pg/MaterialMirror.cpp:4-13)."""
    omega_i = mathx.reflect(d, n)
    theta_i = mathx.maximum(mathx.dot(omega_i, n), 0.0)
    f_r = torch.where(theta_i[..., None] > 0.0,
                      m.specular / mathx.maximum(theta_i, _EPS)[..., None],
                      0.0)
    return omega_i, f_r, torch.ones_like(theta_i)


def _transparent_sample(key, m, n, d, from_inside, dst):
    """Delta reflect or refract by the Schlick coefficient, with Beer
    attenuation on exit (pg/MaterialTransparent.cpp:6-37)."""
    refl = mathx.reflect(d, n)
    refr = mathx.refract(d, n, torch.where(from_inside, m.ior, 1.0 / m.ior))
    theta_i = torch.abs(mathx.dot(refl, n))
    ior1 = torch.where(from_inside, m.ior, 1.0)
    ior2 = torch.where(from_inside, 1.0, m.ior)
    f0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
    cos_t = mathx.maximum(mathx.dot(-d, n), 0.0)
    refl_coeff = f0 + (1.0 - f0) * (1.0 - cos_t) ** 5

    base = torch.where(theta_i[..., None] > 0.0,
                       m.specular / mathx.maximum(theta_i, _EPS)[..., None],
                       0.0)
    take_refl = rng.uniform(key, theta_i.shape, theta_i.device) < refl_coeff
    omega_i = torch.where(take_refl[..., None], refl, refr)
    pdf = torch.where(take_refl, refl_coeff, 1.0 - refl_coeff)
    f_r = base * pdf[..., None]
    beer = torch.exp(-m.attenuation * dst[..., None])
    f_r = torch.where((~take_refl & from_inside)[..., None], f_r * beer, f_r)
    vtype = torch.where(take_refl, VertexType.SPECULAR,
                        VertexType.REFRACTIVE).to(torch.int32)
    return omega_i, f_r, pdf, vtype


# ---------------------------------------------------------------------------
# the instance API (wavefront path tracing), dispatched over mat_type
# ---------------------------------------------------------------------------

def _bc(mask, ref):
    """A (...,) mask against (...,) or (..., 3) data."""
    return mask[..., None] if ref.dim() == mask.dim() + 1 else mask


def sample_bsdf(key, m, n, d, from_inside, dst) -> BsdfSample:
    """Material::evaluateLightingGI for a batch of hits; `m` holds the
    per-ray material columns (scene.materials.gather_materials). Every
    family draws from its own key of split(key, 3), densely."""
    k_ph, k_la, k_tr = rng.split(key, 3)
    t = m.mat_type

    d_refl, s_refl = _phong_reflectances(m, n, d)
    wi_p, f_p, pdf_p, vt_p = _phong_sample(k_ph, d_refl, s_refl,
                                           m.shininess, n, d)
    wi_l = sampling.sample_cosine_hemisphere(k_la, n)
    f_l = m.diffuse * _INV_PI
    pdf_l = sampling.pdf_cosine_hemisphere(n, wi_l)
    wi_m, f_m, pdf_m = _mirror_sample(m, n, d)
    wi_t, f_t, pdf_t, vt_t = _transparent_sample(k_tr, m, n, d,
                                                 from_inside, dst)

    is_ts = t == MatType.TS
    is_lam = (t == MatType.LAMBERT) | is_ts  # TS samples as LAMBERT
    is_phg = (t == MatType.PHONG) | (t == MatType.DIELECTRIC)
    is_mir = t == MatType.MIRROR
    is_trn = t == MatType.TRANSPARENT

    def pick(lam, phg, mir, trn, zero):
        out = torch.where(_bc(is_lam, lam), lam, zero)
        out = torch.where(_bc(is_phg, phg), phg, out)
        out = torch.where(_bc(is_mir, mir), mir, out)
        return torch.where(_bc(is_trn, trn), trn, out)

    omega_i = pick(wi_l, wi_p, wi_m, wi_t, torch.zeros_like(f_p))
    f_r = pick(f_l, f_p, f_m, f_t, torch.zeros_like(f_p))
    # TS: a cosine-sampled direction, but the full D*F*G value as f_r
    f_r = torch.where(_bc(is_ts, f_r), _ts_eval(m, n, d, omega_i), f_r)
    pdf = pick(pdf_l, pdf_p, pdf_m, pdf_t, torch.zeros_like(pdf_p))

    def full(v):
        return torch.full_like(t, v)

    vtype = pick(full(VertexType.DIFFUSE), vt_p, full(VertexType.MIRROR),
                 vt_t, full(VertexType.INVALID))
    return BsdfSample(omega_i=omega_i, f_r=f_r, pdf=pdf, vtype=vtype)


def _ts_eval(m, n, d, omega_i):
    """Torrance-Sparrow GGX, the reference's formulas with their quirks
    (pg/MaterialTS.cpp:7-69): the half vector (o + i) / 2 is not
    normalized, Smith G takes the half-vector dots, and alpha == 1 gives
    D = 1/pi."""
    omega_o = -d
    omega_m = (omega_o + omega_i) * 0.5          # unnormalized (quirk)
    m_dot_i = mathx.maximum(mathx.dot(omega_i, omega_m), 0.0)
    m_dot_o = mathx.maximum(mathx.dot(omega_o, omega_m), 0.0)
    n_dot_m = mathx.maximum(mathx.dot(omega_m, n), 0.0)
    alpha = m.roughness * m.roughness
    a2 = alpha * alpha

    inner = (a2 - 1.0) * n_dot_m * n_dot_m + 1.0
    d_ggx = torch.where(alpha == 1.0, _INV_PI,
                        _INV_PI * a2 / mathx.maximum(inner * inner, 1e-20))

    def g_aux(dd):
        # 1/1e-20 squared overflows float32: mathx.recip keeps the backward
        # finite where the TS branch is not selected (dd = 0)
        frac = mathx.recip(mathx.maximum(dd * dd, 1e-20)) - 1.0
        return (torch.sqrt(1.0 + a2 * frac) - 1.0) * 0.5

    g = 1.0 / (1.0 + g_aux(m_dot_o) + g_aux(m_dot_i))
    f0 = ((1.0 - m.ior) / (1.0 + m.ior)) ** 2
    f = f0 + (1.0 - f0) * (1.0 - m_dot_i) ** 5
    denom = mathx.maximum(m_dot_i * m_dot_o, 1e-20)
    spec = 0.25 * d_ggx * f * g / denom
    return m.diffuse * _INV_PI + spec[..., None]


def eval_bsdf(m, n, d, omega_i):
    """Material::evaluateBRDF: LAMBERT, PHONG, DIELECTRIC and TS evaluate;
    delta and base materials give 0."""
    t = m.mat_type
    d_refl, s_refl = _phong_reflectances(m, n, d)
    f_phong = _phong_eval(d_refl, s_refl, m.shininess, n, d, omega_i)
    out = torch.zeros_like(f_phong)
    out = torch.where(_bc(t == MatType.LAMBERT, out), m.diffuse * _INV_PI,
                      out)
    is_phg = (t == MatType.PHONG) | (t == MatType.DIELECTRIC)
    out = torch.where(_bc(is_phg, out), f_phong, out)
    return torch.where(_bc(t == MatType.TS, out),
                       _ts_eval(m, n, d, omega_i), out)


def pdf_bsdf(m, n, d, omega_i):
    """Material::getPdfForSample; 0 for delta and base materials."""
    t = m.mat_type
    d_refl, s_refl = _phong_reflectances(m, n, d)
    pdf_phong = _phong_pdf(d_refl, s_refl, m.shininess, n, d, omega_i)
    out = torch.zeros_like(pdf_phong)
    # TS samples as LAMBERT (the reference's MaterialTS::getType())
    out = torch.where((t == MatType.LAMBERT) | (t == MatType.TS),
                      sampling.pdf_cosine_hemisphere(n, omega_i), out)
    is_phg = (t == MatType.PHONG) | (t == MatType.DIELECTRIC)
    return torch.where(is_phg, pdf_phong, out)


# ---------------------------------------------------------------------------
# the G-buffer (screen-space) API of ReSTIR
# ---------------------------------------------------------------------------

def gbuf_eval_brdf(gb, omega_i):
    """ReSTIR's brdfEval(gBufferElem, cameraPos, omega_i)."""
    d = -mathx.normalize(gb.cam_pos - gb.pos)
    f_phong = _phong_eval(gb.diffuse, gb.specular, gb.shininess,
                          gb.normal, d, omega_i, inv_i_m=gb.inv_i_m)
    return torch.where((gb.mat_type == MatType.LAMBERT)[..., None],
                       gb.diffuse * _INV_PI, f_phong)


def gbuf_eval_pdf(gb, omega_i):
    """Always MaterialPhong::evalPdf (pg/MaterialPhong.cpp:150-172)."""
    d = mathx.normalize(gb.pos - gb.cam_pos)
    return _phong_pdf(gb.diffuse, gb.specular, gb.shininess,
                      gb.normal, d, omega_i)


def gbuf_sample_brdf_u(u5, gb) -> BsdfSample:
    """LAMBERT -> cosine sample; everything else -> Phong sample
    (pg/MaterialLambert.cpp:43-53, pg/MaterialPhong.cpp:174-222). The
    Lambert branch reuses the diffuse pair of u5."""
    d = mathx.normalize(gb.pos - gb.cam_pos)
    wi_p, f_p, pdf_p, vt_p = _phong_sample_u(
        u5, gb.diffuse, gb.specular, gb.shininess, gb.normal, d,
        inv_i_m=gb.inv_i_m)
    wi_l = sampling.cosine_hemisphere_from_uniforms(u5[..., 1:3], gb.normal)
    is_lam = gb.mat_type == MatType.LAMBERT
    return BsdfSample(
        omega_i=torch.where(is_lam[..., None], wi_l, wi_p),
        f_r=torch.where(is_lam[..., None], gb.diffuse * _INV_PI, f_p),
        pdf=torch.where(is_lam,
                        sampling.pdf_cosine_hemisphere(gb.normal, wi_l),
                        pdf_p),
        vtype=torch.where(is_lam, VertexType.DIFFUSE, vt_p).to(torch.int32))
