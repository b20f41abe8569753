"""The G-buffer (screen-space) BRDF API of ReSTIR (counterpart of the
`gbuf_*` functions of `tpu_restir.render.brdf`, brdf.py:292-330, and the
Phong helpers they call).

Conventions as the reference: `d` is the incident direction (into the
surface), `n` the shading normal flipped toward the viewer, Phong
specular uses the Mallett-Yuksel 1/I_M normalization. The screen-space
dispatch distinguishes only LAMBERT from everything else (Phong), and the
pdf is always Phong's (pg/ReSTIRIntegrator.h:32-59).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_restir_torch import mathx
from tpu_restir_torch.mathx.special import calc_i_m
from tpu_restir_torch.render import sampling
from tpu_restir_torch.scene.materials import MatType, VertexType

_INV_PI = 1.0 / math.pi
_EPS = 1e-12


@dataclasses.dataclass
class BsdfSample:
    omega_i: torch.Tensor  # (..., 3)
    f_r: torch.Tensor      # (..., 3)
    pdf: torch.Tensor      # (...,)
    vtype: torch.Tensor    # (...,) int32 VertexType


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
