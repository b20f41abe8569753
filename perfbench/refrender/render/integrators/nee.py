"""NEE path tracer: direct and indirect light apart, with a pluggable
direct-lighting strategy (counterpart of
`tpu_restir.render.integrators.nee`; reference
pg/NEEPathIntegrator.cpp:55-132). The wavefront keeps the last path
vertex's type, so that an emitter hit counts only when it is reached from
the camera or a mirror (no double counting, :93-97); the direct light of
each vertex comes from `direct.calculate_direct`."""

from __future__ import annotations

import dataclasses

import torch

from perfbench.refrender import mathx, rng
from perfbench.refrender.render import brdf, camera as cam_mod, intersect
from perfbench.refrender.render.integrators.direct import calculate_direct
from perfbench.refrender.scene.envmap import sky_radiance
from perfbench.refrender.scene.materials import (VertexType, apply_normal_map,
                                              apply_textures,
                                              gather_materials)


def render_nee(scene, cam, cfg, key):
    """One 1-spp frame, (H, W, 3) radiance, from the frame key."""
    p = cfg.params
    o, d = cam_mod.generate_rays(cam, cfg.camera, key)
    shape = o.shape[:-1]
    dev = o.device

    radiance = torch.zeros(shape + (3,), device=dev)
    weight = torch.ones(shape + (3,), device=dev)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    last_vtype = torch.full(shape, VertexType.CAMERA, dtype=torch.int32,
                            device=dev)
    di_key = rng.pass_key(key, rng.PASS_NEE_DIRECT)
    gi_key = rng.pass_key(key, rng.PASS_NEE_GI)

    for bounce in range(p.max_bounce_count + 1):
        hit = intersect.intersect_closest(scene, o, d, p.tnear_offset,
                                          float("inf"), cfg.intersector)
        hi = intersect.hit_attributes(scene, o, d, hit)
        m = apply_textures(scene, gather_materials(scene.materials,
                                                   hi.mat_id), hi.uv)
        hi = dataclasses.replace(hi, normal=apply_normal_map(
            scene, m, hi.normal, hi.tangent, hi.uv))

        miss = active & ~hi.did_hit
        radiance = radiance + torch.where(
            miss[..., None], weight * sky_radiance(scene, p, d), 0.0)
        active = active & hi.did_hit

        max_tp = torch.maximum(mathx.max_component(m.diffuse),
                               mathx.max_component(m.specular))
        do_rr = p.russian_roulette and bounce > p.rr_start_bounce
        if do_rr:
            active = active & (max_tp > rng.uniform(
                rng.draw_key(gi_key, 100 + bounce), shape, dev))

        # emitter hits count only from camera and mirror vertices
        emissive = m.is_emissive()
        count_emit = (last_vtype == VertexType.CAMERA) \
            | (last_vtype == VertexType.MIRROR)
        radiance = radiance + torch.where(
            (active & emissive & count_emit)[..., None],
            weight * m.emission, 0.0)
        active = active & ~emissive

        # the direct light of this vertex (pg/NEEPathIntegrator.cpp:100-103)
        if cfg.nee_calc_di:
            di = mathx.sanitize(calculate_direct(
                cfg.direct_strategy, rng.draw_key(di_key, bounce), scene, p,
                cfg, hi.point, hi.normal, m, d, hi.from_inside, hi.dst))
            radiance = radiance + torch.where(active[..., None],
                                              weight * di, 0.0)

        if bounce == p.max_bounce_count or not cfg.nee_calc_gi:
            break

        s = brdf.sample_bsdf(rng.draw_key(gi_key, bounce), m, hi.normal, d,
                             hi.from_inside, hi.dst)
        # |cos|, so that refraction continues (pg/NEEPathIntegrator.cpp:119)
        cos_i = torch.abs(mathx.dot(s.omega_i, hi.normal))
        denom = s.pdf * max_tp if do_rr else s.pdf
        weight = weight * mathx.sanitize(torch.where(
            (denom > 0.0)[..., None],
            s.f_r * (cos_i / mathx.maximum(denom, 1e-30))[..., None], 0.0))
        active = active & torch.any(weight > 0.0, dim=-1)
        last_vtype = torch.where(active, s.vtype, last_vtype)

        o = hi.point + hi.normal * p.normal_offset
        d = s.omega_i

    return mathx.sanitize(radiance)
