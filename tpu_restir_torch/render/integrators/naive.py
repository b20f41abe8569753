"""Naive path tracer: BSDF sampling only, as a wavefront (counterpart of
`tpu_restir.render.integrators.naive`; reference
pg/NaivePathIntegrator.cpp:15-62, a per-pixel recursion with Russian
roulette after bounce 5). The recursion becomes a fixed bounce loop over
whole-image ray batches with active masks: at each bounce the wavefront
intersects the scene, adds emission or sky, then extends with one BSDF
sample."""

from __future__ import annotations

import dataclasses

import torch

from tpu_restir_torch import mathx, rng
from tpu_restir_torch.render import brdf, camera as cam_mod, intersect
from tpu_restir_torch.scene.envmap import sky_radiance
from tpu_restir_torch.scene.materials import (apply_normal_map,
                                              apply_textures,
                                              gather_materials)


def render_naive(scene, cam, cfg, key):
    """One 1-spp frame, (H, W, 3) radiance, from the frame key."""
    p = cfg.params
    o, d = cam_mod.generate_rays(cam, cfg.camera, key)
    shape = o.shape[:-1]
    dev = o.device

    radiance = torch.zeros(shape + (3,), device=dev)
    weight = torch.ones(shape + (3,), device=dev)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    gi_key = rng.pass_key(key, rng.PASS_NAIVE)

    for bounce in range(p.max_bounce_count + 1):
        bkey = rng.draw_key(gi_key, bounce)
        hit = intersect.intersect_closest(scene, o, d, p.tnear_offset,
                                          float("inf"), cfg.intersector)
        hi = intersect.hit_attributes(scene, o, d, hit)
        m = apply_textures(scene, gather_materials(scene.materials,
                                                   hi.mat_id), hi.uv)
        hi = dataclasses.replace(hi, normal=apply_normal_map(
            scene, m, hi.normal, hi.tangent, hi.uv))

        # a miss takes the sky or background (pg/NaivePathIntegrator.cpp:61)
        miss = active & ~hi.did_hit
        radiance = radiance + torch.where(
            miss[..., None], weight * sky_radiance(scene, p, d), 0.0)
        active = active & hi.did_hit

        # Russian roulette before the emitter test, as the reference
        # (pg/NaivePathIntegrator.cpp:31-36): killed w.p. 1 - maxThroughput
        max_tp = torch.maximum(mathx.max_component(m.diffuse),
                               mathx.max_component(m.specular))
        do_rr = p.russian_roulette and bounce > p.rr_start_bounce
        if do_rr:
            active = active & (max_tp > rng.uniform(rng.draw_key(bkey, 1),
                                                    shape, dev))

        # an emitter hit ends the path with its emission
        emissive = m.is_emissive()
        radiance = radiance + torch.where((active & emissive)[..., None],
                                          weight * m.emission, 0.0)
        active = active & ~emissive

        if bounce == p.max_bounce_count:
            break

        # extend the path by one BSDF sample
        s = brdf.sample_bsdf(rng.draw_key(bkey, 0), m, hi.normal, d,
                             hi.from_inside, hi.dst)
        cos_i = mathx.maximum(mathx.dot(s.omega_i, hi.normal), 0.0)
        # the RR compensation divides the indirect term only
        # (pg/NaivePathIntegrator.cpp:55)
        denom = s.pdf * max_tp if do_rr else s.pdf
        weight = weight * torch.where(
            (denom > 0.0)[..., None],
            s.f_r * (cos_i / mathx.maximum(denom, 1e-30))[..., None], 0.0)
        active = active & torch.any(weight > 0.0, dim=-1)

        o = hi.point + hi.normal * p.normal_offset
        d = s.omega_i

    return mathx.sanitize(radiance)
