"""Image statistics and the analytic ray count of a ReSTIR frame."""

from __future__ import annotations

import torch


def image_mean_variance(img):
    """Mean and variance of the per-pixel channel mean (the reference's
    image statistics, pg/simpleguidx11.cpp:308-329)."""
    pix = torch.mean(img, dim=-1)
    mean = torch.mean(pix)
    return mean, torch.mean(pix * pix) - mean * mean


def rays_per_pixel(cfg) -> int:
    """Closest-hit + occlusion queries per pixel per frame for this config
    (the reference's per-pass trace counts, SURVEY.md §3.2); the count of
    the repository's bench.py."""
    r = cfg.restir
    test_vis = 0 if r.do_visibility_pass else 1
    closest = 1 + r.m_brdf                      # G-buffer + BRDF candidates
    occl = (r.m_area + r.m_brdf + 1) * test_vis  # initial p_hats + finalize
    occl += 1 if r.do_visibility_pass else 0
    if r.do_temporal_reuse:
        occl += 5                                # 4 MIS p_hats + finalize
    if r.do_spatial_reuse:
        k = r.spatial_neighbor_count
        if r.spatial_mis == "balance":
            per_pass = (k + 1) ** 2 + 1
        elif r.spatial_mis == "pairwise":
            per_pass = 3 * k + 2
        else:
            per_pass = (k + 1) + 1
        occl += per_pass * r.spatial_pass_count
    occl += 1                                    # final shading visibility
    return closest + occl
