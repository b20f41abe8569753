"""Environment lookup for rays that leave the scene: the flat background
colour (pg/RenderParams.h bgColor). Equirectangular maps are not ported."""

from __future__ import annotations

import torch


def sky_radiance(scene, params, d):
    """Radiance for rays that leave the scene, shaped like d."""
    if params.use_skybox and scene.envmap is not None:
        raise NotImplementedError(
            "environment maps are not ported yet (ROADMAP item 11)")
    bg = torch.tensor(params.bg_color, dtype=torch.float32, device=d.device)
    return bg.expand(d.shape)
