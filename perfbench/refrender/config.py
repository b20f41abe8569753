"""Frozen config dataclasses of the port.

The same fields and defaults as `tpu_restir.config` (a test holds the two
field by field), kept in the port so that it stands without the JAX
package. Attributes are read by name only, so a config of either package
drives the port; the tests hand the JAX package's config to both.
`load_config_file` reads a TOML or JSON render config, as
`tpu_restir.config` does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


class SpatialMis:
    """Spatial-reuse MIS/debiasing scheme names
    (reference pg/ReSTIRIntegrator.h:19-25)."""

    CONSTANT = "constant"                       # 1/M weights (biased)
    CONSTANT_DEBIAS_Z = "constant_debias_z"     # 1/M + 1/|Z| correction
    CONSTANT_DEBIAS_CONTRIB = "constant_debias_contrib"  # 1/M + contrib weight
    BALANCE_HEURISTIC = "balance"               # generalized balance, O(M^2)
    PAIRWISE = "pairwise"                       # pairwise MIS, O(M)

    ALL = (CONSTANT, CONSTANT_DEBIAS_Z, CONSTANT_DEBIAS_CONTRIB,
           BALANCE_HEURISTIC, PAIRWISE)


class PixelSamplerKind:
    """Anti-aliasing pixel samplers (reference pg/PixelSampler.h:6-67)."""

    CENTER = "center"          # always (0,0) offset — pixel corner, no AA
    RANDOM = "random"          # uniform jitter in [0,1)^2
    STRATIFIED = "stratified"  # jittered grid: random cell + in-cell jitter


class DirectStrategy:
    """NEE direct-lighting strategies (reference
    pg/NEEPathIntegrator.h:7-29)."""

    AREA = "area"
    BRDF = "brdf"
    MIS = "mis"
    RIS = "ris"


@dataclass(frozen=True)
class RenderParams:
    """Shared render knobs (reference pg/RenderParams.h:5-18 defaults)."""

    max_bounce_count: int = 5
    bg_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    use_skybox: bool = True
    tonemap: bool = True
    denoise: bool = False
    denoiser: str = "svgf"
    gamma_correct: bool = True
    tnear_offset: float = 0.01
    tfar_offset: float = 0.001
    normal_offset: float = 0.001
    russian_roulette: bool = True
    rr_start_bounce: int = 5
    # display-buffer debug pixel painted magenta, (x, y) or None
    debug_pixel: Optional[Tuple[int, int]] = None


@dataclass(frozen=True)
class RestirParams:
    """ReSTIR pipeline knobs (defaults per pg/ReSTIRIntegrator.cpp:13-33)."""

    m_area: int = 1
    m_brdf: int = 1
    confidence_cap: float = 20.0
    do_visibility_pass: bool = False
    do_temporal_reuse: bool = False
    do_spatial_reuse: bool = False
    spatial_pass_count: int = 1
    spatial_neighbor_count: int = 5
    spatial_reuse_radius: float = 30.0
    spatial_mis: str = SpatialMis.CONSTANT
    reject_dissimilar_neighbors: bool = False
    min_normal_similarity: float = 0.85
    max_depth_difference: float = 0.2
    # paint temporal-rejection reasons into the frame
    # (pg/ReSTIRIntegrator.cpp:647-689)
    debug_reprojection: bool = False


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera (reference pg/camera.h:18-83; up is +z)."""

    width: int = 640
    height: int = 480
    fov_y_deg: float = 45.0
    view_from: Tuple[float, float, float] = (0.0, -3.5, 1.0)
    view_at: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    pixel_sampler: str = PixelSamplerKind.CENTER
    jitter_grid: Tuple[int, int] = (5, 5)
    aperture: float = 0.0


@dataclass(frozen=True)
class IntersectorConfig:
    """Intersection backend selection (`render/intersect.py`): "auto",
    "fused" (K1/K2, up to `fused_max_tris` triangles), "ptrace" (K5/K6 on
    clustered scenes, in chunks of `ptrace_chunk` rays; K7/K8 with
    `ptrace_mxu` on scenes built at cluster size 128), "brute" and
    "woop_mxu" (every triangle, in blocks of `tri_block`), "cluster",
    "fcluster" (packets of `packet_size` rays, `shortlist_k` clusters a
    round, `bin_rays` to re-bin incoherent rays) and "bvh"; the last five
    take queries in chunks of `ray_chunk` rays, and "auto" takes
    "fcluster" over "cluster" above `bvh_threshold` triangles. Every field
    is read, as in the JAX package."""

    backend: str = "auto"
    ray_chunk: int = 1 << 18
    ptrace_chunk: int = 1 << 21
    ptrace_mxu: bool = False
    tri_block: int = 2048
    bvh_threshold: int = 4096
    fused_max_tris: int = 512
    packet_size: int = 256
    shortlist_k: int = 8
    bin_rays: bool = False


@dataclass(frozen=True)
class RenderConfig:
    """Top-level config."""

    camera: CameraConfig = CameraConfig()
    params: RenderParams = RenderParams()
    restir: RestirParams = RestirParams()
    intersector: IntersectorConfig = IntersectorConfig()

    integrator: str = "restir"  # "naive" | "nee" | "restir"
    direct_strategy: str = DirectStrategy.MIS
    ris_candidates: int = 8
    nee_calc_di: bool = True
    nee_calc_gi: bool = True
    show_weights: bool = False

    seed: int = 123
    accumulate: bool = True
    max_acc_count: int = 100000
    profile_passes: bool = False
    # restir_step returns right after this stage ("gbuffer" | "initial" |
    # "visibility" | "temporal" | "spatial"); None = the whole frame
    profile_stop_after: Optional[str] = None

    n_devices: int = 1
    mesh_axis: str = "tiles"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def replace(cfg, **kw):
    """dataclasses.replace that reads as config.replace for sub-configs."""
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Config files: TOML/JSON -> RenderConfig. Section names match the field
# names ([camera], [params], [restir], [intersector]); top-level keys set
# the RenderConfig scalars. CLI flags override file values
# (perfbench.refrender.cli --config).
# ---------------------------------------------------------------------------

_SECTIONS = {
    "camera": CameraConfig,
    "params": RenderParams,
    "restir": RestirParams,
    "intersector": IntersectorConfig,
}


def _build_section(cls, d: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown {cls.__name__} key {k!r}")
        kw[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


def config_from_dict(d: dict) -> RenderConfig:
    """Nested dict (parsed TOML/JSON) -> RenderConfig."""
    kw = {}
    top_fields = {f.name for f in dataclasses.fields(RenderConfig)}
    for k, v in d.items():
        if k in _SECTIONS:
            kw[k] = _build_section(_SECTIONS[k], v)
        elif k in top_fields:
            kw[k] = tuple(v) if isinstance(v, list) else v
        else:
            raise KeyError(f"unknown config key {k!r}")
    return RenderConfig(**kw)


def load_config_file(path: str) -> RenderConfig:
    """Load a .toml or .json render config."""
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            return config_from_dict(tomllib.load(f))
    if path.endswith(".json"):
        import json

        with open(path) as f:
            return config_from_dict(json.load(f))
    raise ValueError(f"config file must be .toml or .json, got {path!r}")
