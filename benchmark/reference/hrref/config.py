"""Config dataclass tree — field-for-field the same as
``hybrid_rendering_tpu/config.py`` (the JAX package cannot be imported
where JAX is not installed, so the PyTorch port carries its own copy; the
parity tests hold the two equal for every preset).

Defaults replicate the reference's defaults, cited per field.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from enum import IntEnum


class RayTraceScale(IntEnum):
    """Reference RAY_TRACE_SCALE_* (src/common.h:39-44)."""

    FULL = 0
    HALF = 1
    QUARTER = 2

    @property
    def divisor(self) -> int:
        return 1 << int(self)


@dataclass(frozen=True)
class ShadowsConfig:
    """Ray-traced shadows pass (src/ray_traced_shadows.h)."""

    enabled: bool = True
    scale: RayTraceScale = RayTraceScale.FULL  # ray_traced_shadows.h:23
    # Ray origin offset along the normal. The reference shadow pass uses
    # 0.5 (ray_traced_shadows.h:52, Sponza-scale world) while its OWN GT
    # offsets by 0.1 (lighting.glsl:143) — the mismatch widens hybrid
    # penumbras vs the oracle (origin 0.5 above a surface sees more of
    # the light disk around an occluder edge). Measured on gi_test r3:
    # pooled RMSE 0.083 -> 0.075 at 0.1. GT-consistent 0.1 is default.
    bias: float = 0.1
    soft_shadows: bool = True
    # temporal accumulation (ray_traced_shadows.h:69-70)
    alpha: float = 0.01
    moments_alpha: float = 0.2
    history_cap: float = 32.0  # shadows_denoise_reprojection.comp:237
    # History clamp half-width in neighborhood-stds. Reference hardcodes
    # 0.5 (shadows_denoise_reprojection.comp:245-249); on static converged
    # views that clamp BIASES visibility toward the 17x17 mean (-0.037
    # mean visibility on gi_test vs an unbiased raw trace, r5 offline
    # sweep of the captured per-frame traces: 0.5 -> -0.0369, 1.0 ->
    # -0.0124, 2.0 -> -0.0080 = the raw trace's own bias). Presets of
    # fidelity-gated static scenes widen it; 0.5 stays the default for
    # reference-parity ghosting behavior under motion.
    clamp_std_factor: float = 0.5
    # a-trous (ray_traced_shadows.h:104-109)
    denoise: bool = True
    atrous_iterations: int = 4
    atrous_radius: int = 1
    feedback_iteration: int = 1
    phi_visibility: float = 0.3
    phi_normal: float = 32.0
    sigma_depth: float = 1.0
    power: float = 1.2  # pow() darkening on final iteration


@dataclass(frozen=True)
class AOConfig:
    """Ray-traced ambient occlusion (src/ray_traced_ao.h)."""

    enabled: bool = True
    scale: RayTraceScale = RayTraceScale.HALF  # ray_traced_ao.h:23
    ray_length: float = 7.0  # ray_traced_ao.h:53
    bias: float = 0.3  # ray_traced_ao.h:54
    # temporal
    alpha: float = 0.01
    history_cap: float = 32.0
    denoise: bool = True
    blur_radius: int = 4  # separable bilateral radius
    power: float = 1.2  # ao_upsample.comp:108


@dataclass(frozen=True)
class ReflectionsConfig:
    """Ray-traced reflections (src/ray_traced_reflections.h)."""

    enabled: bool = True
    scale: RayTraceScale = RayTraceScale.HALF  # ray_traced_reflections.h:24
    bias: float = 0.5
    trim: float = 0.8  # GGX sample trim (reflections_ray_trace.rgen:157-166)
    approximate_with_ddgi: bool = True  # roughness>0.75 -> sample DDGI, no ray
    sample_gi: bool = True  # rchit adds DDGI indirect
    # probe-grid evaluation density within the (already scale-reduced)
    # reflection buffer: 1 = per reflection pixel (reference-exact,
    # rchit:87-111); 2 = every 2nd pixel + edge-aware upsample — at the
    # HALF default this equals the QUARTER screen density the reference
    # itself uses for the deferred GI buffer; the probe-cage eval is the
    # most expensive part of the pass (TPU timing in the JAX package)
    gi_sample_step: int = 2
    gi_intensity: float = 0.5
    rough_ddgi_intensity: float = 0.5
    ibl_indirect_specular_intensity: float = 0.05
    firefly_clamp: float = 0.7  # rgen:168
    mirror_roughness_threshold: float = 0.05  # common.glsl MIRROR_*
    ddgi_roughness_threshold: float = 0.75  # common.glsl DDGI_*
    # temporal
    alpha: float = 0.01
    moments_alpha: float = 0.2
    accumulation_cap_moving: float = 8.0  # reflections_denoise_reprojection.comp:161-168
    history_cap: float = 32.0
    denoise: bool = True
    atrous_iterations: int = 4
    atrous_radius: int = 1
    feedback_iteration: int = 1
    phi_color: float = 10.0
    phi_normal: float = 32.0
    sigma_depth: float = 1.0


@dataclass(frozen=True)
class DDGIConfig:
    """DDGI probe-grid GI (src/ddgi.h:54-97)."""

    enabled: bool = True
    # sample-pass resolution: the reference offers full/half
    # (ddgi.cpp final sample image); QUARTER + the edge-aware upsample is
    # the JAX package's default (GI is smooth). Per-scene presets raise it
    # for fidelity-gated scenes.
    scale: RayTraceScale = RayTraceScale.QUARTER
    probe_distance: float = 1.0  # per-scene override (src/main.cpp:1092-1142)
    # reference default 256 (ddgi.h:56, GUI-selectable); 128 halves the
    # probe trace/shade work and the hysteresis average restores the
    # effective sample count across frames
    rays_per_probe: int = 128
    irradiance_oct_size: int = 8  # texels per probe side (ddgi.cpp:196)
    depth_oct_size: int = 16
    hysteresis: float = 0.98  # ddgi.h:73
    depth_sharpness: float = 50.0
    normal_bias: float = 0.25  # per-scene override
    # Physically-calibrated default (validated against the bundled GT
    # path tracer); the reference ships 0.85 (ddgi.h:88), an artistic
    # haircut that reads as ~15% missing indirect light vs its own GT.
    energy_preservation: float = 1.0
    recursive_energy_preservation: float = 1.0
    infinite_bounces: bool = True
    # physically 1.0; reference default 1.7 (artistic boost)
    infinite_bounce_intensity: float = 1.0
    gi_intensity: float = 1.0
    # Clamp per-ray probe radiance to the same RADIANCE_CLAMP_COLOR (=1)
    # the GT path tracer applies per sample
    # (ground_truth_path_trace.rgen:93-95). Without it the probes
    # transport unclamped energy from small bright spots (e.g. a sunlit
    # patch at radiance 5.5) that the GT oracle clips to 1.0 — measured
    # as a 2x irradiance excess at the gi_test ceiling. <=0 disables.
    probe_radiance_clamp: float = 1.0
    visibility_test: bool = True
    max_distance_factor: float = 1.5  # max_distance = 1.5*probe_distance (ddgi.cpp:169)
    probe_grid_padding: int = 2  # +2 probes per axis (ddgi.cpp:150-169)
    # "padded" (default, reference layout: rows on the AABB min + padding
    # rows beyond the max) vs "interior" (rows inset inside the AABB;
    # ~1.4x fewer probes). Measured on gi_test r3: padded 0.084 pooled
    # RMSE vs interior 0.093 — the inset rows sit so close to walls that
    # their Chebyshev depth crushes their contribution to points farther
    # along the same wall, darkening boundary surfaces. See
    # models/ddgi.py make_probe_grid.
    grid_layout: str = "padded"


@dataclass(frozen=True)
class TAAConfig:
    """Temporal AA (src/temporal_aa.h, src/shaders/taa.comp)."""

    enabled: bool = True
    sharpen: bool = True
    feedback_min: float = 0.88
    feedback_max: float = 0.97
    # velocity-space motion blur on the current color (7 jittered taps
    # along the dilated velocity, taa.comp:218-236 sample_color_motion +
    # noise.glsl srand). The reference defines but never calls it; same
    # default here.
    motion_blur: bool = False
    motion_blur_taps: int = 3  # taps on either side (taa.comp:221)


@dataclass(frozen=True)
class ToneMapConfig:
    exposure: float = 1.0
    aces: bool = True
    gamma: float = 2.2


@dataclass(frozen=True)
class PathTracerConfig:
    """Ground-truth path tracer (src/ground_truth_path_tracer.h). Unlike
    the reference (whose recursive bounce is commented out,
    ground_truth_path_trace.rchit:94-105) the indirect bounce is live."""

    max_ray_bounces: int = 3
    shadow_ray_bias: float = 0.1
    sample_sky: bool = True


@dataclass(frozen=True)
class DeferredConfig:
    indirect_specular_strength: float = 2.0  # deferred.frag:28


@dataclass(frozen=True)
class RendererConfig:
    """Top-level config — one per HybridRenderer instance."""

    width: int = 1920
    height: int = 1080
    shadows: ShadowsConfig = field(default_factory=ShadowsConfig)
    ao: AOConfig = field(default_factory=AOConfig)
    reflections: ReflectionsConfig = field(default_factory=ReflectionsConfig)
    ddgi: DDGIConfig = field(default_factory=DDGIConfig)
    taa: TAAConfig = field(default_factory=TAAConfig)
    tonemap: ToneMapConfig = field(default_factory=ToneMapConfig)
    path_tracer: PathTracerConfig = field(default_factory=PathTracerConfig)
    deferred: DeferredConfig = field(default_factory=DeferredConfig)
    # compute options
    use_bvh: bool = True
    bvh_stack_depth: int = 32
    dtype: str = "float32"  # accumulators stay f32; images may be bf16
    # Materialize per-pass debug outputs (ray_trace/temporal/atrous planes,
    # probe visualization). The reference only renders the selected debug
    # view (output_ds switching, tone_map.cpp:105-123); keeping this False
    # lets XLA fuse/free intermediates instead of writing ~20 full-res
    # planes to HBM every frame.
    debug_outputs: bool = False

    def replace(self, **kw) -> "RendererConfig":
        return dataclasses.replace(self, **kw)


def reference_parity(cfg: RendererConfig) -> RendererConfig:
    """Restore the upstream renderer's artistic GI constants for visual
    side-by-side comparisons with the reference (JAX ``config.py``
    ``reference_parity``): its extra 0.5*pi sample scale
    (gi_common.glsl:316), its energy haircuts (ddgi.h:88
    energy_preservation=0.85, recursive 0.95 in gi_probe_update.glsl), the
    1.7x infinite-bounce boost (ddgi.h), and no probe radiance clamp. The
    renders then match upstream screenshots and overshoot the bundled GT
    path tracer."""
    return cfg.replace(ddgi=dataclasses.replace(
        cfg.ddgi,
        energy_preservation=0.85,
        recursive_energy_preservation=0.95,
        infinite_bounce_intensity=1.7,
        gi_intensity=cfg.ddgi.gi_intensity * 0.5 * math.pi,
        probe_radiance_clamp=0.0,
    ))
