"""Stochastic ray-traced reflections with their own SVGF, as
``hybrid_rendering_tpu/models/reflections.py`` (reference
src/ray_traced_reflections.{h,cpp}, src/shaders/reflections/*):

  - roughness-branched rays (reflections_ray_trace.rgen:119-171): a mirror
    ray below roughness 0.05; no ray above 0.75, where the probe grid is
    sampled along R instead; a GGX half-vector sample with the `trim`
    scaled blue-noise sample in between; a firefly clamp at 0.7;
  - hit shading (rchit:117-150): direct light with a shadow ray (K2),
    the DDGI diffuse at the hit (K5, one merged call with the rough
    pixels' DDGI, at every 2nd pixel then edge-aware upsampled) and the
    split-sum IBL specular;
  - temporal pass (reflections_denoise_reprojection.comp): virtual-point
    reprojection, a 17x17 colour AABB clip, a camera-motion capped
    history;
  - à-trous (K3, 3 channels) on the pixels between the two roughness
    thresholds; mirror and DDGI pixels pass through; edge-aware upsample.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from hybrid_rendering_torch.config import ReflectionsConfig
from hybrid_rendering_torch.models.gbuffer import nearest_downsample
from hybrid_rendering_torch.ops import bluenoise, filters, kernels, stencil, temporal
from hybrid_rendering_torch.ops import brdf as brdf_ops
from hybrid_rendering_torch.ops import rng as rng_ops
from hybrid_rendering_torch.ops.lighting import direct_lighting
from hybrid_rendering_torch.ops.math3d import dot, luminance, normalize, reflect
from hybrid_rendering_torch.ops.reprojection import reproject, virtual_point_coords
from hybrid_rendering_torch.types import Camera, GBuffer, Light
from hybrid_rendering_torch.utils import profiler
from hybrid_rendering_torch.utils.camera import pixel_grid


@dataclasses.dataclass
class ReflectionsState:
    history: torch.Tensor  # (h,w,3)
    moments: torch.Tensor  # (h,w,2)
    history_length: torch.Tensor  # (h,w)

    @staticmethod
    def create(height: int, width: int, device=None) -> "ReflectionsState":
        return ReflectionsState(
            history=torch.zeros((height, width, 3), device=device),
            moments=torch.zeros((height, width, 2), device=device),
            history_length=torch.zeros((height, width), device=device))


class ReflectionsOutputs(NamedTuple):
    ray_trace: torch.Tensor  # (h,w,3)
    ray_length: torch.Tensor  # (h,w)
    temporal: torch.Tensor
    atrous: torch.Tensor
    final: torch.Tensor  # (H,W,3)


def ray_trace(closest_surface_fn: Callable, visibility_fn: Callable, gb: GBuffer,
              camera: Camera, light: Light, sky_radiance_fn: Callable, frame_index: int,
              cfg: ReflectionsConfig, gi_sample_fn: Optional[Callable] = None,
              env_prefiltered_fn: Optional[Callable] = None):
    """One reflection ray a pixel with the roughness-branched strategy.
    gi_sample_fn(p, n, wo, valid=None) samples the probe grid. Returns
    (color (h,w,3), ray_length (h,w), -1 where no ray hit)."""
    h, w = gb.depth.shape
    dev = gb.depth.device
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    rng = rng_ops.rng_init(xx.reshape(-1), yy.reshape(-1), frame_index)
    bu, bv = bluenoise.sample2d_grid(h, w, frame_index, dim=2, device=dev)
    r2 = torch.stack([bu, bv], dim=-1) * cfg.trim  # trim (rgen:157-166)

    p, n = gb.position, gb.normal
    wo = normalize(camera.position - p)
    geom = gb.mesh_id >= 0

    mirror_dir = reflect(-wo, n)
    wh = brdf_ops.sample_specular_ggx_lobe(n, gb.roughness * gb.roughness, r2)
    ggx_dir = reflect(-wo, wh)
    ggx_dir = torch.where((dot(ggx_dir, n) < 1e-3)[..., None], mirror_dir, ggx_dir)
    is_mirror = gb.roughness < cfg.mirror_roughness_threshold
    ray_dir = torch.where(is_mirror[..., None], mirror_dir, ggx_dir)

    if cfg.approximate_with_ddgi and gi_sample_fn is not None:
        use_ddgi = gb.roughness > cfg.ddgi_roughness_threshold
    else:
        use_ddgi = torch.zeros_like(geom)
    needs_ray = geom & ~use_ddgi

    # pixels approximated by DDGI (or sky) trace nothing: t_max = 0
    origin = p + n * cfg.bias
    hit, surf = closest_surface_fn(origin, ray_dir, torch.where(needs_ray, 1e4, 0.0))
    hit_valid = hit.valid & needs_ray

    # --- shade hits (rchit) ---
    sp, sn, s_rough, s_metal = surf.position, surf.normal, surf.roughness, surf.metallic
    f0 = brdf_ops.f0_from_metallic(surf.albedo, s_metal)
    c_diff = surf.albedo * (1.0 - f0) * (1.0 - s_metal[..., None])
    s_wo = -ray_dir
    rng, rs = rng_ops.next_vec2(rng)

    # shadow rays only where the reflection ray hit geometry
    hit_color = direct_lighting(light, s_wo, sn, sp, f0, c_diff, s_rough,
                                visibility_fn=visibility_fn, rng_shadow=rs.reshape(h, w, 2),
                                valid=hit_valid) + surf.emissive

    # one probe-grid evaluation serves the hit-point diffuse (needs_ray
    # pixels) and the rough pixels' DDGI along R (use_ddgi pixels): the
    # two sets are disjoint, so per-pixel selected inputs are exact
    gi_merged = None
    want_hit_gi = cfg.sample_gi and gi_sample_fn is not None
    want_ddgi_approx = cfg.approximate_with_ddgi and gi_sample_fn is not None
    if want_hit_gi or want_ddgi_approx:
        sel = use_ddgi[..., None]
        gi_p = torch.where(sel, p, sp)
        gi_n = torch.where(sel, mirror_dir, sn)
        gi_wo = torch.where(sel, wo, s_wo)
        gi_valid = (use_ddgi & geom) | (needs_ray & hit.valid)
        s = int(cfg.gi_sample_step)
        if s > 1 and (s & (s - 1)) == 0 and h % s == 0 and w % s == 0:
            # sparse probe-cage evaluation + joint-bilateral upsample on the
            # primary surface guides
            gi_low = gi_sample_fn(nearest_downsample(gi_p, s), nearest_downsample(gi_n, s),
                                  nearest_downsample(gi_wo, s),
                                  valid=nearest_downsample(gi_valid, s))
            gi_merged = filters.upsample_edge_aware(
                gi_low, nearest_downsample(gb.normal, s), nearest_downsample(gb.linear_z, s),
                gb.normal, gb.linear_z, s.bit_length() - 1)
        else:
            gi_merged = gi_sample_fn(gi_p, gi_n, gi_wo, valid=gi_valid)

    # indirect at the hit (rchit:87-111): kD x DDGI diffuse + split-sum IBL
    if want_hit_gi or env_prefiltered_fn is not None:
        s_ndotv = torch.clamp(dot(sn, s_wo), 0.0, 1.0)
        kS = brdf_ops.fresnel_schlick_roughness(s_ndotv, f0, s_rough)
    if want_hit_gi:
        kD = (1.0 - kS) * (1.0 - s_metal[..., None])
        hit_color = hit_color + kD * gi_merged * c_diff * cfg.gi_intensity
    if env_prefiltered_fn is not None:
        spec = env_prefiltered_fn(reflect(-s_wo, sn), s_rough)
        scale, bias = brdf_ops.env_brdf_approx(s_rough, s_ndotv)
        hit_color = hit_color + spec * (kS * scale[..., None] + bias[..., None]) \
            * cfg.ibl_indirect_specular_intensity

    # misses: environment (rmiss)
    color = torch.where(hit_valid[..., None], hit_color, sky_radiance_fn(ray_dir))
    if want_ddgi_approx:  # rough pixels: DDGI along R (rgen:152-156)
        color = torch.where(use_ddgi[..., None], gi_merged * cfg.rough_ddgi_intensity, color)
    color = torch.clamp(color, max=cfg.firefly_clamp)  # rgen:168
    color = torch.where(geom[..., None], color, 0.0)

    ray_length = torch.where(hit_valid, hit.t, -1.0)
    ray_length = torch.where(needs_ray, ray_length, -1.0)
    return color, ray_length


def temporal_accumulation(raw, ray_length, gb: GBuffer, prev_gb: GBuffer, camera: Camera,
                          camera_delta, state: ReflectionsState, cfg: ReflectionsConfig):
    """Reflections temporal pass (reflections_denoise_reprojection.comp):
    virtual-point reprojection, AABB clip, motion-capped accumulation.
    camera_delta is the frame-to-frame camera movement, a () tensor.
    ``temporal_accumulation_plain`` for CPU tensors, K8 (ops/temporal.py)
    for CUDA tensors. Returns (color, variance, moments, history_length)."""
    if kernels.on_cpu(raw):
        return temporal_accumulation_plain(raw, ray_length, gb, prev_gb, camera, camera_delta,
                                           state, cfg)
    return temporal.reflections(raw, ray_length, gb, prev_gb, camera, camera_delta, state, cfg)


def temporal_accumulation_plain(raw, ray_length, gb: GBuffer, prev_gb: GBuffer,
                                camera: Camera, camera_delta, state: ReflectionsState,
                                cfg: ReflectionsConfig):
    """The temporal pass in plain PyTorch, K8's twin."""
    geom = gb.mesh_id >= 0
    H, W = gb.depth.shape

    # virtual-point coords where ray_length > 0 and curvature == 0
    # (reprojection.glsl:98-111), surface reprojection elsewhere
    vx, vy = virtual_point_coords(gb, camera, torch.clamp(ray_length, min=0.0))
    yy, xx = pixel_grid(H, W, gb.depth.device)
    use_virtual = (ray_length > 0.0) & (gb.curvature == 0.0)
    hx = torch.where(use_virtual, vx, xx + gb.motion[..., 0] * W)
    hy = torch.where(use_virtual, vy, yy + gb.motion[..., 1] * H)
    rep = reproject(gb, prev_gb, state.history, history_moments=state.moments,
                    history_length=state.history_length, reprojected_coord=(hx, hy))
    success = rep.valid & geom

    # camera-motion-aware accumulation cap (comp:161-168)
    cap = torch.where(camera_delta > 1e-5, cfg.accumulation_cap_moving, cfg.history_cap)
    history_length = torch.minimum(cap, torch.where(success, rep.history_length + 1.0, 1.0))

    # 17x17 colour mean/sigma AABB clip (comp:111-157, 221-232)
    n17 = 17.0 * 17.0
    m1 = filters.box_filter_sum(raw, 8) / n17
    m2 = filters.box_filter_sum(raw * raw, 8) / n17
    sigma = torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0))
    box_min, box_max = m1 - sigma, m1 + sigma
    center = 0.5 * (box_max + box_min)
    extent = 0.5 * (box_max - box_min) + 1e-5
    vc = rep.history - center
    ma = torch.amax(torch.abs(vc / extent), dim=-1, keepdim=True)
    hist = torch.where(ma > 1.0, center + vc / torch.clamp(ma, min=1e-6), rep.history)
    hist = torch.where(success[..., None], hist, 0.0)

    alpha = torch.where(success, torch.clamp(1.0 / history_length, min=cfg.alpha), 1.0)
    alpha_m = torch.where(success, torch.clamp(1.0 / history_length, min=cfg.moments_alpha),
                          1.0)

    lum = luminance(raw)
    cur_moments = torch.stack([lum, lum * lum], dim=-1)
    prev_moments = torch.where(success[..., None], rep.history_moments, 0.0)
    moments = prev_moments + (cur_moments - prev_moments) * alpha_m[..., None]
    variance = torch.clamp(moments[..., 1] - moments[..., 0] ** 2, min=0.0)

    color = hist + (raw - hist) * alpha[..., None]
    color = torch.where(geom[..., None], color, 0.0)
    return color, variance, moments, torch.where(geom, history_length, 0.0)


def reflections_pass(closest_surface_fn: Callable, visibility_fn: Callable,
                     gb_scaled: GBuffer, prev_gb_scaled: GBuffer, gb_full: GBuffer,
                     camera: Camera, camera_delta, light: Light, sky_radiance_fn: Callable,
                     state: ReflectionsState, frame_index: int, cfg: ReflectionsConfig,
                     gi_sample_fn: Optional[Callable] = None,
                     env_prefiltered_fn: Optional[Callable] = None):
    """The whole reflections pass (ray_traced_reflections.cpp:107-123).
    Returns (ReflectionsOutputs, new ReflectionsState)."""
    with profiler.span("ray_trace"):
        raw, ray_length = ray_trace(closest_surface_fn, visibility_fn, gb_scaled, camera, light,
                                    sky_radiance_fn, frame_index, cfg, gi_sample_fn,
                                    env_prefiltered_fn)

    def upsample(x):
        if cfg.scale == 0:
            return x
        with profiler.span("upsample"):
            return filters.upsample_edge_aware(x, gb_scaled.normal, gb_scaled.linear_z,
                                               gb_full.normal, gb_full.linear_z, int(cfg.scale))

    if not cfg.denoise:
        return ReflectionsOutputs(raw, ray_length, raw, raw, upsample(raw)), state

    with profiler.span("temporal"):
        color, variance, moments, hist_len = temporal_accumulation(
            raw, ray_length, gb_scaled, prev_gb_scaled, camera, camera_delta, state, cfg)

    out = feedback = color
    if cfg.atrous_iterations > 0:
        with profiler.span("atrous"):
            # denoise only mirror_threshold <= roughness <= ddgi_threshold;
            # mirror and DDGI pixels pass through (comp:262-288)
            denoise_mask = ((gb_scaled.mesh_id >= 0)
                            & (gb_scaled.roughness >= cfg.mirror_roughness_threshold)
                            & (gb_scaled.roughness <= cfg.ddgi_roughness_threshold))
            out, feedback, variance = stencil.atrous_chain(
                color, variance, gb_scaled.normal, gb_scaled.linear_z, denoise_mask,
                steps=tuple(1 << i for i in range(cfg.atrous_iterations)),
                radius=cfg.atrous_radius, phi_color=cfg.phi_color, phi_normal=cfg.phi_normal,
                sigma_depth=cfg.sigma_depth, feedback_iteration=cfg.feedback_iteration)

    new_state = ReflectionsState(history=feedback, moments=moments, history_length=hist_len)
    return ReflectionsOutputs(raw, ray_length, color, out, upsample(out)), new_state
