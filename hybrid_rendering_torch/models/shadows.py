"""Ray-traced soft shadows with SVGF denoising (reference
src/ray_traced_shadows.{h,cpp}), as ``hybrid_rendering_tpu/models/
shadows.py``: ray trace -> temporal accumulation -> à-trous x N (K3) ->
(upsample if scaled). Visibility is a dense float plane."""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from hybrid_rendering_torch.config import ShadowsConfig
from hybrid_rendering_torch.ops import bluenoise, filters, kernels, stencil, temporal
from hybrid_rendering_torch.ops.lighting import fetch_light_properties
from hybrid_rendering_torch.ops.reprojection import reproject
from hybrid_rendering_torch.types import GBuffer, Light
from hybrid_rendering_torch.utils import profiler


@dataclasses.dataclass
class ShadowsState:
    """Temporal state (the reference's history/moments image pair)."""

    history: torch.Tensor  # (h,w) denoised visibility fed back
    moments: torch.Tensor  # (h,w,2)
    history_length: torch.Tensor  # (h,w)

    @staticmethod
    def create(height: int, width: int, device=None):
        z = torch.zeros((height, width), device=device)
        return ShadowsState(history=z, moments=torch.zeros((height, width, 2), device=device),
                            history_length=z.clone())


class ShadowsOutputs(NamedTuple):
    ray_trace: torch.Tensor
    temporal: torch.Tensor
    atrous: torch.Tensor
    final: torch.Tensor  # full-res visibility


def make_rays(gb: GBuffer, light: Light, frame_index: int, cfg: ShadowsConfig):
    """Shadow ray-gen (shadows_ray_trace.comp:73-131): blue-noise disk
    sample on the light, biased origin, t_max = 0 where the result is
    masked anyway. Returns (origin, dir, t_max, att)."""
    h, w = gb.depth.shape
    u, v = bluenoise.sample2d_grid(h, w, frame_index, dim=0, device=gb.depth.device)
    r2 = torch.stack([u, v], dim=-1)
    _, wi, t_max, att = fetch_light_properties(
        light, gb.position, gb.normal, rng2=r2 if cfg.soft_shadows else None,
        soft_shadows=cfg.soft_shadows)
    origin = gb.position + gb.normal * cfg.bias
    live = (gb.mesh_id >= 0) & (att > 0.0)
    return origin, wi, torch.where(live, t_max, 0.0), att


def finish_rays(vis, gb: GBuffer, att):
    """Mask the traced visibility back to the image (sky pixels -> 0)."""
    vis = torch.where(att > 0.0, vis, 0.0)
    return torch.where(gb.mesh_id >= 0, vis, 0.0)


def ray_trace(visibility_fn: Callable, gb: GBuffer, light: Light, frame_index: int,
              cfg: ShadowsConfig):
    origin, wi, t_max, att = make_rays(gb, light, frame_index, cfg)
    return finish_rays(visibility_fn(origin, wi, t_max), gb, att)


def temporal_accumulation(raw, gb: GBuffer, prev_gb: GBuffer, state: ShadowsState,
                          cfg: ShadowsConfig):
    """SVGF temporal pass (shadows_denoise_reprojection.comp:196-280):
    ``temporal_accumulation_plain`` for CPU tensors, K8 (ops/temporal.py)
    for CUDA tensors. Returns (visibility, variance, moments,
    history_length)."""
    if kernels.on_cpu(raw):
        return temporal_accumulation_plain(raw, gb, prev_gb, state, cfg)
    return temporal.shadows(raw, gb, prev_gb, state, cfg)


def temporal_accumulation_plain(raw, gb: GBuffer, prev_gb: GBuffer, state: ShadowsState,
                                cfg: ShadowsConfig):
    """The temporal pass in plain PyTorch, K8's twin."""
    geom = gb.mesh_id >= 0
    rep = reproject(gb, prev_gb, state.history, history_moments=state.moments,
                    history_length=state.history_length)
    success = rep.valid & geom
    history_length = torch.clamp(
        torch.where(success, rep.history_length + 1.0, 1.0), max=cfg.history_cap)

    mean = filters.box_filter_sum(raw, 8) / (17.0 * 17.0)
    # binary signal: E[x^2] = E[x] (comp:242-246)
    std = torch.sqrt(torch.clamp(mean - mean * mean, min=0.0))
    k = cfg.clamp_std_factor
    hist = torch.clamp(rep.history, mean - k * std, mean + k * std)
    hist = torch.where(success, hist, 0.0)

    alpha = torch.where(success, torch.clamp(1.0 / history_length, min=cfg.alpha), 1.0)
    alpha_m = torch.where(success, torch.clamp(1.0 / history_length, min=cfg.moments_alpha), 1.0)

    cur_moments = torch.stack([raw, raw * raw], dim=-1)
    prev_moments = torch.where(success[..., None], rep.history_moments, 0.0)
    moments = prev_moments + (cur_moments - prev_moments) * alpha_m[..., None]
    variance = torch.clamp(moments[..., 1] - moments[..., 0] ** 2, min=0.0)
    visibility = hist + (raw - hist) * alpha

    return (torch.where(geom, visibility, 0.0), torch.where(geom, variance, 0.0),
            torch.where(geom[..., None], moments, 0.0),
            torch.where(geom, history_length, 0.0))


def shadows_pass(visibility_fn: Callable, gb_scaled: GBuffer, prev_gb_scaled: GBuffer,
                 gb_full: GBuffer, light: Light, state: ShadowsState, frame_index: int,
                 cfg: ShadowsConfig, raw=None):
    """Full shadows pipeline (ray_traced_shadows.cpp:100-116). Returns
    (outputs, new_state). raw: an already-traced visibility plane (the
    renderer's batched wavefront); None traces here."""
    if raw is None:
        with profiler.span("ray_trace"):
            raw = ray_trace(visibility_fn, gb_scaled, light, frame_index, cfg)

    def upsample(x):
        if cfg.scale == 0:
            return x
        with profiler.span("upsample"):
            return filters.upsample_edge_aware(x, gb_scaled.normal, gb_scaled.linear_z,
                                               gb_full.normal, gb_full.linear_z, int(cfg.scale))

    if not cfg.denoise:
        return ShadowsOutputs(raw, raw, raw, upsample(raw)), state

    with profiler.span("temporal"):
        vis, variance, moments, hist_len = temporal_accumulation(
            raw, gb_scaled, prev_gb_scaled, state, cfg)
    temporal_out = vis
    feedback = vis
    if cfg.atrous_iterations > 0:
        with profiler.span("atrous"):
            steps = tuple(1 << i for i in range(cfg.atrous_iterations))
            vis, feedback, variance = stencil.atrous_chain(
                vis, variance, gb_scaled.normal, gb_scaled.linear_z,
                gb_scaled.mesh_id >= 0, steps=steps, radius=cfg.atrous_radius,
                phi_color=cfg.phi_visibility, phi_normal=cfg.phi_normal,
                sigma_depth=cfg.sigma_depth, feedback_iteration=cfg.feedback_iteration)
            vis = torch.pow(torch.clamp(vis, min=0.0), cfg.power)  # comp:170-171

    new_state = ShadowsState(history=feedback, moments=moments, history_length=hist_len)
    return ShadowsOutputs(raw, temporal_out, vis, upsample(vis)), new_state
