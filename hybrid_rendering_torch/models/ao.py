"""Ray-traced ambient occlusion (reference src/ray_traced_ao.{h,cpp}), as
``hybrid_rendering_tpu/models/ao.py``: one cosine-lobe ray of finite
length per pixel, temporal accumulation without moments, separable
bilateral blur (K4), edge-aware upsample and pow() at the end."""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from hybrid_rendering_torch.config import AOConfig
from hybrid_rendering_torch.ops import bluenoise, brdf as brdf_ops, filters, kernels
from hybrid_rendering_torch.ops import stencil, temporal
from hybrid_rendering_torch.ops.reprojection import reproject
from hybrid_rendering_torch.types import GBuffer
from hybrid_rendering_torch.utils import profiler


@dataclasses.dataclass
class AOState:
    history: torch.Tensor  # (h,w)
    history_length: torch.Tensor  # (h,w)

    @staticmethod
    def create(height: int, width: int, device=None):
        return AOState(history=torch.zeros((height, width), device=device),
                       history_length=torch.zeros((height, width), device=device))


class AOOutputs(NamedTuple):
    ray_trace: torch.Tensor
    temporal: torch.Tensor
    blur: torch.Tensor
    final: torch.Tensor


def make_rays(gb: GBuffer, frame_index: int, cfg: AOConfig):
    """AO ray-gen (ao_ray_trace.comp:90-126): cosine-lobe sample, biased
    origin, finite t_max (0 on sky pixels)."""
    h, w = gb.depth.shape
    u, v = bluenoise.sample2d_grid(h, w, frame_index, dim=1, device=gb.depth.device)
    wi = brdf_ops.sample_cosine_lobe(gb.normal, torch.stack([u, v], dim=-1))
    origin = gb.position + gb.normal * cfg.bias
    return origin, wi, torch.where(gb.mesh_id >= 0, cfg.ray_length, 0.0)


def finish_rays(vis, gb: GBuffer):
    """Mask the traced visibility back to the image (sky pixels -> 1)."""
    return torch.where(gb.mesh_id >= 0, vis, 1.0)


def ray_trace(visibility_fn: Callable, gb: GBuffer, frame_index: int, cfg: AOConfig):
    origin, wi, t_max = make_rays(gb, frame_index, cfg)
    return finish_rays(visibility_fn(origin, wi, t_max), gb)


def temporal_accumulation(raw, gb: GBuffer, prev_gb: GBuffer, state: AOState, cfg: AOConfig):
    """Single-channel reprojection without moments
    (ao_denoise_reprojection.comp:222-259): ``temporal_accumulation_plain``
    for CPU tensors, K8 (ops/temporal.py) for CUDA tensors. Returns (ao,
    history_length)."""
    if kernels.on_cpu(raw):
        return temporal_accumulation_plain(raw, gb, prev_gb, state, cfg)
    return temporal.ao(raw, gb, prev_gb, state, cfg)


def temporal_accumulation_plain(raw, gb: GBuffer, prev_gb: GBuffer, state: AOState,
                                cfg: AOConfig):
    """The temporal pass in plain PyTorch, K8's twin."""
    geom = gb.mesh_id >= 0
    rep = reproject(gb, prev_gb, state.history, history_length=state.history_length)
    success = rep.valid & geom
    history_length = torch.clamp(
        torch.where(success, rep.history_length + 1.0, 1.0), max=cfg.history_cap)
    alpha = torch.where(success, torch.clamp(1.0 / history_length, min=cfg.alpha), 1.0)
    hist = torch.where(success, rep.history, 0.0)
    ao = hist + (raw - hist) * alpha
    return torch.where(geom, ao, 1.0), history_length


def ao_pass(visibility_fn: Callable, gb_scaled: GBuffer, prev_gb_scaled: GBuffer,
            gb_full: GBuffer, state: AOState, frame_index: int, cfg: AOConfig, raw=None):
    """Full AO pipeline (ray_traced_ao.cpp:98-112). Returns
    (outputs, new_state)."""
    if raw is None:
        with profiler.span("ray_trace"):
            raw = ray_trace(visibility_fn, gb_scaled, frame_index, cfg)

    if not cfg.denoise:
        ao = temporal_out = raw
        hist_len = state.history_length
    else:
        with profiler.span("temporal"):
            ao, hist_len = temporal_accumulation(raw, gb_scaled, prev_gb_scaled, state, cfg)
        temporal_out = ao
        with profiler.span("blur"):
            ao = stencil.bilateral_blur(ao, gb_scaled.normal, gb_scaled.linear_z,
                                        gb_scaled.mesh_id >= 0, radius=cfg.blur_radius)

    new_state = AOState(history=ao, history_length=hist_len)
    with profiler.span("upsample"):
        final = ao
        if cfg.scale != 0:
            final = filters.upsample_edge_aware(ao, gb_scaled.normal, gb_scaled.linear_z,
                                                gb_full.normal, gb_full.linear_z, int(cfg.scale))
        # pow() darkening at the final stage (ao_upsample.comp:108)
        final = torch.pow(torch.clamp(final, 0.0, 1.0), cfg.power)
    return AOOutputs(raw, temporal_out, ao, final), new_state
