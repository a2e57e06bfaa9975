"""Temporal anti-aliasing (Playdead-style resolve; reference
src/temporal_aa.{h,cpp} + taa.comp), as ``hybrid_rendering_tpu/models/
taa.py``: Halton(2,3) jitter, 3x3 closest-depth velocity dilation, rounded
3x3 neighbourhood clip, luminance-weighted feedback, Reinhard-space blend
and an optional sharpen."""
from __future__ import annotations

import dataclasses

import torch

from hrref.config import TAAConfig
from hrref.ops import filters, warp as warp_ops
from hrref.ops.math3d import luminance
from hrref.types import GBuffer
from hrref.utils.camera import pixel_grid

HALTON_16 = tuple(
    (
        sum(((i // (2**j)) % 2) / (2 ** (j + 1)) for j in range(16)),
        sum(((i // (3**j)) % 3) / (3 ** (j + 1)) for j in range(16)),
    )
    for i in range(1, 17)
)


def halton_jitter(frame_index: int, width: int, height: int):
    """Subpixel jitter in NDC units for the projection matrix
    (temporal_aa.cpp:54-81)."""
    hx, hy = HALTON_16[frame_index % 16]
    return ((hx - 0.5) * 2.0 / width, (hy - 0.5) * 2.0 / height)


@dataclasses.dataclass
class TAAState:
    history: torch.Tensor  # (H,W,3)
    initialized: bool

    @staticmethod
    def create(height: int, width: int, device=None):
        return TAAState(history=torch.zeros((height, width, 3), device=device),
                        initialized=False)


def _clip_aabb(aabb_min, aabb_max, history):
    """Clip history toward the neighbourhood AABB center (taa.comp:120-153)."""
    center = 0.5 * (aabb_max + aabb_min)
    extent = 0.5 * (aabb_max - aabb_min) + 1e-5
    vc = history - center
    ma = torch.abs(vc / extent).amax(dim=-1, keepdim=True)
    return torch.where(ma > 1.0, center + vc / ma, history)


def taa_resolve(color, gb: GBuffer, state: TAAState, cfg: TAAConfig):
    """One TAA resolve of the (H,W,3) HDR frame. Returns (output, state)."""
    H, W = gb.depth.shape

    # 3x3 closest-depth velocity dilation (taa.comp:157-188)
    best_depth = gb.depth
    best_motion = gb.motion
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nd = filters.shift2d(gb.depth, dy, dx)
            closer = nd < best_depth
            best_depth = torch.where(closer, nd, best_depth)
            best_motion = torch.where(closer[..., None], filters.shift2d(gb.motion, dy, dx),
                                      best_motion)

    # history fetch at uv + motion; beyond the warp window -> current color
    yy, xx = pixel_grid(H, W, color.device)
    history, hist_ok = warp_ops.warp_bilinear(state.history, xx + best_motion[..., 0] * W,
                                              yy + best_motion[..., 1] * H)
    history = torch.where(hist_ok[..., None], history, color)

    if cfg.motion_blur:
        # sample_color_motion (taa.comp:218-236): box-average the current
        # color along +-taps of half the screen-space velocity, start
        # offset jittered by the sin-hash noise (noise.glsl srand), in
        # float32 as the reference computes it
        taps = int(cfg.motion_blur_taps)
        s = torch.sin((xx + 0.5) / W * 12.9898 + (yy + 0.5) / H * 78.233) * 43758.5453
        srand = (s - torch.floor(s)) * 2.0 - 1.0  # fract -> [-1,1)
        # velocity points prev - curr: blur along -motion (pixel units)
        vx = -best_motion[..., 0] * W * 0.5 / taps
        vy = -best_motion[..., 1] * H * 0.5 / taps
        acc = torch.zeros_like(color)
        for i in range(-taps, taps + 1):
            o = i + 0.5 * srand
            tap, ok = warp_ops.warp_bilinear(color, xx + vx * o, yy + vy * o)
            acc = acc + torch.where(ok[..., None], tap, color)
        color = acc / (2 * taps + 1)

    # rounded 3x3 neighbourhood min/max (box + cross blended)
    box_min = box_max = cross_min = cross_max = color
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = filters.shift2d(color, dy, dx)
            box_min = torch.minimum(box_min, s)
            box_max = torch.maximum(box_max, s)
            if dx == 0 or dy == 0:
                cross_min = torch.minimum(cross_min, s)
                cross_max = torch.maximum(cross_max, s)
    history = _clip_aabb(0.5 * (box_min + cross_min), 0.5 * (box_max + cross_max), history)

    # luminance-weighted feedback (taa.comp:341-352)
    lum0 = luminance(color)
    lum1 = luminance(history)
    unbiased_diff = torch.abs(lum0 - lum1) / torch.maximum(lum0, torch.clamp(lum1, min=0.2))
    unbiased_weight = 1.0 - unbiased_diff
    feedback = (cfg.feedback_min + (cfg.feedback_max - cfg.feedback_min)
                * unbiased_weight * unbiased_weight)[..., None]

    # Reinhard-space blend (HDR correction, taa.comp:368-378)
    def tm(x):
        return x / (1.0 + luminance(x))[..., None]

    def tm_inv(x):
        return x / torch.clamp(1.0 - luminance(x), min=1e-4)[..., None]

    # first frame: no history
    out = (tm_inv(tm(color) * (1.0 - feedback) + tm(history) * feedback)
           if state.initialized else color)

    if cfg.sharpen:
        blur = (out + filters.shift2d(out, 0, 1) + filters.shift2d(out, 0, -1)
                + filters.shift2d(out, 1, 0) + filters.shift2d(out, -1, 0)) / 5.0
        out = torch.clamp(out + (out - blur) * 0.5, min=0.0)

    return out, TAAState(history=out, initialized=True)
