"""Dense stencil filters of the denoiser stack, in plain PyTorch — a port
of ``hybrid_rendering_tpu/ops/filters.py``. ``atrous_iteration`` and
``bilateral_blur_separable`` are the plain versions of kernels K3 and K4
(ops/stencil.py); the kernels are checked against them.

Every tap is an edge-clamped shift (texelFetch with clamped coordinates).
"""
from __future__ import annotations

import numpy as np
import torch

from hrref.ops.math3d import dot3, luminance

_ATROUS_KERNEL = (1.0, 2.0 / 3.0, 1.0 / 6.0)  # 3-tap B-spline per axis


def shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift an (H, W, ...) image by (dy, dx) with edge clamping: the value
    at (y, x) of the result is img[y - dy, x - dx], clamped to the frame."""
    if dy == 0 and dx == 0:
        return img
    h, w = img.shape[:2]
    ys = torch.clamp(torch.arange(h, device=img.device) - dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) - dx, 0, w - 1)
    return img[ys][:, xs]


def box_filter_sum(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 box sum by separable shift-adds, rows then columns."""

    def axis_sum(x, axis):
        total = x
        for o in range(1, radius + 1):
            if axis == 0:
                total = total + shift2d(x, o, 0) + shift2d(x, -o, 0)
            else:
                total = total + shift2d(x, 0, o) + shift2d(x, 0, -o)
        return total

    return axis_sum(axis_sum(img, 0), 1)


# ---------------------------------------------------------------------------
# Edge-stopping weights (reference src/shaders/edge_stopping.glsl)
# ---------------------------------------------------------------------------


def normal_weight(center_n, sample_n, power):
    return torch.pow(torch.clamp(dot3(center_n, sample_n), 0.0, 1.0), power)


def depth_weight(center_z, sample_z, phi):
    return torch.exp(-torch.abs(center_z - sample_z) / phi)


def luma_weight(center_l, sample_l, phi):
    return torch.exp(-torch.abs(center_l - sample_l) / torch.clamp(phi, min=1e-6))


def depth_phi(sigma_depth: float, step: int) -> float:
    """max(sigma * |step| + 1e-4, 1e-6), rounded to float32 as the JAX
    package's weak-typed scalar is."""
    return float(np.float32(max(sigma_depth * abs(step) + 1e-4, 1e-6)))


# ---------------------------------------------------------------------------
# À-trous wavelet filter (SVGF), plain version of K3
# ---------------------------------------------------------------------------


def atrous_iteration(color, variance, normal, depth, step: int, radius: int = 1,
                     phi_color: float = 10.0, phi_normal: float = 32.0,
                     sigma_depth: float = 1.0, mask=None):
    """One edge-aware à-trous iteration with variance-driven luma weight
    (shadows_denoise_atrous.comp:104-167). color (H,W) or (H,W,3).
    Returns (color, variance)."""
    single = color.ndim == 2
    cimg = color[..., None] if single else color
    center_l = color if single else luminance(cimg)

    var_blur = box_filter_sum(variance, 1) / 9.0
    phi_l = phi_color * torch.sqrt(torch.clamp(var_blur, min=1e-10))
    phi_z = depth_phi(sigma_depth, step)

    sum_c = torch.zeros_like(cimg)
    sum_v = torch.zeros_like(variance)
    sum_w = torch.zeros_like(variance)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            k = _ATROUS_KERNEL[abs(dy)] * _ATROUS_KERNEL[abs(dx)]
            sc = shift2d(cimg, dy * step, dx * step)
            sv = shift2d(variance, dy * step, dx * step)
            sn = shift2d(normal, dy * step, dx * step)
            sz = shift2d(depth, dy * step, dx * step)
            sl = sc[..., 0] if single else luminance(sc)
            w = (normal_weight(normal, sn, phi_normal)
                 * depth_weight(depth, sz, phi_z)
                 * luma_weight(center_l, sl, phi_l) * k)
            sum_c = sum_c + sc * w[..., None]
            sum_v = sum_v + sv * w * w
            sum_w = sum_w + w
    out_c = sum_c / torch.clamp(sum_w, min=1e-8)[..., None]
    out_v = sum_v / torch.clamp(sum_w * sum_w, min=1e-8)
    if mask is not None:
        out_c = torch.where(mask[..., None], out_c, cimg)
        out_v = torch.where(mask, out_v, variance)
    return (out_c[..., 0] if single else out_c), out_v


# ---------------------------------------------------------------------------
# Separable bilateral Gaussian blur, plain version of K4
# ---------------------------------------------------------------------------


def gauss_taps(radius: int):
    """Gaussian taps exp(-o^2 / (2 sigma^2)), sigma = radius/1.5, each
    evaluated in float32 (ao_denoise_bilateral_blur.comp:75-110)."""
    sigma = radius / 1.5
    args = torch.tensor([-(o * o) / (2.0 * sigma * sigma)
                         for o in range(-radius, radius + 1)], dtype=torch.float32)
    return [float(g) for g in torch.exp(args)]


def bilateral_blur_separable(img, normal, depth, radius: int = 4,
                             depth_phi: float = 1.0, normal_power: float = 32.0,
                             mask=None):
    """Vertical then horizontal bilateral Gaussian with depth/normal edge
    stops; masked pixels keep their input."""
    gauss = gauss_taps(radius)
    phi = max(depth_phi, 1e-6)

    def one_axis(x, axis):
        sum_c = torch.zeros_like(x)
        sum_w = torch.zeros_like(x)
        for i, o in enumerate(range(-radius, radius + 1)):
            dy, dx = (o, 0) if axis == 0 else (0, o)
            w = (gauss[i] * normal_weight(normal, shift2d(normal, dy, dx), normal_power)
                 * depth_weight(depth, shift2d(depth, dy, dx), phi))
            sum_c = sum_c + shift2d(x, dy, dx) * w
            sum_w = sum_w + w
        return sum_c / torch.clamp(sum_w, min=1e-8)

    out = one_axis(one_axis(img, 0), 1)
    if mask is not None:
        out = torch.where(mask, out, img)
    return out


# ---------------------------------------------------------------------------
# Edge-aware upsample (reference *_upsample.comp, 4-tap joint bilateral)
# ---------------------------------------------------------------------------


def upsample_edge_aware(low, low_normal, low_depth, hi_normal, hi_depth, scale: int):
    """Joint bilateral upsample from 1/2**scale res to full res
    (shadows_upsample.comp:62-108): the 4 nearest low-res taps weighted by
    bilinear x depth x normal agreement with the full-res pixel."""
    s = 1 << scale
    H, W = hi_depth.shape
    single = low.ndim == 2
    low_c = low[..., None] if single else low
    half = s // 2

    def tap_img(x, dy, dx):
        up = x.repeat_interleave(s, dim=0).repeat_interleave(s, dim=1)
        return shift2d(up, half - dy * s, half - dx * s)[:H, :W]

    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=hi_depth.device),
        torch.arange(W, dtype=torch.float32, device=hi_depth.device),
        indexing="ij")
    fx = torch.remainder((xx + 0.5) / s - 0.5, 1.0)
    fy = torch.remainder((yy + 0.5) / s - 0.5, 1.0)

    sum_c = torch.zeros((H, W, low_c.shape[-1]), dtype=low_c.dtype, device=low_c.device)
    sum_w = torch.zeros_like(hi_depth)
    for dy in range(2):
        for dx in range(2):
            wbil = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            w = (wbil * normal_weight(hi_normal, tap_img(low_normal, dy, dx), 32.0)
                 * depth_weight(hi_depth, tap_img(low_depth, dy, dx), 1.0) + 1e-6)
            sum_c = sum_c + tap_img(low_c, dy, dx) * w[..., None]
            sum_w = sum_w + w
    out = sum_c / sum_w[..., None]
    return out[..., 0] if single else out

