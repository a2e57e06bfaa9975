"""Image warping for temporal reprojection, as gathers.

``hybrid_rendering_tpu/ops/warp.py`` avoids TPU gathers with a separable
static-window select: a row pass then a column pass over offsets in
[-MAX_RESIDUAL, MAX_RESIDUAL]. A GPU gathers cheaply, so each pass here is
one clamped gather per tap, with the same values:

  row pass:     v[y,x]   = (1-fy) * img[y+ky, x] + fy * img[y+ky+1, x]
  column pass:  out[y,x] = (1-fx) * v[y, x+kx]  + fx * v[y, x+kx+1]

where (ky, fy) / (kx, fx) are the integer and fractional displacement at
the destination pixel, each tap contributes only if its offset lies in the
window, and indices clamp to the frame. The ±6 px window invalidation is
kept: a pixel displaced further is reported invalid and its history is
reset, on every backend, as the reference reprojection does (without it
the temporal history diverges under camera motion).
"""
from __future__ import annotations

from typing import Tuple

import torch

from hrref.utils.camera import pixel_grid

MAX_RESIDUAL = 6  # +-6 pixel window


def _gather_rows(img, rows):
    """img (H,W,C), rows (H,W) int64 -> img[rows[y,x], x]."""
    W = img.shape[1]
    cols = torch.arange(W, device=img.device).expand_as(rows)
    return img[rows, cols]


def _gather_cols(img, cols):
    H = img.shape[0]
    rows = torch.arange(H, device=img.device)[:, None].expand_as(cols)
    return img[rows, cols]


def _axis_warp(img, k, f, m, axis):
    """1-D warp along `axis`: (1-f)*img[p+k] + f*img[p+k+1], each tap only
    where its offset is in [-m, m]. img (H,W,C); k (H,W) int; f (H,W)."""
    n = img.shape[axis]
    gather = _gather_rows if axis == 0 else _gather_cols
    pos = torch.arange(n, device=img.device)
    pos = pos[:, None] if axis == 0 else pos[None, :]
    w0 = torch.where((k >= -m) & (k <= m), 1.0 - f, 0.0)
    w1 = torch.where((k >= -m - 1) & (k <= m - 1), f, 0.0)
    i0 = torch.clamp(pos + k, 0, n - 1)
    i1 = torch.clamp(pos + k + 1, 0, n - 1)
    return gather(img, i0) * w0[..., None] + gather(img, i1) * w1[..., None]


def warp_bilinear(planes, hx, hy, max_residual: int = MAX_RESIDUAL
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Separable bilinear warp of (H,W,C) planes to source pixel coords
    (hx, hy). Returns (warped (H,W,C), in_window (H,W) bool); values at
    out-of-window or out-of-frame pixels are undefined."""
    H, W = hy.shape
    yy, xx = pixel_grid(H, W, hy.device)
    fx = hx - torch.floor(hx)
    fy = hy - torch.floor(hy)
    kx = (torch.floor(hx) - xx).to(torch.int64)
    ky = (torch.floor(hy) - yy).to(torch.int64)
    m = max_residual
    ok = ((kx >= -m) & (kx <= m - 1) & (ky >= -m) & (ky <= m - 1)
          & (hx >= 0.0) & (hx <= W - 1.0) & (hy >= 0.0) & (hy <= H - 1.0))
    v = _axis_warp(planes, ky, fy, m, axis=0)
    v = _axis_warp(v, kx, fx, m, axis=1)
    return v, ok


def warp_nearest(planes, hx, hy, max_residual: int = MAX_RESIDUAL
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-tap warp (id planes that must not interpolate): rows then
    columns, each offset taken only inside the window."""
    H, W = hy.shape
    yy, xx = pixel_grid(H, W, hy.device)
    rx = torch.round(hx)
    ry = torch.round(hy)
    kx = (rx - xx).to(torch.int64)
    ky = (ry - yy).to(torch.int64)
    m = max_residual
    ok = ((kx >= -m) & (kx <= m) & (ky >= -m) & (ky <= m)
          & (rx >= 0) & (rx <= W - 1) & (ry >= 0) & (ry <= H - 1))
    ys = torch.arange(H, device=hy.device)[:, None]
    xs = torch.arange(W, device=hy.device)[None, :]
    v = _gather_rows(planes, torch.clamp(ys + ky, 0, H - 1))
    v = torch.where(((ky >= -m) & (ky <= m))[..., None], v, 0.0)
    out = _gather_cols(v, torch.clamp(xs + kx, 0, W - 1))
    return torch.where(((kx >= -m) & (kx <= m))[..., None], out, 0.0), ok
