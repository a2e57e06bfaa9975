"""Octahedral unit-vector codec (DDGI probe-atlas addressing,
reference gi_common.glsl:143-184), as ``hybrid_rendering_tpu/ops/
octahedral.py``."""
from __future__ import annotations

import torch

from hrref.ops.math3d import normalize


def _sign_not_zero(v):
    return torch.where(v >= 0.0, 1.0, -1.0)


def direction_to_octahedral(n):
    """(..., 3) unit vectors -> (..., 2) in [-1, 1]. The |x|+|y|+|z| sum
    runs left to right, as the DDGI sampler kernel sums it."""
    a = torch.abs(n)
    denom = a[..., 0] + a[..., 1] + a[..., 2]
    p = n[..., :2] / torch.clamp(denom, min=1e-8)[..., None]
    fold = (1.0 - torch.abs(p.flip(-1))) * _sign_not_zero(p)
    return torch.where(n[..., 2:3] < 0.0, fold, p)


def octahedral_to_direction(e):
    """(..., 2) in [-1,1] -> (..., 3) unit vectors (common.glsl:150-156)."""
    z = 1.0 - torch.abs(e[..., 0]) - torch.abs(e[..., 1])
    fold = (1.0 - torch.abs(e.flip(-1))) * _sign_not_zero(e)
    xy = torch.where(z[..., None] < 0.0, fold, e)
    return normalize(torch.cat([xy, z[..., None]], dim=-1))
