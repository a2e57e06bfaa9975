"""Tone mapping — exposure x ACES film x gamma (reference tone_map.frag),
as ``hybrid_rendering_tpu/models/tonemap.py``."""
from __future__ import annotations

import torch

from hrref.config import ToneMapConfig


def aces_film(x):
    """ACES filmic fit (Narkowicz)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tonemap(hdr, cfg: ToneMapConfig = ToneMapConfig()):
    """(H,W,3) HDR -> (H,W,3) display [0,1]."""
    x = hdr * cfg.exposure
    x = aces_film(x) if cfg.aces else torch.clamp(x, 0.0, 1.0)
    return torch.pow(torch.clamp(x, min=0.0), 1.0 / cfg.gamma)
