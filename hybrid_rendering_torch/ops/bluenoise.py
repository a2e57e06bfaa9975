"""Blue-noise sampler for ray-gen decorrelation — the ``bn_r2`` mode of
``hybrid_rendering_tpu/ops/bluenoise.py``: the committed void-and-cluster
rank mask tiled over the screen, rotated per frame by the R2 sequence
(Cranley-Patterson). Float arithmetic only; the per-frame rotation is
computed on the host in float32, as the JAX package computes it on the
device."""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

# the port's own copy of the mask (byte-identical to the JAX package's)
_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "blue_noise_128.npy")

_PLASTIC = (0.7548776662466927, 0.5698402909980532)  # R2 sequence


@functools.lru_cache(maxsize=1)
def get_mask() -> np.ndarray:
    """The (128, 128, 2) float32 rank mask. Raises if it is missing: the
    port has no white-noise fallback."""
    if not os.path.exists(_DATA):
        raise FileNotFoundError(f"blue-noise mask missing: {_DATA}")
    return np.load(_DATA)


def _rotation(frame_index: int, dim: int):
    f32 = np.float32
    base = f32(frame_index) + f32(dim) * f32(0.38196601)
    return float(base * f32(_PLASTIC[0])), float(base * f32(_PLASTIC[1]))


def sample2d_grid(height: int, width: int, frame_index: int, dim: int = 0,
                  device=None):
    """Per-pixel 2D sample in [0,1) over the full pixel grid; dim
    decorrelates uses within one frame. Returns (u, v), each (H, W)."""
    mask = get_mask()
    n = mask.shape[0]
    reps_y, reps_x = -(-height // n), -(-width // n)
    tiled = torch.as_tensor(mask, device=device).repeat(reps_y, reps_x, 1)
    tiled = tiled[:height, :width]
    rot_x, rot_y = _rotation(frame_index, dim)
    u = torch.remainder(tiled[..., 0] + rot_x, 1.0)
    v = torch.remainder(tiled[..., 1] + rot_y, 1.0)
    return u, v
