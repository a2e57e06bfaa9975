"""Blue-noise sampler for ray-gen decorrelation — port of
``hybrid_rendering_tpu/ops/bluenoise.py``, both of its grid modes:

  "bn_r2"    the committed void-and-cluster rank mask tiled over the
             screen, rotated per frame by the R2 sequence
             (Cranley-Patterson). The rotation is computed on the host in
             float32, as the JAX package computes it on the device.
  "sobol_bn" the Sobol (0,2) sequence in frame order, digitally
             XOR-scrambled per pixel with the mask's bits and index-ranked
             per pixel. uint32 arithmetic runs in int64 tensors masked with
             ``& 0xFFFFFFFF``, as ops/rng.py does, so the grid is
             bit-identical to the JAX package's.

The mode comes from ``HR_SAMPLER`` as the JAX package reads it (at import;
any value other than "sobol_bn" means "bn_r2"), or from ``mode=``. The
mask and the per-dimension scramble tables are built once on the host and
uploaded once per device. The JAX package's white-noise fallback for a
missing mask is deliberately absent: the port raises instead.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from hrref.ops import rng as rng_ops

# the port's own copy of the mask (byte-identical to the JAX package's)
_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "blue_noise_128.npy")

_PLASTIC = (0.7548776662466927, 0.5698402909980532)  # R2 sequence
_M32 = rng_ops.M32

MODES = ("bn_r2", "sobol_bn")
SAMPLER = "sobol_bn" if os.environ.get("HR_SAMPLER", "bn_r2") == "sobol_bn" else "bn_r2"


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


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    """Bit reversal of uint32 lanes held in int64."""
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _M32


def _sobol_dir2() -> np.ndarray:
    """Direction numbers of the classic second Sobol dimension (primitive
    polynomial x+1: v_j = v_{j-1} ^ (v_{j-1} >> 1)); with the bit-reversed
    index (dim 1) this forms a (0,2)-sequence."""
    v = np.zeros(32, np.uint32)
    v[0] = 1 << 31
    for j in range(1, 32):
        v[j] = v[j - 1] ^ (v[j - 1] >> 1)
    return v


_DIR2 = tuple(int(v) for v in _sobol_dir2())


def _sobol2(idx: torch.Tensor):
    """2-D Sobol point of the uint32 indices `idx` (int64 lanes) ->
    (x, y), uint32 lanes in int64."""
    y = torch.zeros_like(idx)
    for j in range(32):
        y = y ^ (((idx >> j) & 1) * _DIR2[j])
    return _reverse_bits32(idx), y


def _scramble_tables(mask: np.ndarray, dim: int):
    """Per-pixel digital-scramble and ranking words of one dimension pair,
    from the mask's bits (numpy uint32, (N, N) each): (sx, sy, rank)."""
    bits_x = (mask[..., 0] * 4294967296.0).astype(np.uint64).astype(np.uint32)
    bits_y = (mask[..., 1] * 4294967296.0).astype(np.uint64).astype(np.uint32)
    # decorrelate uses (shadow disk / AO cone / GGX) per dimension pair
    dk = np.uint32(0x9E3779B9 * (2 * dim + 1) & 0xFFFFFFFF)
    sx = bits_x ^ dk
    sy = bits_y ^ np.uint32((int(dk) * 3) & 0xFFFFFFFF)
    # ranking permutes when each pixel consumes each sequence element;
    # XOR-ranking in the low bits keeps power-of-2 stratification
    rank = ((bits_x >> np.uint32(9)) ^ (bits_y >> np.uint32(17))) & np.uint32(0xFF)
    return sx, sy, rank


@functools.lru_cache(maxsize=None)
def _on_device(kind: str, dim: int, device: str) -> torch.Tensor:
    """The mask ("mask": (N, N, 2) float32) or the scramble tables of `dim`
    ("sobol": (3, N, N) int64 sx, sy, rank) on `device`, built on the host
    and uploaded once per device."""
    if kind == "mask":
        return torch.as_tensor(get_mask(), device=device)
    return torch.as_tensor(np.stack(_scramble_tables(get_mask(), dim)).astype(np.int64),
                           device=device)


def _device_name(device) -> str:
    return str(torch.device("cpu" if device is None else device))


def _tile(plane: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Tile an (N, N, ...) plane over (height, width)."""
    n = plane.shape[0]
    reps = (-(-height // n), -(-width // n)) + (1,) * (plane.dim() - 2)
    return plane.repeat(reps)[:height, :width]


def _sample2d_grid_sobol(height: int, width: int, frame_index: int, dim: int, device=None):
    tables = _on_device("sobol", dim, _device_name(device))
    sx, sy, rank = (_tile(t, height, width) for t in tables.unbind(0))
    idx = (int(frame_index) & _M32) ^ rank
    x, y = _sobol2(idx)
    return rng_ops.uint_to_unit_float(x ^ sx), rng_ops.uint_to_unit_float(y ^ sy)


def sample2d_grid(height: int, width: int, frame_index: int, dim: int = 0,
                  device=None, mode=None):
    """Per-pixel 2D sample in [0,1) over the full pixel grid; dim
    decorrelates uses within one frame. `mode` is "bn_r2" or "sobol_bn"
    (default: ``SAMPLER``, from ``HR_SAMPLER``). Returns (u, v), each
    (H, W) float32."""
    mode = SAMPLER if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"sample2d_grid: mode must be one of {MODES}, got {mode!r}")
    if mode == "sobol_bn":
        return _sample2d_grid_sobol(height, width, frame_index, dim, device)
    tiled = _tile(_on_device("mask", 0, _device_name(device)), height, width)
    rot_x, rot_y = _rotation(frame_index, dim)
    u = torch.remainder(tiled[..., 0] + rot_x, 1.0)
    v = torch.remainder(tiled[..., 1] + rot_y, 1.0)
    return u, v
