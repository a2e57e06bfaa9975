"""Counter-free vectorized RNG — xoroshiro64* + Wang hash, as
``hybrid_rendering_tpu/ops/rng.py`` (reference src/shaders/random.glsl).

PyTorch has no full uint32 arithmetic, so every lane is an int64 tensor
holding a uint32 value, masked with ``& 0xFFFFFFFF`` after each multiply,
add and shift. Multiplies by a 32-bit constant are split into 16-bit
halves so no intermediate leaves int64's range. The streams are
bit-identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses

import torch

M32 = 0xFFFFFFFF


@dataclasses.dataclass
class RNG:
    """xoroshiro64* state: two uint32 lanes (as int64) of identical shape."""

    s0: torch.Tensor
    s1: torch.Tensor


def as_u32(x, device=None) -> torch.Tensor:
    """Any integer tensor, array or Python int -> int64 tensor of uint32
    values (negative int32 inputs wrap as a uint32 cast does)."""
    return torch.as_tensor(x, device=device).to(torch.int64) & M32


def _mul(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for uint32 lanes a and a uint32 constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def _rotl(x: torch.Tensor, k: int) -> torch.Tensor:
    return ((x << k) & M32) | (x >> (32 - k))


def wang_hash(seed) -> torch.Tensor:
    """Thomas Wang 32-bit hash (reference random.glsl:30-39)."""
    seed = as_u32(seed)
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = _mul(seed, 9)
    seed = seed ^ (seed >> 4)
    seed = _mul(seed, 0x27D4EB2D)
    return seed ^ (seed >> 15)


def rng_init(pixel_id_x, pixel_id_y, frame_index) -> RNG:
    """Seed per-pixel streams, the frame hash mixed into both lanes
    (the JAX package's rng_init)."""
    x = as_u32(pixel_id_x)
    y = as_u32(pixel_id_y, x.device)
    if isinstance(frame_index, int):  # filled on the device: no host copy
        f = torch.full_like(x, frame_index & M32)
    else:
        f = as_u32(frame_index, x.device).expand(x.shape)
    pix = wang_hash(((x << 16) & M32) | y)
    fh = wang_hash((f + 0x9E3779B9) & M32)
    s0 = wang_hash(pix ^ fh)
    s1 = wang_hash((pix + _mul(fh, 0x85EBCA6B)) & M32)
    rng, _ = next_uint(RNG(s0=s0, s1=s1))
    return rng


def next_uint(rng: RNG):
    """One xoroshiro64* step (reference random.glsl:16-27).
    Returns (new_state, uint32 sample)."""
    result = _mul(rng.s0, 0x9E3779BB)
    s1 = rng.s1 ^ rng.s0
    s0 = _rotl(rng.s0, 26) ^ s1 ^ ((s1 << 9) & M32)
    s1 = _rotl(s1, 13)
    return RNG(s0=s0, s1=s1), result


def uint_to_unit_float(u) -> torch.Tensor:
    """Mantissa fill: bitcast(0x3F800000 | u >> 9) - 1, in [0, 1)."""
    bits = 0x3F800000 | (as_u32(u) >> 9)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def next_float(rng: RNG):
    """Uniform in [0,1) (reference random.glsl:55-59)."""
    rng, u = next_uint(rng)
    return rng, uint_to_unit_float(u)


def next_vec2(rng: RNG):
    rng, a = next_float(rng)
    rng, b = next_float(rng)
    return rng, torch.stack([a, b], dim=-1)


def next_vec3(rng: RNG):
    rng, a = next_float(rng)
    rng, b = next_float(rng)
    rng, c = next_float(rng)
    return rng, torch.stack([a, b, c], dim=-1)
