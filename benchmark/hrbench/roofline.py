"""Peaks of the card and the least time each kernel's work could take.

The counts are those of the work, whatever implements it, from the calls'
own inputs: each input byte read once and each output byte written once,
and for the stencils and the sampler the operations their arithmetic
needs. The tracers' bound does not count any tree walk: a better tree or
walk then lowers the time and leaves the bound."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

RAY_BYTES = 32  # float32 origin, direction, t_min, t_max
TRI_BYTES = 36  # three float32 vertices
CLOSEST_OUT_BYTES = 112  # t, u, v, triangle id and the 24-float attribute row
VISIBILITY_OUT_BYTES = 4  # one float a ray

K3_TAP_OPS = {1: 27, 3: 37}  # normal/depth/luma weights + accumulation
K3_PIXEL_OPS = 20  # variance blur, phi, final divisions
K4_TAP_OPS = 18
K5_POINT_OPS = 1560  # 8 cage corners x ~189 + cell and bias set-up


def bound_s(nbytes: float, ops: float) -> float:
    """Seconds the card needs at least to move `nbytes` and do `ops` fp32
    operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def trace_bound(kind: str, rays: int, triangles: int) -> float:
    """A closest-hit ("closest") or visibility ("visibility") call on
    `rays` rays against `triangles` triangles."""
    out = CLOSEST_OUT_BYTES if kind == "closest" else VISIBILITY_OUT_BYTES
    return bound_s(rays * (RAY_BYTES + out) + triangles * TRI_BYTES, 0)


def atrous_bound(channels: int, pixels: int, masked: int, iterations: int,
                 radius: int) -> float:
    """The à-trous chain: colour, variance, normal, depth and the mask in,
    the final and feedback colours and the variance out; every
    iteration's (2r+1)^2 taps on the pixels of the mask."""
    taps = (2 * radius + 1) ** 2
    ops = iterations * masked * (taps * K3_TAP_OPS[channels] + K3_PIXEL_OPS)
    return bound_s(pixels * (4 * channels + 21) + pixels * (8 * channels + 4), ops)


def blur_bound(pixels: int, masked: int, radius: int) -> float:
    """The bilateral blur: image, normal, depth and mask in, the image out;
    the vertical pass on every pixel, the horizontal one on the mask."""
    ops = (pixels + masked) * ((2 * radius + 1) * K4_TAP_OPS + 2)
    return bound_s(pixels * 21 + pixels * 4, ops)


def sampler_bound(points: int, atlas_floats: int) -> float:
    """The DDGI sampler: p, n, wo in and the irradiance out a point, both
    atlases read once; the 8-corner cage of every point."""
    return bound_s(points * 48 + 4 * atlas_floats, points * K5_POINT_OPS)
