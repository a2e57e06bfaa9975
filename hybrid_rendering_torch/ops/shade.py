"""Direct light on the card: kernel K7, csrc/shade.cu.

``ops/lighting.direct_lighting`` runs in two stages around its one
visibility query; on CUDA tensors each stage is one launch:

  - ``shade_rays`` (K7a): each point's shadow ray and attenuation and,
    with a sky sample, its cosine-lobe sky ray N rows after it;
  - ``shade_combine`` (K7b): both uber-BRDF terms, weighted by the
    visibilities, the light's radiance and the throughput.

The plain versions are ``lighting.shade_rays_plain`` and
``lighting.shade_combine_plain``; these wrappers take CUDA tensors only.
"""
from __future__ import annotations

import numpy as np
import torch

from hybrid_rendering_torch.ops import kernels
from hybrid_rendering_torch.ops.sky import ProceduralSky
from hybrid_rendering_torch.types import LIGHT_TYPE_DIRECTIONAL, LIGHT_TYPE_POINT, Light

SKY_NONE, SKY_PROCEDURAL, SKY_GIVEN = 0, 1, 2  # csrc/shade.cu


def _flat(t, N, c, name, dev, dtype=torch.float32):
    """`t` as a contiguous (N, c) operand ((N,) when c is 0); a contiguous
    tensor stays a view."""
    t = t.reshape((N, c) if c else (N,)).contiguous()
    kernels.require(t, name, dtype, device=dev)
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _light_vectors(light: Light, dev):
    for name in ("direction", "position", "color"):
        kernels.require(getattr(light, name), f"light.{name}", torch.float32, (3,), dev)


def procedural_sky(sky_radiance_fn):
    """The ProceduralSky whose own ``radiance`` `sky_radiance_fn` is, or
    None: K7b evaluates that sky itself, any other sky is called."""
    sky = getattr(sky_radiance_fn, "__self__", None)
    if isinstance(sky, ProceduralSky) and \
            getattr(sky_radiance_fn, "__func__", None) is ProceduralSky.radiance:
        return sky
    return None


def shade_rays(light: Light, p, n, rng_shadow=None, rng_sky=None, valid=None, bias=0.1):
    """K7a: points p, n (...,3); rng_shadow and rng_sky (...,2) or None;
    valid (...,) bool or None. Returns (origin (kN,3), direction (kN,3),
    t_max (kN,), att (N,)) with k = 2 when rng_sky is given: the shadow
    rays, then the sky rays. t_max is 0 where the point is not valid, and
    for the shadow ray where att is not > 0."""
    dev = p.device
    N = p.numel() // 3
    k = 1 if rng_sky is None else 2
    p, n = _flat(p, N, 3, "p", dev), _flat(n, N, 3, "n", dev)
    rs = None if rng_shadow is None else _flat(rng_shadow, N, 2, "rng_shadow", dev)
    rk = None if rng_sky is None else _flat(rng_sky, N, 2, "rng_sky", dev)
    vd = None if valid is None else _flat(valid, N, 0, "valid", dev, torch.bool)
    _light_vectors(light, dev)
    smooth_inv = 0.0
    if light.type not in (LIGHT_TYPE_DIRECTIONAL, LIGHT_TYPE_POINT):
        # math3d.smoothstep divides by a Python number: on the card, a
        # multiply by its float reciprocal
        width = max(light.cos_theta_inner - light.cos_theta_outer, 1e-8)
        smooth_inv = float(np.float32(1.0) / np.float32(width))
    origin = torch.empty((k * N, 3), dtype=torch.float32, device=dev)
    direction = torch.empty((k * N, 3), dtype=torch.float32, device=dev)
    t_max = torch.empty(k * N, dtype=torch.float32, device=dev)
    att = torch.empty(N, dtype=torch.float32, device=dev)

    with torch.cuda.device(dev):
        err = kernels.lib().hr_shade_rays(
            light.direction.data_ptr(), light.position.data_ptr(), int(light.type),
            light.radius, light.cos_theta_outer, smooth_inv, p.data_ptr(), n.data_ptr(),
            _ptr(rs), _ptr(rk), _ptr(vd), bias, N, origin.data_ptr(), direction.data_ptr(),
            t_max.data_ptr(), att.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "hr_shade_rays")
    shade_rays.launches += 1
    return origin, direction, t_max, att


def shade_combine(light: Light, wo, n, f0, diffuse_color, roughness, att, direction, vis=None,
                  throughput=None, sky=None, sky_li=None):
    """K7b: the direct light (N,3) of points wo, n, f0, diffuse_color
    (...,3), roughness (...,), from K7a's att (N,) and direction (kN,3)
    and the tracer's vis (kN,) (None: no visibility). With k = 2 the sky
    term is added: `sky` a ProceduralSky evaluated in the kernel, or
    `sky_li` (N,3) the radiance of the sky directions."""
    dev = n.device
    N = att.shape[0]
    k = direction.shape[0] // max(N, 1)
    wo, n, f0, cd = (_flat(t, N, 3, name, dev) for t, name in
                     ((wo, "wo"), (n, "n"), (f0, "f0"), (diffuse_color, "diffuse_color")))
    rough = _flat(roughness, N, 0, "roughness", dev)
    tp = None if throughput is None else _flat(throughput, N, 3, "throughput", dev)
    kernels.require(att, "att", torch.float32, (N,), dev)
    kernels.require(direction, "direction", torch.float32, (k * N, 3), dev)
    if vis is not None:
        vis = _flat(vis.to(torch.float32), k * N, 0, "vis", dev)
    _light_vectors(light, dev)
    if k == 1:
        mode, sky_ptr, sun_intensity = SKY_NONE, None, 0.0
    elif sky is not None:
        kernels.require(sky.sun_direction, "sky.sun_direction", torch.float32, (3,), dev)
        mode, sky_ptr, sun_intensity = SKY_PROCEDURAL, sky.sun_direction.data_ptr(), \
            sky.sun_intensity
    else:
        sky_li = _flat(sky_li, N, 3, "sky_li", dev)
        mode, sky_ptr, sun_intensity = SKY_GIVEN, sky_li.data_ptr(), 0.0
    out = torch.empty((N, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = kernels.lib().hr_shade_combine(
            light.color.data_ptr(), light.intensity, wo.data_ptr(), n.data_ptr(), f0.data_ptr(),
            cd.data_ptr(), rough.data_ptr(), _ptr(tp), att.data_ptr(), direction.data_ptr(),
            _ptr(vis), mode, sky_ptr, sun_intensity, N, out.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "hr_shade_combine")
    shade_combine.launches += 1
    return out


shade_rays.launches = 0
shade_combine.launches = 0
