"""Punctual-light sampling and direct lighting (reference
src/shaders/lighting.glsl), as in ``hybrid_rendering_tpu/ops/
lighting.py``. The light type is a host integer, so only the branch of
the active type is computed."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from hrref.ops import brdf as brdf_ops
from hrref.ops.math3d import cross, dot, normalize, smoothstep
from hrref.types import (
    LIGHT_TYPE_DIRECTIONAL,
    LIGHT_TYPE_POINT,
    Light,
)

M_PI = math.pi


def _disk_perturb(light_dir, radius, rng2):
    """Perturb a light direction within a disk of angular `radius`
    (lighting.glsl:41-47 and the point/spot variants)."""
    up = light_dir.new_tensor([0.0, 1.0, 0.0]).expand(light_dir.shape)
    tangent = normalize(cross(light_dir, up))
    bitangent = normalize(cross(tangent, light_dir))
    point_radius = radius * torch.sqrt(rng2[..., 0])
    point_angle = rng2[..., 1] * 2.0 * M_PI
    dx = point_radius * torch.cos(point_angle)
    dy = point_radius * torch.sin(point_angle)
    return normalize(light_dir + dx[..., None] * tangent + dy[..., None] * bitangent)


def fetch_light_properties(light: Light, p, n, rng2=None, soft_shadows=True):
    """Returns (Li, Wi, t_max, attenuation) for surface points p (...,3)
    with normals n (lighting.glsl fetch_light_properties). attenuation
    includes the clamped N.Wi factor (lighting.glsl:107)."""
    li = light.color * light.intensity  # (3,)
    shape = p.shape[:-1]
    soft = soft_shadows and rng2 is not None

    if light.type == LIGHT_TYPE_DIRECTIONAL:
        wi = light.direction.expand(p.shape)
        if soft:
            wi = _disk_perturb(wi, light.radius, rng2)
        t_max = torch.full(shape, 1e4, dtype=p.dtype, device=p.device)
        att = torch.ones(shape, dtype=p.dtype, device=p.device)
    else:
        to_light = light.position - p
        light_distance = torch.sqrt(torch.clamp(dot(to_light, to_light), min=1e-12))
        pl_dir = to_light / light_distance[..., None]
        if soft:
            # angular radius shrinks with distance (lighting.glsl:69-76)
            wi = _disk_perturb(pl_dir, light.radius / light_distance, rng2)
        else:
            wi = pl_dir
        t_max = light_distance
        att = 1.0 / torch.clamp(light_distance * light_distance, min=1e-8)
        if light.type != LIGHT_TYPE_POINT:
            # spot cone falloff (lighting.glsl:105-107): direction is the
            # beam axis (light -> scene)
            att = smoothstep(light.cos_theta_outer, light.cos_theta_inner,
                             -dot(wi, light.direction)) * att
    att = att * torch.clamp(dot(n, wi), 0.0, 1.0)
    return li, wi, t_max, att


def direct_lighting(light: Light, wo, n, p, f0, diffuse_color, roughness, *,
                    visibility_fn: Optional[Callable] = None, throughput=None,
                    rng_shadow=None, rng_sky=None,
                    sky_radiance_fn: Optional[Callable] = None,
                    ray_origin_bias: float = 0.1):
    """Reference direct_lighting (lighting.glsl:117-196).

    visibility_fn(origin, dir, t_max) -> {0,1} replaces the inline ray
    query (one trace for the light, one more for the sky ray).
    throughput (...,3) scales both terms (a path's weight; ones when not
    given). sky_radiance_fn(dir) -> (...,3) replaces the sky cubemap; with
    it and rng_sky given, one cosine-sampled sky ray is added, not divided
    by its pdf (the reference's own omission, kept for parity)."""

    def weighted(val):
        # T * val first, the JAX package's order; with no throughput the
        # multiply by ones is left out (it is exact)
        return val if throughput is None else throughput * val

    ray_origin = p + n * ray_origin_bias
    li, wi, t_max, att = fetch_light_properties(
        light, p, n, rng2=rng_shadow, soft_shadows=rng_shadow is not None)
    if visibility_fn is not None:
        vis = visibility_fn(ray_origin, wi, t_max)
        att = att * torch.where(att > 0.0, vis, 0.0)
    wh = normalize(wo + wi)
    val = brdf_ops.evaluate_uber_brdf(diffuse_color, roughness, n, f0, wo, wh, wi)
    lo = weighted(val) * att[..., None] * li

    if sky_radiance_fn is not None and rng_sky is not None:
        wi_s = brdf_ops.sample_cosine_lobe(n, rng_sky)
        li_s = sky_radiance_fn(wi_s)
        if visibility_fn is not None:
            t_sky = torch.full(p.shape[:-1], 1e4, dtype=p.dtype, device=p.device)
            li_s = li_s * visibility_fn(ray_origin, wi_s, t_sky)[..., None]
        wh_s = normalize(wo + wi_s)
        val_s = brdf_ops.evaluate_uber_brdf(diffuse_color, roughness, n, f0, wo, wh_s, wi_s)
        lo = lo + weighted(val_s) * li_s
    return lo
