"""Punctual-light sampling and direct lighting (reference
src/shaders/lighting.glsl), as in ``hybrid_rendering_tpu/ops/
lighting.py``. The light type is a host integer, so only the branch of
the active type is computed."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from hybrid_rendering_torch.ops import brdf as brdf_ops
from hybrid_rendering_torch.ops import kernels, shade
from hybrid_rendering_torch.ops.math3d import cross, dot, normalize, smoothstep
from hybrid_rendering_torch.types import (
    LIGHT_TYPE_DIRECTIONAL,
    LIGHT_TYPE_POINT,
    Light,
)
from hybrid_rendering_torch.utils import profiler

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


def shade_rays_plain(light: Light, p, n, rng_shadow=None, rng_sky=None, valid=None,
                     bias: float = 0.1):
    """Stage A of ``direct_lighting`` (K7a's plain version): returns
    (origin, direction, t_max, att), the shadow ray of every point and,
    where rng_sky is given, its cosine-lobe sky ray after them, stacked
    along the first axis ((k * lead[0], *lead[1:], 3), k = 1 or 2), and
    the light's attenuation (lead). t_max is 0 where `valid` is False and,
    for the shadow ray, where att is not > 0 (stage B discards that
    visibility)."""
    ray_origin = p + n * bias
    _, wi, t_max, att = fetch_light_properties(
        light, p, n, rng2=rng_shadow, soft_shadows=rng_shadow is not None)
    live = att > 0.0 if valid is None else valid & (att > 0.0)
    origin, direction, t = [ray_origin], [wi], [torch.where(live, t_max, 0.0)]
    if rng_sky is not None:
        t_sky = torch.full(p.shape[:-1], 1e4, dtype=p.dtype, device=p.device)
        origin.append(ray_origin)
        direction.append(brdf_ops.sample_cosine_lobe(n, rng_sky))
        t.append(t_sky if valid is None else torch.where(valid, t_sky, 0.0))
    return torch.cat(origin), torch.cat(direction), torch.cat(t), att


def shade_combine_plain(light: Light, wo, n, f0, diffuse_color, roughness, att, direction,
                        vis=None, throughput=None, sky_li=None):
    """Stage B of ``direct_lighting`` (K7b's plain version): both BRDF
    terms of every point from stage A's att and direction, the tracer's
    vis in stage A's layout (None: no visibility) and, with a sky ray,
    sky_li (lead, 3), the radiance of its direction."""

    def weighted(val):
        # T * val first, the JAX package's order; with no throughput the
        # multiply by ones is left out (it is exact)
        return val if throughput is None else throughput * val

    k = direction.shape[0] // att.shape[0]
    direction = direction.reshape((k,) + att.shape + (3,))
    if vis is not None:
        vis = vis.reshape((k,) + att.shape)
        att = att * torch.where(att > 0.0, vis[0], 0.0)
    li = light.color * light.intensity
    wi = direction[0]
    wh = normalize(wo + wi)
    val = brdf_ops.evaluate_uber_brdf(diffuse_color, roughness, n, f0, wo, wh, wi)
    lo = weighted(val) * att[..., None] * li
    if k == 2:
        wi_s = direction[1]
        li_s = sky_li if vis is None else sky_li * vis[1][..., None]
        wh_s = normalize(wo + wi_s)
        val_s = brdf_ops.evaluate_uber_brdf(diffuse_color, roughness, n, f0, wo, wh_s, wi_s)
        lo = lo + weighted(val_s) * li_s
    return lo


def direct_lighting(light: Light, wo, n, p, f0, diffuse_color, roughness, *,
                    visibility_fn: Optional[Callable] = None, throughput=None,
                    rng_shadow=None, rng_sky=None,
                    sky_radiance_fn: Optional[Callable] = None,
                    ray_origin_bias: float = 0.1, valid=None):
    """Reference direct_lighting (lighting.glsl:117-196), the program's
    span ``direct_light``.

    visibility_fn(origin, dir, t_max) -> {0,1} replaces the inline ray
    queries: ONE call traces the shadow rays and, with a sky sample, the
    sky rays stacked after them. throughput (...,3) scales both terms (a
    path's weight; ones when not given). sky_radiance_fn(dir) -> (...,3)
    replaces the sky cubemap; with it and rng_sky given, one
    cosine-sampled sky ray is added, not divided by its pdf (the
    reference's own omission, kept for parity). valid (...,) bool: where
    False, no ray of the point searches anything (t_max = 0).

    Two stages around the one visibility call: ``shade_rays_plain`` and
    ``shade_combine_plain`` for CPU tensors, K7 (``ops/shade.py``) for
    CUDA tensors, which evaluates a ``ProceduralSky``'s radiance itself
    and takes any other sky's from its call."""
    with profiler.span("direct_light"):
        lead = tuple(p.shape[:-1])
        N = p.numel() // 3
        rng_sky = rng_sky if sky_radiance_fn is not None else None
        k = 1 if rng_sky is None else 2
        plain = kernels.on_cpu(p)
        stage_a = shade_rays_plain if plain else shade.shade_rays
        origin, direction, t_max, att = stage_a(light, p, n, rng_shadow, rng_sky, valid,
                                                ray_origin_bias)
        vis = None
        if visibility_fn is not None:
            req = (k * lead[0],) + lead[1:]
            vis = visibility_fn(origin.reshape(req + (3,)), direction.reshape(req + (3,)),
                                t_max.reshape(req))
        sky = None if k == 1 or plain else shade.procedural_sky(sky_radiance_fn)
        sky_li = None
        if k == 2 and sky is None:
            sky_li = sky_radiance_fn(direction.reshape((2,) + lead + (3,))[1])
            profiler.count("sky_fn_points", N)
        if plain:
            return shade_combine_plain(light, wo, n, f0, diffuse_color, roughness, att,
                                       direction, vis, throughput, sky_li)
        profiler.count("shaded", N)
        lo = shade.shade_combine(light, wo, n, f0, diffuse_color, roughness, att, direction,
                                 vis, throughput, sky, sky_li)
        return lo.reshape(lead + (3,))
