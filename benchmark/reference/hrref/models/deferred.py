"""Deferred shading combine + skybox (reference deferred.frag), as
``hybrid_rendering_tpu/models/deferred.py``: direct light x shadow
visibility + indirect diffuse + indirect specular (split-sum) x AO; sky
pixels get the environment radiance."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from hrref.config import DeferredConfig
from hrref.ops import brdf as brdf_ops
from hrref.ops.lighting import fetch_light_properties
from hrref.ops.math3d import dot, normalize, reflect
from hrref.types import Camera, GBuffer, Light
from hrref.utils import camera as camera_utils


def deferred_shading(gb: GBuffer, camera: Camera, light: Light, sky_radiance_fn: Callable,
                     width: int, height: int, shadow_visibility=None, ao=None,
                     reflections=None, gi_irradiance=None,
                     env_irradiance_fn: Optional[Callable] = None,
                     env_prefiltered_fn: Optional[Callable] = None,
                     cfg: DeferredConfig = DeferredConfig(),
                     components_out: Optional[dict] = None):
    """Combine the effect planes into the (H,W,3) HDR frame
    (deferred.frag:144-205). `components_out` receives the direct /
    indirect-diffuse / indirect-specular planes."""
    geom = gb.mesh_id >= 0
    n = gb.normal
    p = gb.position
    wo = normalize(camera.position - p)
    ndotv = torch.clamp(dot(n, wo), 0.0, 1.0)

    f0 = brdf_ops.f0_from_metallic(gb.albedo, gb.metallic)
    c_diffuse = gb.albedo * (1.0 - f0) * (1.0 - gb.metallic[..., None])

    # direct lighting x shadow visibility (deferred.frag:177-183)
    li, wi, _, att = fetch_light_properties(light, p, n, soft_shadows=False)
    wh = normalize(wo + wi)
    brdf_val = brdf_ops.evaluate_uber_brdf(c_diffuse, gb.roughness, n, f0, wo, wh, wi)
    vis = shadow_visibility if shadow_visibility is not None else torch.ones_like(att)
    direct = brdf_val * (att * vis)[..., None] * li

    # indirect (deferred.frag:153-173)
    kS = brdf_ops.fresnel_schlick_roughness(ndotv, f0, gb.roughness)
    kD = (1.0 - kS) * (1.0 - gb.metallic[..., None])
    if gi_irradiance is not None:
        irradiance = gi_irradiance
    elif env_irradiance_fn is not None:
        irradiance = env_irradiance_fn(n)
    else:
        irradiance = torch.zeros_like(gb.albedo)
    indirect_diffuse = irradiance * c_diffuse * kD

    if reflections is not None:
        prefiltered = reflections
    elif env_prefiltered_fn is not None:
        prefiltered = env_prefiltered_fn(reflect(-wo, n), gb.roughness)
    else:
        prefiltered = torch.zeros_like(gb.albedo)
    scale, bias = brdf_ops.env_brdf_approx(gb.roughness, ndotv)
    indirect_specular = (prefiltered * (f0 * scale[..., None] + bias[..., None])
                         * cfg.indirect_specular_strength)

    ao_term = ao[..., None] if ao is not None else 1.0
    color = direct + (indirect_diffuse + indirect_specular) * ao_term

    if components_out is not None:
        geom3 = geom[..., None]
        components_out["direct"] = torch.where(geom3, direct, 0.0)
        components_out["indirect_diffuse"] = torch.where(geom3, indirect_diffuse * ao_term, 0.0)
        components_out["indirect_specular"] = torch.where(geom3, indirect_specular * ao_term, 0.0)

    # skybox (deferred_shading.cpp:800-818)
    _, dirs = camera_utils.camera_rays(camera, width, height)
    return torch.where(geom[..., None], color, sky_radiance_fn(dirs))
