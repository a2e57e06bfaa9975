"""GGX/Schlick uber-BRDF: evaluation and importance sampling (reference
src/shaders/brdf.glsl), batched and branch-free like
``hybrid_rendering_tpu/ops/brdf.py``."""
from __future__ import annotations

import math

import torch

from hrref.ops.math3d import (
    EPSILON,
    dot,
    make_rotation_matrix,
    normalize,
    reflect,
    to_world,
)

M_PI = math.pi
MIRROR_ROUGHNESS_THRESHOLD = 0.05  # common.glsl:27


def sample_cosine_lobe(n, r2):
    """Cosine-hemisphere sample around n (brdf.glsl:20-32).
    n: (...,3), r2: (...,2) uniforms."""
    r2 = torch.clamp(r2, min=1e-5)
    phi = 2.0 * M_PI * r2[..., 1]
    cos_theta = torch.sqrt(r2[..., 0])
    sin_theta = torch.sqrt(1.0 - r2[..., 0])
    t = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                     cos_theta], -1)
    return normalize(to_world(make_rotation_matrix(n), t))


def sample_specular_ggx_lobe(n, alpha, xi2):
    """GGX half-vector sample around n (brdf.glsl:100-114).
    alpha (...,), xi2 (...,2) uniforms."""
    phi = 2.0 * M_PI * xi2[..., 0]
    cos_theta = torch.sqrt((1.0 - xi2[..., 1]) / torch.clamp(
        1.0 + (alpha * alpha - 1.0) * xi2[..., 1], min=1e-8))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    d = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                     cos_theta], -1)
    return normalize(to_world(make_rotation_matrix(n), d))


def d_ggx(ndoth, alpha):
    a2 = alpha * alpha
    denom = (ndoth * ndoth) * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(M_PI * denom * denom, min=EPSILON)


def g1_schlick_ggx(roughness, ndotv):
    k = ((roughness + 1.0) * (roughness + 1.0)) / 8.0
    return ndotv / torch.clamp(ndotv * (1.0 - k) + k, min=EPSILON)


def g_schlick_ggx(ndotl, ndotv, roughness):
    return g1_schlick_ggx(roughness, ndotl) * g1_schlick_ggx(roughness, ndotv)


def f_schlick(f0, vdoth):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - vdoth, min=0.0), 5.0)[..., None]


def evaluate_specular_brdf(roughness, F, ndoth, ndotl, ndotv):
    alpha = roughness * roughness
    num = (d_ggx(ndoth, alpha)[..., None] * F
           * g_schlick_ggx(ndotl, ndotv, roughness)[..., None])
    return num / torch.clamp(4.0 * ndotl * ndotv, min=EPSILON)[..., None]


def evaluate_diffuse_brdf(diffuse_color):
    return diffuse_color / M_PI


def pdf_specular_ggx_lobe(alpha, ndoth, vdoth):
    return d_ggx(ndoth, alpha) * ndoth / torch.clamp(4.0 * vdoth, min=EPSILON)


def pdf_cosine_lobe(ndotl):
    return ndotl / M_PI


def pdf_uber_brdf(n, roughness, wo, wh, wi):
    """50/50 mixed cosine + GGX pdf (brdf.glsl:118-129)."""
    ndotl = torch.clamp(dot(n, wi), min=0.0)
    ndoth = torch.clamp(dot(n, wh), min=0.0)
    vdoth = torch.clamp(dot(wi, wh), min=0.0)
    pd = pdf_cosine_lobe(ndotl)
    ps = pdf_specular_ggx_lobe(roughness * roughness, ndoth, vdoth)
    return 0.5 * (pd + ps)


def evaluate_uber_brdf(diffuse_color, roughness, n, f0, wo, wh, wi):
    """(1-F)*diffuse + specular (brdf.glsl:133-147)."""
    ndotl = torch.clamp(dot(n, wi), min=0.0)
    ndotv = torch.clamp(dot(n, wo), min=0.0)
    ndoth = torch.clamp(dot(n, wh), min=0.0)
    vdoth = torch.clamp(dot(wi, wh), min=0.0)
    F = f_schlick(f0, vdoth)
    specular = evaluate_specular_brdf(roughness, F, ndoth, ndotl, ndotv)
    diffuse = evaluate_diffuse_brdf(diffuse_color)
    return (1.0 - F) * diffuse + specular


def sample_uber_brdf(diffuse_color, f0, n, roughness, wo, rand3):
    """Combined 50/50 specular/diffuse sampling (brdf.glsl:151-176).
    rand3: (...,3) uniforms. Returns (brdf_value, wi, pdf)."""
    alpha = roughness * roughness
    xi = rand3[..., 1:3]
    wh_spec = sample_specular_ggx_lobe(n, alpha, xi)
    wi_mirror = reflect(-wo, n)
    wi_rough = reflect(-wo, wh_spec)
    wi_spec = torch.where((roughness < MIRROR_ROUGHNESS_THRESHOLD)[..., None],
                          wi_mirror, wi_rough)
    wi_diff = sample_cosine_lobe(n, xi)
    take_spec = (rand3[..., 0] < 0.5)[..., None]
    wi = torch.where(take_spec, wi_spec, wi_diff)
    wh = torch.where(take_spec, wh_spec, normalize(wo + wi_diff))
    pdf = pdf_uber_brdf(n, roughness, wo, wh, wi)
    val = evaluate_uber_brdf(diffuse_color, roughness, n, f0, wo, wh, wi)
    return val, wi, pdf


def f0_from_metallic(albedo, metallic):
    """Metalness-workflow f0 (deferred.frag)."""
    return 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]


def diffuse_from_metallic(albedo, metallic):
    """Metalness-workflow diffuse colour: albedo * (1 - metallic)."""
    return albedo * (1.0 - metallic[..., None])


def fresnel_schlick_roughness(cos_theta, f0, roughness):
    """deferred.frag:145-148. cos_theta/roughness (...,), f0 (...,3)."""
    fr = (1.0 - roughness)[..., None].expand(f0.shape)
    return f0 + (torch.maximum(fr, f0) - f0) * torch.pow(
        torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)[..., None]


def kd_indirect(n, wo, f0, roughness, metallic):
    """kD of indirect diffuse: (1 - fresnel_schlick_roughness) x
    (1 - metallic) (gi_ray_trace.rchit:82-86, deferred.frag:156-159)."""
    ndotv = torch.clamp(dot(n, wo), 0.0, 1.0)
    ks = fresnel_schlick_roughness(ndotv, f0, roughness)
    return (1.0 - ks) * (1.0 - metallic[..., None])


def env_brdf_approx(roughness, ndotv):
    """Analytic split-sum BRDF fit (Karis/Lazarov) standing in for the
    preintegrated LUT. Returns (scale, bias) for f0*scale + bias."""
    c0 = roughness.new_tensor([-1.0, -0.0275, -0.572, 0.022])
    c1 = roughness.new_tensor([1.0, 0.0425, 1.04, -0.04])
    r = roughness[..., None] * c0 + c1
    a004 = torch.minimum(r[..., 0] * r[..., 0],
                         torch.exp2(-9.28 * ndotv)) * r[..., 0] + r[..., 1]
    scale = a004 * -1.04 + r[..., 2]
    bias = a004 * 1.04 + r[..., 3]
    return scale, bias
