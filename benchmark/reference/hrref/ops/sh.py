"""Spherical-harmonics environment irradiance + GGX prefilter stand-in —
the no-DDGI / no-reflections fallbacks of deferred shading
(deferred.frag:115-141, 162-168), as in ``hybrid_rendering_tpu/ops/sh.py``.
The SH-9 projection of an analytic sky is a Monte-Carlo integral done once
at setup with the same host randomness (``np.random.RandomState``); that of
an equirect image is exact over its texels. ``brdf_integrate_lut`` is the
split-sum BRDF table."""
from __future__ import annotations

import math

import numpy as np
import torch


def _sh_basis(d):
    """Real SH basis l<=2, 9 coefficients. d: (..., 3) unit."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    one = torch.ones_like(x)
    return torch.stack(
        [
            0.282095 * one,
            0.488603 * y,
            0.488603 * z,
            0.488603 * x,
            1.092548 * x * y,
            1.092548 * y * z,
            0.315392 * (3.0 * z * z - 1.0),
            1.092548 * x * z,
            0.546274 * (x * x - y * y),
        ],
        dim=-1,
    )


def project_sky_sh9(sky_radiance_fn, num_samples: int = 4096, seed: int = 0,
                    device=None):
    """Monte-Carlo SH-9 projection of an analytic sky. Returns (9,3)."""
    rs = np.random.RandomState(seed)
    u = rs.uniform(size=(num_samples, 2))
    z = 1.0 - 2.0 * u[:, 0]
    phi = 2.0 * np.pi * u[:, 1]
    s = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    dirs = np.stack([s * np.cos(phi), z, s * np.sin(phi)], axis=-1).astype(np.float32)
    d = torch.as_tensor(dirs, device=device)
    radiance = sky_radiance_fn(d)  # (N,3)
    basis = _sh_basis(d)  # (N,9)
    return (4.0 * np.pi / num_samples) * torch.einsum("nc,nk->kc", radiance, basis)


def project_equirect_sh9(img):
    """Exact SH-9 projection of an equirect HDR map (the dw
    CubemapSHProjection equivalent for file-based environments,
    common.cpp:614-622). Texel solid angle = sin(theta) dtheta dphi.
    img: (H, W, 3) array or tensor; the result (9, 3) is on img's device
    (the CPU for an array)."""
    rad = torch.as_tensor(img, dtype=torch.float32)
    device = rad.device
    h, w = rad.shape[:2]
    theta = (np.arange(h) + 0.5) / h * np.pi  # v=0 -> +Y pole
    phi = ((np.arange(w) + 0.5) / w - 0.5) * 2.0 * np.pi
    st = np.sin(theta)
    # dir convention matches envmap._dir_to_equirect_uv
    dy = np.cos(theta)[:, None] * np.ones((1, w))
    dx = st[:, None] * np.cos(phi)[None, :]
    dz = st[:, None] * np.sin(phi)[None, :]
    dirs = torch.tensor(np.stack([dx, dy, dz], -1).reshape(-1, 3), dtype=torch.float32,
                        device=device)
    weights = (st[:, None] * np.ones((1, w))).reshape(-1)
    weights = weights * (np.pi / h) * (2.0 * np.pi / w)
    basis = _sh_basis(dirs)  # (N,9)
    return torch.einsum("nc,nk,n->kc", rad.reshape(-1, 3), basis,
                        torch.tensor(weights, dtype=torch.float32, device=device))


# cosine-convolution factors for irradiance (Ramamoorthi & Hanrahan)
_A = (math.pi, 2.0943951, 2.0943951, 2.0943951, 0.785398, 0.785398,
      0.785398, 0.785398, 0.785398)


def eval_irradiance_sh9(coeffs, n):
    """Diffuse irradiance E(n)/pi for SH-9 coeffs."""
    basis = _sh_basis(n)
    a = torch.tensor(_A, dtype=torch.float32, device=n.device)
    e = torch.einsum("...k,kc,k->...c", basis, coeffs, a)
    return torch.clamp(e / math.pi, min=0.0)


def make_env_fallbacks(sky_radiance_fn, num_samples: int = 4096, device=None):
    """Returns (irradiance_fn(n), prefiltered_fn(dir, roughness)); the SH
    coefficients live on `device`."""
    coeffs = project_sky_sh9(sky_radiance_fn, num_samples, device=device)

    def irradiance_fn(n):
        return eval_irradiance_sh9(coeffs, n)

    def prefiltered_fn(d, roughness):
        sharp = sky_radiance_fn(d)
        diffuse = eval_irradiance_sh9(coeffs, d)
        w = torch.clamp(roughness, 0.0, 1.0)[..., None]
        # roughness^2 falloff approximates the GGX mip chain
        return sharp * (1.0 - w * w) + diffuse * (w * w)

    return irradiance_fn, prefiltered_fn


def brdf_integrate_lut(size: int = 32, num_samples: int = 256, seed: int = 7):
    """Preintegrated split-sum BRDF LUT (dw BRDFIntegrateLUT equivalent) —
    Monte-Carlo over GGX half-vectors. Returns (size, size, 2): [scale,
    bias] indexed by (ndotv, roughness). Deferred shading uses the analytic
    fit by default; this LUT is the exact-parity option. The samples are
    evaluated together and summed one after another, in the order of the
    JAX package's scan. Built on the CPU."""
    from hrref.ops import brdf as brdf_ops
    from hrref.ops.math3d import dot

    rs = np.random.RandomState(seed)
    xi = torch.tensor(rs.uniform(size=(num_samples, 2)), dtype=torch.float32)

    ndotv = (torch.arange(size, dtype=torch.float32) + 0.5) / size
    rough = (torch.arange(size, dtype=torch.float32) + 0.5) / size
    NV, R = torch.meshgrid(ndotv, rough, indexing="ij")  # (S,S)

    v = torch.stack([torch.sqrt(1 - NV ** 2), torch.zeros_like(NV), NV], -1)  # (S,S,3)
    shape = (num_samples,) + v.shape
    n = v.new_tensor([0.0, 0.0, 1.0]).expand(shape)
    alpha = R * R
    h = brdf_ops.sample_specular_ggx_lobe(n, alpha.expand(shape[:-1]),
                                          xi[:, None, None, :].expand(shape[:-1] + (2,)))
    l = 2.0 * dot(v, h)[..., None] * h - v
    nl = torch.clamp(l[..., 2], 0.0, 1.0)
    nh = torch.clamp(h[..., 2], 0.0, 1.0)
    vh = torch.clamp(dot(v, h), 0.0, 1.0)
    valid = nl > 0
    g = brdf_ops.g_schlick_ggx(nl, torch.clamp(NV, 1e-4, 1.0), R)
    g_vis = torch.where(valid, g * vh / torch.clamp(nh * torch.clamp(NV, min=1e-4), min=1e-6),
                        0.0)
    fc = torch.pow(1.0 - vh, 5.0)
    terms_a, terms_b = (1 - fc) * g_vis, fc * g_vis
    a, b = torch.zeros_like(NV), torch.zeros_like(NV)
    for k in range(num_samples):
        a, b = a + terms_a[k], b + terms_b[k]
    return torch.stack([a, b], -1) / num_samples


def make_image_env_fallbacks(env):
    """(irradiance_fn, prefiltered_fn) for an EquirectEnvironment: SH-9
    irradiance from the exact equirect projection of the env's level 1 +
    the env's own pre-blurred pyramid as the GGX prefilter chain (the full
    file-based environment stack of common.cpp:597-625). The coefficients
    live on the env's device."""
    coeffs = project_equirect_sh9(env.levels[1])

    def irradiance_fn(n):
        return eval_irradiance_sh9(coeffs, n)

    return irradiance_fn, env.prefiltered
