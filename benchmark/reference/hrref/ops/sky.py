"""Analytic sky radiance — ``ConstantSky``, ``PreethamSky`` and
``ProceduralSky`` of ``hybrid_rendering_tpu/ops/sky.py``: each a function
of direction, so the skybox and every miss shader evaluate it directly (no
cubemap). ``radiance(dirs)`` takes tensors on the sky's device; ``.to``
moves a sky there."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hrref.ops.math3d import dot, normalize


@dataclasses.dataclass
class ConstantSky:
    color: torch.Tensor  # (3,)

    def to(self, device) -> "ConstantSky":
        return ConstantSky(color=self.color.to(device))

    def radiance(self, dirs):
        return self.color.expand(dirs.shape[:-1] + (3,))


def _perez(cos_t, gamma, A, B, C, D, E):
    """Perez distribution at (theta, gamma), theta given as max(cos theta,
    1e-3): per direction, in torch."""
    return (1.0 + A * torch.exp(B / cos_t)) * (
        1.0 + C * torch.exp(D * gamma) + E * torch.cos(gamma) ** 2)


def _perez_host(gamma, A, B, C, D, E):
    """_perez at theta = 0 in numpy float32 scalars (every constant a
    float32, whatever numpy's rules for Python scalars)."""
    f = np.float32
    return (f(1.0) + A * np.exp(B)) * (
        f(1.0) + C * np.exp(D * gamma) + E * np.cos(gamma) * np.cos(gamma))


@dataclasses.dataclass
class PreethamSky:
    """Preetham analytic daylight model (Preetham et al. 1999, A Practical
    Analytic Model for Daylight): Perez luminance and chromaticity
    distributions driven by turbidity, plus a sun disc and a flat ground.
    Everything that depends on the sun and the turbidity alone (the Perez
    coefficients, the zenith values, the denominators) is float32 host
    arithmetic done once in `create`, as the JAX package does it in float32
    on every call; `radiance` runs the per-direction part."""

    sun_direction: torch.Tensor  # (3,) toward the sun
    exposure: float  # output scale
    # per channel (Y, x, y): (A, B, C, D, E, zenith, max(den, 1e-6))
    perez: tuple = dataclasses.field(repr=False)
    sun_up: float  # clip(sun.y, 0, 1)

    @staticmethod
    def create(sun_direction, turbidity=2.5, exposure=0.05):
        f = np.float32
        d = np.asarray(sun_direction, f)
        d = d / np.linalg.norm(d)
        T = f(turbidity)
        theta_s = np.arccos(np.clip(d[1], f(0.0), f(1.0)))

        def lin(a, b):
            return f(a) * T + f(b)

        rows = (  # (A, B, C, D, E) for Y, x, y
            (lin(0.1787, -1.4630), lin(-0.3554, 0.4275), lin(-0.0227, 5.3251),
             lin(0.1206, -2.5771), lin(-0.0670, 0.3703)),
            (lin(-0.0193, -0.2592), lin(-0.0665, 0.0008), lin(-0.0004, 0.2125),
             lin(-0.0641, -0.8989), lin(-0.0033, 0.0452)),
            (lin(-0.0167, -0.2608), lin(-0.0950, 0.0092), lin(-0.0079, 0.2102),
             lin(-0.0441, -1.6537), lin(-0.0109, 0.0529)),
        )
        chi = (f(4.0 / 9.0) - T / f(120.0)) * (f(np.pi) - f(2.0) * theta_s)
        Yz = (f(4.0453) * T - f(4.9710)) * np.tan(chi) - f(0.2155) * T + f(2.4192)
        ts, ts2, ts3 = theta_s, theta_s * theta_s, theta_s * theta_s * theta_s

        def poly(c3, c2, c1, c0):
            return f(c3) * ts3 + f(c2) * ts2 + f(c1) * ts + f(c0)

        def quad(p2, p1, p0):  # (T^2, T, 1) . (p2, p1, p0), left to right
            return T * T * p2 + T * p1 + f(1.0) * p0

        xz = quad(poly(0.00166, -0.00375, 0.00209, 0.0),
                  poly(-0.02903, 0.06377, -0.03202, 0.00394),
                  poly(0.11693, -0.21196, 0.06052, 0.25886))
        zz = quad(poly(0.00275, -0.00610, 0.00317, 0.0),
                  poly(-0.04214, 0.08970, -0.04153, 0.00516),
                  poly(0.15346, -0.26756, 0.06670, 0.26688))
        perez = tuple(
            tuple(float(c) for c in coeffs)
            + (float(zenith), float(np.maximum(_perez_host(theta_s, *coeffs), f(1e-6))))
            for coeffs, zenith in zip(rows, (Yz, xz, zz)))
        return PreethamSky(sun_direction=torch.from_numpy(d), exposure=float(f(exposure)),
                           perez=perez,
                           sun_up=float(np.clip(d[1], f(0.0), f(1.0))))

    def to(self, device) -> "PreethamSky":
        return dataclasses.replace(self, sun_direction=self.sun_direction.to(device))

    def radiance(self, dirs):
        d = normalize(dirs)
        sun = self.sun_direction
        cos_theta = torch.clamp(d[..., 1], 0.0, 1.0)
        theta = torch.arccos(cos_theta)
        cos_gamma = torch.clamp(dot(d, sun.expand(d.shape)), -1.0, 1.0)
        gamma = torch.arccos(cos_gamma)
        cos_t = torch.clamp(torch.cos(theta), min=1e-3)

        def ratio(A, B, C, D, E, zenith, den):
            return zenith * _perez(cos_t, gamma, A, B, C, D, E) / den

        Y = ratio(*self.perez[0])  # luminance
        x = ratio(*self.perez[1])  # CIE x chromaticity
        y_c = torch.clamp(ratio(*self.perez[2]), min=1e-6)  # CIE y

        # xyY -> XYZ -> linear sRGB
        X = x / y_c * Y
        Z = (1.0 - x - y_c) / y_c * Y
        r = 3.2406 * X - 1.5372 * Y - 0.4986 * Z
        g = -0.9689 * X + 1.8758 * Y + 0.0415 * Z
        b = 0.0557 * X - 0.2040 * Y + 1.0570 * Z
        rgb = torch.clamp(torch.stack([r, g, b], dim=-1), min=0.0) * self.exposure

        # sun disc
        disc = (cos_gamma > 0.9996).to(d.dtype)[..., None]
        rgb = rgb + disc * d.new_tensor([1.0, 0.95, 0.85]) * 50.0 * self.exposure

        below = (d[..., 1] < 0.0)[..., None]
        ground = d.new_tensor([0.12, 0.10, 0.09]) * (0.5 + 0.5 * self.sun_up)
        return torch.where(below, ground, rgb)


@dataclasses.dataclass
class ProceduralSky:
    """Rayleigh-ish gradient + sun glow + sun disc + ground, parameterized
    by the direction TOWARD the sun."""

    sun_direction: torch.Tensor  # (3,)
    sun_intensity: float
    turbidity: float

    @staticmethod
    def create(sun_direction, sun_intensity=20.0, turbidity=2.5):
        d = torch.as_tensor(np.asarray(sun_direction, np.float32))
        return ProceduralSky(sun_direction=d / torch.linalg.norm(d),
                             sun_intensity=float(sun_intensity),
                             turbidity=float(turbidity))

    def to(self, device) -> "ProceduralSky":
        return dataclasses.replace(self, sun_direction=self.sun_direction.to(device))

    def radiance(self, dirs):
        d = normalize(dirs)
        sun = self.sun_direction
        cos_gamma = torch.clamp(dot(d, sun.expand(d.shape)), -1.0, 1.0)
        up = torch.clamp(d[..., 1], -1.0, 1.0)

        zenith = d.new_tensor([0.22, 0.45, 0.90])
        horizon = d.new_tensor([0.80, 0.85, 0.95])
        t = torch.clamp(up, 0.0, 1.0)[..., None] ** 0.5
        sky = horizon + (zenith - horizon) * t

        glow = torch.exp((cos_gamma - 1.0) * 12.0)[..., None] * d.new_tensor(
            [1.0, 0.85, 0.6])
        disc = (cos_gamma > 0.9996)[..., None].to(d.dtype) * d.new_tensor(
            [1.0, 0.95, 0.85])

        below = (up < 0.0)[..., None]
        ground = d.new_tensor([0.12, 0.10, 0.09]) * torch.ones_like(sky)

        sun_h = torch.clamp(sun[1], 0.0, 1.0)
        result = sky * (0.2 + 0.8 * sun_h) + glow * 0.5 * sun_h + disc * self.sun_intensity
        return torch.where(below, ground, result)
