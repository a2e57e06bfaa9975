"""The DDGI irradiance sampler, plain: ``models/ddgi.sample_irradiance``
at every point (a frozen copy of the port's plain path)."""
from __future__ import annotations

from hrref.config import DDGIConfig
from hrref.models import ddgi as ddgi_mod


def make_irradiance_sampler(grid: "ddgi_mod.ProbeGrid", cfg: DDGIConfig):
    """Returns sample(state, p, n, wo, valid=None) -> (...,3); `valid` is
    ignored, as the exact per-point evaluation needs no windows."""

    def sample(state, p, n, wo, valid=None):
        return ddgi_mod.sample_irradiance(grid, state, cfg, p, n, wo)

    return sample
