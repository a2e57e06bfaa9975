"""DDGI irradiance sampler on the card: kernel K5, csrc/ddgi_sample.cu.

Counterpart of ``hybrid_rendering_tpu/ops/pallas/ddgi_sample.py``
(``make_fast_sampler``). It computes the exact per-point
``models/ddgi.sample_irradiance``, not the Pallas kernel's windowed
approximation. CPU tensors take that plain version; CUDA tensors launch
the kernel.
"""
from __future__ import annotations

import torch

from hybrid_rendering_torch.config import DDGIConfig
from hybrid_rendering_torch.models import ddgi as ddgi_mod
from hybrid_rendering_torch.ops import kernels


def _scalars(grid: "ddgi_mod.ProbeGrid", cfg: DDGIConfig) -> tuple:
    """The kernel's scalar arguments, which depend on the grid and the
    config only: atlas sides, probe counts, grid start and step, normal
    bias, energy and the visibility switch."""
    return (int(cfg.irradiance_oct_size), int(cfg.depth_oct_size),
            *(int(c) for c in grid.counts), *(float(v) for v in grid.start),
            *(float(v) for v in grid.step), float(cfg.normal_bias),
            float(cfg.energy_preservation), int(bool(cfg.visibility_test)))


def sample_irradiance(grid: "ddgi_mod.ProbeGrid", state: "ddgi_mod.DDGIState",
                      cfg: DDGIConfig, p, n, wo, scalars=None):
    """K5: irradiance at points p (...,3) with normals n, seen from wo,
    from the probe atlases of `state`. Returns (...,3) float32. `scalars`
    is ``_scalars(grid, cfg)`` where the caller keeps it."""
    if kernels.on_cpu(p):
        return ddgi_mod.sample_irradiance(grid, state, cfg, p, n, wo)
    shape = tuple(p.shape[:-1])
    # a contiguous operand stays a view here; only a strided one is copied
    p, n, wo = (t.reshape(-1, 3).contiguous() for t in (p, n, wo))
    N = p.shape[0]
    P = grid.num_probes
    scalars = scalars if scalars is not None else _scalars(grid, cfg)
    S, D = scalars[:2]
    dev = p.device
    kernels.require(p, "p", torch.float32, (N, 3), dev)
    kernels.require(n, "n", torch.float32, (N, 3), dev)
    kernels.require(wo, "wo", torch.float32, (N, 3), dev)
    kernels.require(state.irradiance, "irradiance", torch.float32, (P, S, S, 3), dev)
    kernels.require(state.depth, "depth", torch.float32, (P, D, D, 2), dev)
    out = torch.empty((N, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = kernels.lib().hr_ddgi_sample(
            state.irradiance.data_ptr(), state.depth.data_ptr(), *scalars,
            p.data_ptr(), n.data_ptr(), wo.data_ptr(), N, out.data_ptr(),
            kernels.stream_ptr(dev))
    kernels.check(err, "hr_ddgi_sample")
    sample_irradiance.launches += 1
    return out.reshape(shape + (3,))


sample_irradiance.launches = 0


def make_irradiance_sampler(grid: "ddgi_mod.ProbeGrid", cfg: DDGIConfig):
    """Returns sample(state, p, n, wo, valid=None) -> (...,3), the JAX
    package's sampler signature. `valid` only steers the Pallas kernel's
    shared tile windows; the exact per-point evaluation ignores it."""

    scalars = _scalars(grid, cfg)

    def sample(state, p, n, wo, valid=None):
        return sample_irradiance(grid, state, cfg, p, n, wo, scalars)

    return sample
