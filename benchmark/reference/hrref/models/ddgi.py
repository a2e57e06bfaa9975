"""DDGI — irradiance probe-grid global illumination, as
``hybrid_rendering_tpu/models/ddgi.py`` (reference src/ddgi.{h,cpp},
src/shaders/gi/*).

A probe grid sized from the scene AABB; per frame, every probe traces the
same randomly rotated spherical-Fibonacci rays, shades the hits (direct
light with sun and sky rays, plus an infinite bounce read from the
previous frame's atlases), and blends a cosine-weighted irradiance atlas
(8x8 octahedral texels a probe) and a Chebyshev depth atlas (16x16, mean
and mean^2) into the old ones with a warmed-up 0.98 hysteresis.

Because the rotation is shared by every probe, the texel/ray cosine
weights are the same for all probes, so the probe update is one fp32
``torch.matmul`` (texels x rays) @ (probes, rays, channels).

``sample_irradiance`` here is the plain PyTorch version of kernel K5
(8-probe cage, octahedral-bilinear irradiance, Chebyshev visibility,
backface weight, normal bias); ``ops/ddgi_sample.py`` holds the kernel's
wrapper and ``make_irradiance_sampler``, which the update and the screen
sample take as their ``sampler``. Its dot products run left to right
(``math3d.dot3``) in the order the kernel sums them.

The JAX package's coherent packet layout for probe rays
(``DDGI_COHERENT``) is a TPU tracer aid and is not ported: rays are traced
in (probe, ray) order. Ray randomness is keyed by the Fibonacci index, so
each ray gets the same values in either layout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from hrref.config import DDGIConfig
from hrref.ops import brdf as brdf_ops
from hrref.ops import rng as rng_ops
from hrref.ops.lighting import direct_lighting
from hrref.ops.math3d import dot3, normalize, normalize3, transform_h
from hrref.ops.octahedral import (
    direction_to_octahedral,
    octahedral_to_direction,
)
from hrref.types import GBuffer, Light


@dataclasses.dataclass(frozen=True)
class ProbeGrid:
    """Static grid geometry (DDGIUniforms, ddgi.cpp:14-32): host ints and
    numpy float32."""

    counts: tuple  # (Px, Py, Pz)
    start: np.ndarray  # (3,)
    step: np.ndarray  # (3,)
    max_distance: float

    @property
    def num_probes(self) -> int:
        px, py, pz = self.counts
        return px * py * pz


def make_probe_grid(scene_min, scene_max, cfg: DDGIConfig) -> ProbeGrid:
    """Probe-cage layout over the scene AABB: "padded" (the reference's,
    rows from the AABB min with `probe_grid_padding` extra rows) or
    "interior" (rows inset just inside the AABB)."""
    lo = np.asarray(scene_min, np.float32)
    hi = np.asarray(scene_max, np.float32)
    extent = hi - lo
    if cfg.grid_layout == "interior":
        counts = tuple(max(2, int(np.ceil(extent[i] / cfg.probe_distance)) + 1)
                       for i in range(3))
        inset = np.minimum(0.1 * cfg.probe_distance, 0.25 * extent)
        step = np.maximum((extent - 2.0 * inset) / (np.asarray(counts, np.float32) - 1.0),
                          1e-3).astype(np.float32)
        return ProbeGrid(counts=counts, start=lo + inset, step=step,
                         max_distance=float(cfg.max_distance_factor * step.max()))
    counts = tuple(int(np.ceil(extent[i] / cfg.probe_distance)) + cfg.probe_grid_padding
                   for i in range(3))
    return ProbeGrid(counts=counts, start=lo,
                     step=np.full(3, cfg.probe_distance, np.float32),
                     max_distance=cfg.max_distance_factor * cfg.probe_distance)


def probe_positions(grid: ProbeGrid, device=None) -> torch.Tensor:
    """(P,3) world positions, x-major (gi_common.glsl
    grid_coord_to_probe_index)."""
    px, py, pz = grid.counts
    zz, yy, xx = np.meshgrid(np.arange(pz), np.arange(py), np.arange(px), indexing="ij")
    coords = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    return torch.as_tensor(grid.start + coords * grid.step, device=device)


@dataclasses.dataclass
class DDGIState:
    """The probe atlases and their frame counters (ddgi.h:82-85).
    first_frame gates the infinite bounce and the hysteresis;
    accum_frames drives the warm-up min(h, n/(n+1))."""

    irradiance: torch.Tensor  # (P, S, S, 3)
    depth: torch.Tensor  # (P, D, D, 2) mean, mean^2
    first_frame: int = 1
    accum_frames: int = 0

    @staticmethod
    def create(num_probes: int, cfg: DDGIConfig, device=None) -> "DDGIState":
        s, d = cfg.irradiance_oct_size, cfg.depth_oct_size
        return DDGIState(
            irradiance=torch.zeros((num_probes, s, s, 3), device=device),
            depth=torch.zeros((num_probes, d, d, 2), device=device))


# ---------------------------------------------------------------------------
# Octahedral atlas addressing
# ---------------------------------------------------------------------------


def _texel_directions(side: int, device=None) -> torch.Tensor:
    """(side*side, 3) directions at texel centers (gi_common.glsl:143-160)."""
    idx = np.arange(side)
    xx, yy = np.meshgrid(idx, idx, indexing="xy")
    oct_ = np.stack([(xx + 0.5) / side * 2.0 - 1.0, (yy + 0.5) / side * 2.0 - 1.0],
                    -1).reshape(-1, 2)
    return octahedral_to_direction(torch.as_tensor(oct_, dtype=torch.float32, device=device))


def _wrap_oct_coords(x, y, side: int):
    """Octahedral wrap of out-of-range texel indices (the reference's
    mirrored border copy, gi_border_update.glsl): two passes, then a
    clamp."""

    def wrap_once(x, y):
        xl = x < 0
        x = torch.where(xl, -x - 1, x)
        y = torch.where(xl, side - 1 - y, y)
        xh = x > side - 1
        x = torch.where(xh, 2 * side - 1 - x, x)
        y = torch.where(xh, side - 1 - y, y)
        yl = y < 0
        y = torch.where(yl, -y - 1, y)
        x = torch.where(yl, side - 1 - x, x)
        yh = y > side - 1
        y = torch.where(yh, 2 * side - 1 - y, y)
        x = torch.where(yh, side - 1 - x, x)
        return x, y

    x, y = wrap_once(x, y)
    x, y = wrap_once(x, y)  # corners need two passes
    return torch.clamp(x, 0, side - 1), torch.clamp(y, 0, side - 1)


def _finite_floor(x):
    """floor(x), with a non-finite result read as 0 (the index it feeds is
    clamped afterwards, so such a point never reads out of bounds)."""
    f = torch.floor(x)
    return torch.where(torch.isfinite(f), f, 0.0)


def oct_bilinear_sample(atlas, probe_idx, dirs):
    """Bilinear sample of a borderless oct atlas (P,S,S,C) at directions
    dirs (...,3) for probes probe_idx (...,). Returns (...,C)."""
    P, S, _, C = atlas.shape
    oct_ = direction_to_octahedral(dirs)
    tx = (oct_[..., 0] * 0.5 + 0.5) * S - 0.5
    ty = (oct_[..., 1] * 0.5 + 0.5) * S - 0.5
    x0f = torch.floor(tx)
    y0f = torch.floor(ty)
    fx = (tx - x0f)[..., None]
    fy = (ty - y0f)[..., None]
    x0 = _finite_floor(tx).to(torch.int64)
    y0 = _finite_floor(ty).to(torch.int64)
    flat = atlas.reshape(P * S * S, C)

    def tap(xi, yi):
        xw, yw = _wrap_oct_coords(xi, yi, S)
        return flat[probe_idx * (S * S) + yw * S + xw]

    return (tap(x0, y0) * (1 - fx) * (1 - fy) + tap(x0 + 1, y0) * fx * (1 - fy)
            + tap(x0, y0 + 1) * (1 - fx) * fy + tap(x0 + 1, y0 + 1) * fx * fy)


# ---------------------------------------------------------------------------
# sample_irradiance (gi_common.glsl:188-320): the plain version of K5
# ---------------------------------------------------------------------------


def sample_irradiance(grid: ProbeGrid, state: DDGIState, cfg: DDGIConfig, p, n, wo):
    """Irradiance at points p (...,3) with normals n, seen from wo: the
    8-probe trilinear cage with wrap-shaded backface and Chebyshev
    visibility weights, blended in sqrt space; 0.5*pi is not applied (the
    JAX package's energy calibration). Returns (...,3)."""
    dev = p.device
    counts = torch.tensor(grid.counts, dtype=torch.int64, device=dev)
    start = torch.tensor(grid.start, device=dev)
    step = torch.tensor(grid.step, device=dev)
    stride = torch.tensor([1, grid.counts[0], grid.counts[0] * grid.counts[1]],
                          dtype=torch.int64, device=dev)

    base = torch.minimum(torch.clamp(_finite_floor((p - start) / step), min=0.0),
                         (counts - 1).to(p.dtype)).to(torch.int64)
    base_pos = start + base.to(p.dtype) * step
    alpha = torch.clamp((p - base_pos) / step, 0.0, 1.0)
    bias = (n + 3.0 * wo) * cfg.normal_bias

    sum_irr = 0.0
    sum_w = 0.0
    for i in range(8):
        offset = torch.tensor([i & 1, (i >> 1) & 1, (i >> 2) & 1], dtype=torch.int64,
                              device=dev)
        coord = torch.minimum(base + offset, counts - 1)
        pidx = torch.sum(coord * stride, dim=-1)
        probe_pos = start + coord.to(p.dtype) * step

        probe_to_point = p - probe_pos + bias
        dir_ = normalize3(-probe_to_point)
        trilinear = torch.where(offset.to(torch.bool), alpha, 1.0 - alpha)
        tri_w = trilinear[..., 0] * trilinear[..., 1] * trilinear[..., 2]

        # wrap-shaded backface (gi_common.glsl:252)
        true_dir = normalize3(probe_pos - p)
        w = torch.square(torch.clamp((dot3(true_dir, n) + 1.0) * 0.5, min=1e-4)) + 0.2

        if cfg.visibility_test:
            dist = torch.sqrt(torch.clamp(dot3(probe_to_point, probe_to_point), min=1e-12))
            temp = oct_bilinear_sample(state.depth, pidx, -dir_)
            mean = temp[..., 0]
            variance = torch.abs(torch.square(mean) - temp[..., 1])
            cheb = variance / (variance + torch.square(torch.clamp(dist - mean, min=0.0))
                               + 1e-12)
            cheb = torch.clamp(cheb * cheb * cheb, min=0.0)
            w = w * torch.where(dist <= mean, 1.0, cheb)

        w = torch.clamp(w, min=1e-6)
        # crush tiny weights (gi_common.glsl:288-291). The divisor is a
        # tensor: PyTorch's CUDA division by a Python scalar multiplies by
        # its reciprocal, which the kernel (and XLA) do not.
        crush = 0.2
        w = torch.where(w < crush, w * w * w / torch.full_like(w, crush * crush), w)
        w = w * tri_w

        probe_irr = oct_bilinear_sample(state.irradiance, pidx, n)
        probe_irr = torch.sqrt(torch.clamp(probe_irr, min=0.0))  # LINEAR_BLENDING == 0

        sum_irr = sum_irr + w[..., None] * probe_irr
        sum_w = sum_w + w

    net = sum_irr / torch.clamp(sum_w, min=1e-9)[..., None]
    return torch.square(net) * cfg.energy_preservation


# ---------------------------------------------------------------------------
# Per-frame update
# ---------------------------------------------------------------------------


def _spherical_fibonacci(n: int) -> np.ndarray:
    """(n,3) spherical Fibonacci directions (gi_ray_trace.rgen:61-72)."""
    i = np.arange(n, dtype=np.float64)
    phi_g = np.sqrt(5.0) * 0.5 + 0.5
    frac = (i * (phi_g - 1.0)) % 1.0
    phi = 2.0 * np.pi * frac
    cos_theta = 1.0 - (2.0 * i + 1.0) / n
    sin_theta = np.sqrt(np.clip(1.0 - cos_theta ** 2, 0.0, 1.0))
    return np.stack([np.cos(phi) * sin_theta, np.sin(phi) * sin_theta, cos_theta],
                    -1).astype(np.float32)


def _random_rotation(frame_index: int) -> torch.Tensor:
    """Per-frame random rotation (3,3) on the CPU: a Shoemake quaternion
    from three Wang hashes of the frame index (the reference draws it from
    a host mt19937, ddgi.cpp:788)."""
    seed = rng_ops.as_u32(frame_index)
    u, v, w = (rng_ops.uint_to_unit_float(rng_ops.wang_hash((seed * 3 + k) & rng_ops.M32))
               for k in (1, 2, 3))
    two_pi = 2 * np.pi
    x = torch.sqrt(1 - u) * torch.sin(two_pi * v)
    y = torch.sqrt(1 - u) * torch.cos(two_pi * v)
    z = torch.sqrt(u) * torch.sin(two_pi * w)
    s = torch.sqrt(u) * torch.cos(two_pi * w)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - s * z), 2 * (x * z + s * y)]),
        torch.stack([2 * (x * y + s * z), 1 - 2 * (x * x + z * z), 2 * (y * z - s * x)]),
        torch.stack([2 * (x * z - s * y), 2 * (y * z + s * x), 1 - 2 * (x * x + y * y)]),
    ])


def _hysteresis(cfg: DDGIConfig, accum_frames: int) -> tuple:
    """(1 - h_eff, h_eff) with h_eff = min(h, n/(n+1)), in float32 as the
    JAX package computes it."""
    f32 = np.float32
    n = f32(accum_frames)
    h = np.minimum(f32(cfg.hysteresis), n / (n + f32(1.0)))
    return float(f32(1.0) - h), float(h)


def ddgi_update(closest_surface_fn: Callable, visibility_fn: Callable, grid: ProbeGrid,
                state: DDGIState, light: Light, sky_radiance_fn: Callable,
                frame_index: int, cfg: DDGIConfig, sampler: Callable) -> DDGIState:
    """One DDGI frame: probe ray trace, shade, and the irradiance/depth
    atlas update (ddgi.cpp:89-104). `sampler` is
    ``ops.ddgi_sample.make_irradiance_sampler(grid, cfg)``; it reads the
    previous atlases for the infinite bounce. Returns a new DDGIState."""
    P, R = grid.num_probes, cfg.rays_per_probe
    dev = state.irradiance.device

    fib = torch.as_tensor(_spherical_fibonacci(R), device=dev)
    rot = _random_rotation(frame_index).to(dev)
    ray_dirs = normalize(fib @ rot.T)  # (R,3), shared by every probe

    origins = probe_positions(grid, dev)
    o = origins[:, None, :].expand(P, R, 3).reshape(-1, 3)
    d = ray_dirs[None, :, :].expand(P, R, 3).reshape(-1, 3)
    idx = torch.arange(P * R, dtype=torch.int64, device=dev)

    hit, surf = closest_surface_fn(o, d, 1e4)

    # --- shade (gi_ray_trace.rchit:95-128) ---
    f0 = brdf_ops.f0_from_metallic(surf.albedo, surf.metallic)
    c_diff = surf.albedo * (1.0 - f0) * (1.0 - surf.metallic[:, None])
    rng = rng_ops.rng_init(idx % R, idx // R, frame_index)
    rng, rs = rng_ops.next_vec2(rng)
    rng, rsky = rng_ops.next_vec2(rng)
    radiance = direct_lighting(
        light, -d, surf.normal, surf.position, f0, c_diff, surf.roughness,
        visibility_fn=visibility_fn, rng_shadow=rs, rng_sky=rsky,
        sky_radiance_fn=sky_radiance_fn) + surf.emissive

    # infinite bounce from the previous frame's grid (rchit:123-124),
    # gated off on the first frame (ddgi.cpp:790)
    if cfg.infinite_bounces:
        bounce = sampler(state, surf.position, surf.normal, -d, valid=hit.valid)
        gate = 0.0 if state.first_frame else 1.0
        kd = brdf_ops.kd_indirect(surf.normal, -d, f0, surf.roughness, surf.metallic)
        radiance = radiance + kd * c_diff * bounce * cfg.infinite_bounce_intensity * gate

    # backface suppression (Majercik et al. 2019 4.2): no radiance, and a
    # 0.2x visibility distance so Chebyshev crushes probes behind walls
    backface = hit.valid & ~surf.frontface
    radiance = torch.where(backface[:, None], 0.0, radiance)
    radiance = torch.where(hit.valid[:, None], radiance, sky_radiance_fn(d))
    if cfg.probe_radiance_clamp > 0.0:  # the GT oracle's per-sample clamp
        radiance = torch.clamp(radiance, max=cfg.probe_radiance_clamp)
    hit_dist = torch.where(hit.valid, torch.where(backface, hit.t * 0.2, hit.t), -1.0)
    radiance = radiance.reshape(P, R, 3)
    hit_dist = hit_dist.reshape(P, R)

    # --- probe update as shared-weight matmuls (gi_probe_update.glsl) ---
    one_minus_h, h_eff = _hysteresis(cfg, state.accum_frames)

    def update_atlas(values, side, weights_pow, prev):
        cosw = torch.clamp(_texel_directions(side, dev) @ ray_dirs.T, min=0.0)  # (T,R)
        w = cosw if weights_pow is None else torch.pow(cosw, weights_pow)
        w = torch.where(w >= 1e-8, w, 0.0)
        total = torch.sum(w, dim=1)  # (T,), the same for every probe
        acc = torch.matmul(w, values)  # (P,T,C), fp32
        result = acc / torch.clamp(total, min=1e-8)[None, :, None]
        result = result.reshape(P, side, side, values.shape[-1])
        if state.first_frame:
            return result
        return result * one_minus_h + prev * h_eff

    irr = update_atlas(radiance, cfg.irradiance_oct_size, None, state.irradiance)
    depth_dist = torch.where(hit_dist < 0.0, grid.max_distance,
                             torch.clamp(hit_dist - 0.01, 0.0, grid.max_distance))
    depth_vals = torch.stack([depth_dist, depth_dist * depth_dist], -1)
    dep = update_atlas(depth_vals, cfg.depth_oct_size, cfg.depth_sharpness, state.depth)
    return DDGIState(irradiance=irr, depth=dep, first_frame=0,
                     accum_frames=state.accum_frames + 1)


def sample_probe_grid_screen(grid: ProbeGrid, state: DDGIState, cfg: DDGIConfig,
                             gb: GBuffer, camera_position, sampler: Callable):
    """Screen-space indirect diffuse (gi_sample_probe_grid.comp:75-99),
    consumed by deferred shading. Sky pixels get 0."""
    geom = gb.mesh_id >= 0
    wo = normalize(camera_position - gb.position)
    irr = sampler(state, gb.position, gb.normal, wo, valid=geom) * cfg.gi_intensity
    return torch.where(geom[..., None], irr, 0.0)


def visualize_probes(grid: ProbeGrid, state: DDGIState, cfg: DDGIConfig, camera,
                     base_image, gb_depth, radius: float = 0.12):
    """Probe visualization (gi_probe_visualization.vert/.frag): each probe
    splats a depth-tested disc colored by its mean atlas irradiance over
    `base_image`, in probe order against a running z-buffer. A debug
    output only."""
    H, W = gb_depth.shape
    dev = base_image.device
    pos = probe_positions(grid, dev)
    color = torch.mean(state.irradiance, dim=(1, 2))  # (P,3)

    clip = transform_h(camera.view_proj, pos)
    ndc = clip[:, :3] / torch.clamp(torch.abs(clip[:, 3:4]), min=1e-8) * torch.sign(clip[:, 3:4])
    in_front = clip[:, 3] > 0.0
    sx = (ndc[:, 0] * 0.5 + 0.5) * W
    sy = (1.0 - ndc[:, 1]) * 0.5 * H
    depth = ndc[:, 2]
    dist = torch.clamp(-transform_h(camera.view, pos)[:, 2], min=1e-3)
    pix_r = radius / dist * W * 0.5

    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    out, zbuf = base_image, gb_depth
    for i in range(pos.shape[0]):
        dx = xx - sx[i]
        dy = yy - sy[i]
        inside = (dx * dx + dy * dy <= pix_r[i] * pix_r[i]) & in_front[i]
        visible = inside & (depth[i] <= zbuf)
        out = torch.where(visible[..., None], color[i], out)
        zbuf = torch.where(visible, depth[i], zbuf)
    return out
