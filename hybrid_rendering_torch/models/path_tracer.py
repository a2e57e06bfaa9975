"""Ground-truth progressive path tracer — the fidelity oracle.

Port of ``hybrid_rendering_tpu/models/path_tracer.py`` (reference
GroundTruthPathTracer, src/ground_truth_path_tracer.{h,cpp}): per-pixel
xoroshiro RNG seeded by pixel and sample index, jittered primary ray,
per-bounce direct lighting (soft-shadowed punctual light + one
cosine-sampled sky ray) weighted by the path throughput, BRDF-sampled
indirect bounce with Russian roulette, radiance clamped to 1, and the
running mean ``prev + (c - prev) / num_frames``. As in the JAX package the
indirect bounce is live (the reference ships it commented out) and the
recursion is a bounded loop over the whole wavefront.

It traces through whatever tracers it is given: the renderer's
(``HybridRenderer.closest_surface_fn`` / ``visibility_fn``, so K1/K2 or,
with ``tracer_method="flash_dense"``, K6/K6′ on the card). PyTorch runs
eagerly: ``render_progressive`` rebinds the accumulator every sample.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from hybrid_rendering_torch.config import PathTracerConfig
from hybrid_rendering_torch.ops import brdf as brdf_ops
from hybrid_rendering_torch.ops import lighting
from hybrid_rendering_torch.ops import rng as rng_ops
from hybrid_rendering_torch.ops.math3d import INF_T, dot
from hybrid_rendering_torch.types import Camera, Light, SceneArrays
from hybrid_rendering_torch.utils import camera as camera_utils
from hybrid_rendering_torch.utils import profiler

RADIANCE_CLAMP = 1.0  # common.glsl:19 RADIANCE_CLAMP_COLOR


@dataclasses.dataclass
class GroundTruthState:
    """Progressive accumulation state."""

    color: torch.Tensor  # (H, W, 3) running mean
    num_frames: torch.Tensor  # () int32 samples accumulated so far

    @staticmethod
    def create(height: int, width: int, device=None) -> "GroundTruthState":
        return GroundTruthState(
            color=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            num_frames=torch.zeros((), dtype=torch.int32, device=device))

    def restart(self) -> "GroundTruthState":
        """restart_accumulation(): the reference resets the counter on any
        camera, light or scene change (ground_truth_path_tracer.h:17)."""
        return dataclasses.replace(self, num_frames=torch.zeros_like(self.num_frames))


def trace_wavefront(scene: SceneArrays, closest_surface_fn: Callable,
                    visibility_fn: Callable, light: Light, sky_radiance_fn: Callable,
                    origin, direction, rng: rng_ops.RNG,
                    cfg: PathTracerConfig = PathTracerConfig()):
    """Path-trace a flat wavefront: origin/direction (R,3), rng per ray.
    Returns (R,3) radiance clamped to RADIANCE_CLAMP."""
    R = origin.shape[0]
    dev = origin.device
    L = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    T = torch.ones((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)

    for depth in range(cfg.max_ray_bounces):
        with profiler.span("pt.closest"):
            # dead rays get t_max = 0: they search nothing at later depths
            t_max = INF_T if depth == 0 else torch.where(alive, INF_T, 0.0)
            hit, surf = closest_surface_fn(origin, direction, t_max)

        with profiler.span("pt.env"):
            # environment on a miss (rmiss: raw env at depth 0, else T * env)
            miss = ~hit.valid
            env = sky_radiance_fn(direction)
            env_contrib = env if depth == 0 else T * env
            L = torch.where((alive & miss)[:, None], L + env_contrib, L)
            alive = alive & hit.valid

        with profiler.span("pt.direct"):
            wo = -direction
            n = surf.normal
            p = surf.position
            f0 = brdf_ops.f0_from_metallic(surf.albedo, surf.metallic)
            # c_diffuse = mix(albedo * (1 - F0), 0, metallic) (rchit:135)
            c_diffuse = surf.albedo * (1.0 - f0) * (1.0 - surf.metallic[:, None])

            rng, rs = rng_ops.next_vec2(rng)
            rng, rsky = rng_ops.next_vec2(rng)

            # dead paths trace no shadow or sky ray
            lo = lighting.direct_lighting(
                light, wo, n, p, f0, c_diffuse, surf.roughness, visibility_fn=visibility_fn,
                throughput=T, rng_shadow=rs, rng_sky=rsky if cfg.sample_sky else None,
                sky_radiance_fn=sky_radiance_fn if cfg.sample_sky else None,
                ray_origin_bias=cfg.shadow_ray_bias, valid=alive)
            L = torch.where(alive[:, None], L + lo + T * surf.emissive, L)

        if depth + 1 >= cfg.max_ray_bounces:
            break

        # indirect bounce (rchit indirect_lighting:66-105)
        with profiler.span("pt.scatter"):
            rng, r3 = rng_ops.next_vec3(rng)
            brdf_val, wi, pdf = brdf_ops.sample_uber_brdf(c_diffuse, f0, n, surf.roughness, wo,
                                                          r3)
            cos_theta = torch.clamp(dot(n, wi), 0.0, 1.0)
            T_new = T * brdf_val * cos_theta[:, None] / torch.clamp(pdf, min=1e-6)[:, None]
            # Russian roulette on the largest throughput component; the
            # survival probability is clamped to 1 so specular paths with a
            # throughput above 1 are not biased low
            prob = torch.clamp(T_new.amax(dim=-1), max=1.0)
            rng, rr = rng_ops.next_float(rng)
            survive = rr <= prob
            T = T_new / torch.clamp(prob, min=1e-6)[:, None]
            alive = alive & survive & (cos_theta > 0.0)

            origin = p + surf.geo_normal * 1e-3
            direction = wi

    return torch.clamp(L, max=RADIANCE_CLAMP)


def trace_sample(scene: SceneArrays, closest_surface_fn: Callable, visibility_fn: Callable,
                 camera: Camera, light: Light, sky_radiance_fn: Callable, width: int,
                 height: int, frame_index, cfg: PathTracerConfig = PathTracerConfig()):
    """One 1-spp sample of the frame: (H, W, 3) clamped radiance.
    frame_index is an int or a 0-d integer tensor. It is the program's span
    ``trace_sample``: ``pt.rays``, then each bounce's ``pt.closest``,
    ``pt.env``, ``pt.direct`` and ``pt.scatter``."""
    with profiler.span("trace_sample"):
        dev = camera.view.device
        with profiler.span("pt.rays"):
            yy, xx = torch.meshgrid(torch.arange(height, device=dev),
                                    torch.arange(width, device=dev), indexing="ij")
            rng = rng_ops.rng_init(xx.reshape(-1), yy.reshape(-1), frame_index)
            # jittered primary ray (rgen:56-60)
            rng, jit2 = rng_ops.next_vec2(rng)
            origins, dirs = camera_utils.camera_rays(camera, width, height,
                                                     jitter_uv=jit2.reshape(height, width, 2))
        L = trace_wavefront(scene, closest_surface_fn, visibility_fn, light, sky_radiance_fn,
                            origins.reshape(-1, 3), dirs.reshape(-1, 3), rng, cfg)
        return L.reshape(height, width, 3)


def accumulate(state: GroundTruthState, sample) -> GroundTruthState:
    """Running mean (rgen:94-111): the first sample overwrites, later ones
    blend prev + (c - prev) / num_frames."""
    with profiler.span("accumulate"):
        nf = state.num_frames
        blended = state.color + (sample - state.color) / torch.clamp(nf, min=1).to(torch.float32)
        return GroundTruthState(color=torch.where(nf == 0, sample, blended), num_frames=nf + 1)


def render_progressive(scene: SceneArrays, closest_surface_fn, visibility_fn, camera: Camera,
                       light: Light, sky_radiance_fn, width: int, height: int,
                       num_samples: int, cfg: PathTracerConfig = PathTracerConfig(),
                       state: Optional[GroundTruthState] = None) -> GroundTruthState:
    """Accumulate `num_samples` progressive samples on the camera's
    device."""
    if state is None:
        state = GroundTruthState.create(height, width, camera.view.device)
    for _ in range(num_samples):
        sample = trace_sample(scene, closest_surface_fn, visibility_fn, camera, light,
                              sky_radiance_fn, width, height, state.num_frames, cfg)
        state = accumulate(state, sample)
    return state
