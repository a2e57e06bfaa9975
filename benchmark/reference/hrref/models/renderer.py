"""HybridRenderer, plain — the reference for the benchmark's hybrid
frames.

A frozen copy of the port's ``models/renderer.py`` on one device, without
its multi-device and dynamic-scene paths, over the plain tracers, stencils
and sampler of this package. The order is the program's (main.cpp:79-108):
G-buffer -> shadows + AO (their visibility rays in one request) -> DDGI
probe update + screen sample -> reflections -> deferred -> TAA -> tonemap.

``render_frame(state, camera, light)`` returns (outputs, state) with
`state` updated in place: each temporal buffer is rebound to this frame's
tensor.

``round_planes`` is the control of the benchmark's comparison: a function
applied to every colour, visibility and irradiance plane a pass hands on
(its temporal state included), such as a round trip through bfloat16. It
is the identity in the reference proper.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from hrref.config import RendererConfig
from hrref.models import (
    ao as ao_mod,
    ddgi as ddgi_mod,
    deferred as deferred_mod,
    gbuffer as gbuffer_mod,
    reflections as reflections_mod,
    shadows as shadows_mod,
    taa as taa_mod,
    tonemap as tonemap_mod,
)
from hrref.ops import bvh as bvh_mod
from hrref.ops import ddgi_sample, filters
from hrref.types import Camera, GBuffer, Light, SceneArrays
from hrref.utils import camera as camera_utils


def identity(x):
    return x


def round_tree(fn, x):
    """`fn` applied to every float32 tensor of `x` (a tensor, a dataclass
    of tensors or None); the other fields are kept."""
    if isinstance(x, torch.Tensor):
        return fn(x) if x.dtype == torch.float32 else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: round_tree(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


@dataclasses.dataclass
class RenderState:
    """All temporal state (the reference's ping-ponged images)."""

    prev_gbuffer: GBuffer
    shadows: shadows_mod.ShadowsState
    ao: ao_mod.AOState
    reflections: reflections_mod.ReflectionsState
    ddgi: ddgi_mod.DDGIState
    taa: taa_mod.TAAState
    prev_cam_pos: torch.Tensor  # (3,)
    frame_index: int

    @property
    def device(self) -> torch.device:
        return self.prev_gbuffer.depth.device


def _scaled_dims(width, height, scale):
    s = 1 << int(scale)
    return width // s, height // s


class HybridRenderer:
    """Owns the scene-bound plain tracers and the config; every tensor it
    makes lives on `device`."""

    def __init__(self, scene: SceneArrays, config: RendererConfig,
                 sky_radiance_fn: Callable,
                 env_irradiance_fn: Optional[Callable] = None,
                 env_prefiltered_fn: Optional[Callable] = None,
                 device="cpu", round_planes: Callable = identity):
        self.device = torch.device(device)
        self.scene = scene.to(self.device)
        self.config = config
        self.sky_radiance_fn = sky_radiance_fn
        self.env_irradiance_fn = env_irradiance_fn
        self.env_prefiltered_fn = env_prefiltered_fn
        self.round_planes = round_planes
        self.trace_scene = bvh_mod.make_trace_scene(self.scene)
        self.closest_fn, self.visibility_fn = bvh_mod.make_tracers(self.scene, self.trace_scene)
        self.closest_surface_fn = bvh_mod.make_surface_tracer(self.scene, self.trace_scene)
        # the probe grid is static per scene (ddgi.cpp:93-95, 115-118)
        lo, hi = self.scene.aabb()
        self.probe_grid = ddgi_mod.make_probe_grid(lo.cpu().numpy(), hi.cpu().numpy(),
                                                   config.ddgi)
        self.gi_sampler = ddgi_sample.make_irradiance_sampler(self.probe_grid, config.ddgi)

    # ------------------------------------------------------------------
    def create_state(self) -> RenderState:
        cfg = self.config
        W, H = cfg.width, cfg.height
        sw, sh = _scaled_dims(W, H, cfg.shadows.scale)
        aw, ah = _scaled_dims(W, H, cfg.ao.scale)
        rw, rh = _scaled_dims(W, H, cfg.reflections.scale)
        dev = self.device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # mesh_id starts at -1: no geometry -> disocclusion everywhere
        prev_gb = GBuffer(
            albedo=zeros(H, W, 3), metallic=zeros(H, W), normal=zeros(H, W, 3),
            motion=zeros(H, W, 2), roughness=zeros(H, W), curvature=zeros(H, W),
            mesh_id=zeros(H, W, dtype=torch.int32) - 1, linear_z=zeros(H, W),
            depth=zeros(H, W), position=zeros(H, W, 3))
        return RenderState(
            prev_gbuffer=prev_gb,
            shadows=shadows_mod.ShadowsState.create(sh, sw, dev),
            ao=ao_mod.AOState.create(ah, aw, dev),
            reflections=reflections_mod.ReflectionsState.create(rh, rw, dev),
            ddgi=ddgi_mod.DDGIState.create(self.probe_grid.num_probes, cfg.ddgi, dev),
            taa=taa_mod.TAAState.create(H, W, dev),
            prev_cam_pos=zeros(3),
            frame_index=0,
        )

    def render_frame(self, state: RenderState, camera: Camera, light: Light):
        """One frame. Returns (outputs dict, state); `state` is the same
        object, updated in place."""
        cfg = self.config
        W, H = cfg.width, cfg.height
        debug = cfg.debug_outputs
        outputs: Dict[str, torch.Tensor] = {}
        closest_surface_fn, visibility_fn = self.closest_surface_fn, self.visibility_fn
        q = lambda x: round_tree(self.round_planes, x)  # noqa: E731

        # --- G-buffer (main.cpp:79) ---
        gb = gbuffer_mod.render_gbuffer(closest_surface_fn, camera, W, H)
        if debug:
            outputs["gbuffer_albedo"] = gb.albedo
            outputs["gbuffer_normal"] = gb.normal
            outputs["gbuffer_depth"] = gb.depth

        # shared mip chain: one downsample per scale, each level cascading
        # from the previous (g_buffer.cpp:236-244)
        gb_mips = {0: gb}
        prev_mips = {0: state.prev_gbuffer}

        def mip(chain, scale):
            s = int(scale)
            while s not in chain:
                lo = max(k for k in chain if k < s)
                chain[lo + 1] = gbuffer_mod.downsample_gbuffer(chain[lo], 1)
            return chain[s]

        # --- shadows + AO (main.cpp:80-81): both wavefronts depend only on
        # the G-buffer, so their visibility rays ride ONE K2 launch ---
        shadow_raw = ao_raw = None
        if cfg.shadows.enabled and cfg.ao.enabled:
            gb_s = mip(gb_mips, cfg.shadows.scale)
            gb_a = mip(gb_mips, cfg.ao.scale)
            s_rays = shadows_mod.make_rays(gb_s, light, state.frame_index, cfg.shadows)
            a_rays = ao_mod.make_rays(gb_a, state.frame_index, cfg.ao)
            vis_s, vis_a = visibility_fn.many([s_rays[:3], a_rays])
            shadow_raw = shadows_mod.finish_rays(vis_s, gb_s, s_rays[3])
            ao_raw = ao_mod.finish_rays(vis_a, gb_a)

        shadow_vis = None
        if cfg.shadows.enabled:
            sh_out, state.shadows = shadows_mod.shadows_pass(
                visibility_fn, mip(gb_mips, cfg.shadows.scale),
                mip(prev_mips, cfg.shadows.scale), gb, light, state.shadows,
                state.frame_index, cfg.shadows, raw=shadow_raw)
            state.shadows = q(state.shadows)
            shadow_vis = q(sh_out.final)
            if debug:
                outputs["shadows_ray_trace"] = sh_out.ray_trace
                outputs["shadows_temporal"] = sh_out.temporal
                outputs["shadows_atrous"] = sh_out.atrous
                outputs["shadows"] = sh_out.final

        ao_plane = None
        if cfg.ao.enabled:
            ao_out, state.ao = ao_mod.ao_pass(
                visibility_fn, mip(gb_mips, cfg.ao.scale),
                mip(prev_mips, cfg.ao.scale), gb, state.ao, state.frame_index,
                cfg.ao, raw=ao_raw)
            state.ao = q(state.ao)
            ao_plane = q(ao_out.final)
            if debug:
                outputs["ao_ray_trace"] = ao_out.ray_trace
                outputs["ao_temporal"] = ao_out.temporal
                outputs["ao_blur"] = ao_out.blur
                outputs["ao"] = ao_out.final

        # --- DDGI (main.cpp:82): the update traces against the PREVIOUS
        # atlases (ddgi.cpp:775-778); the samples read the updated ones ---
        gi_screen = None
        gi_sample_fn = None
        if cfg.ddgi.enabled:
            state.ddgi = ddgi_mod.ddgi_update(
                closest_surface_fn, visibility_fn, self.probe_grid, state.ddgi,
                light, self.sky_radiance_fn, state.frame_index, cfg.ddgi, self.gi_sampler)
            state.ddgi = q(state.ddgi)

            def gi_sample_fn(p, n, wo, valid=None, _st=state.ddgi):
                return self.gi_sampler(_st, p, n, wo, valid=valid)

            gb_g = mip(gb_mips, cfg.ddgi.scale)
            gi_screen = ddgi_mod.sample_probe_grid_screen(
                self.probe_grid, state.ddgi, cfg.ddgi, gb_g, camera.position, self.gi_sampler)
            if cfg.ddgi.scale != 0:
                gi_screen = filters.upsample_edge_aware(
                    gi_screen, gb_g.normal, gb_g.linear_z, gb.normal, gb.linear_z,
                    int(cfg.ddgi.scale))
            gi_screen = q(gi_screen)
            if debug:
                outputs["ddgi"] = gi_screen

        # --- reflections (main.cpp:83) ---
        refl_plane = None
        if cfg.reflections.enabled:
            camera_delta = torch.linalg.norm(camera.position - state.prev_cam_pos)
            refl_out, state.reflections = reflections_mod.reflections_pass(
                closest_surface_fn, visibility_fn,
                mip(gb_mips, cfg.reflections.scale), mip(prev_mips, cfg.reflections.scale),
                gb, camera, camera_delta, light, self.sky_radiance_fn, state.reflections,
                state.frame_index, cfg.reflections, gi_sample_fn=gi_sample_fn,
                env_prefiltered_fn=self.env_prefiltered_fn)
            state.reflections = q(state.reflections)
            refl_plane = q(refl_out.final)
            if debug:
                outputs["reflections_ray_trace"] = refl_out.ray_trace
                outputs["reflections_temporal"] = refl_out.temporal
                outputs["reflections_atrous"] = refl_out.atrous
                outputs["reflections"] = refl_out.final

        # --- deferred shading (main.cpp:84-88) ---
        comps = {} if debug else None
        hdr = deferred_mod.deferred_shading(
            gb, camera, light, self.sky_radiance_fn, W, H,
            shadow_visibility=shadow_vis, ao=ao_plane, reflections=refl_plane,
            gi_irradiance=gi_screen,
            env_irradiance_fn=self.env_irradiance_fn,
            env_prefiltered_fn=self.env_prefiltered_fn,
            cfg=cfg.deferred, components_out=comps)
        hdr = q(hdr)
        if debug:
            outputs["deferred"] = hdr
            for k, v in comps.items():
                outputs[f"deferred_{k}"] = v

        # --- TAA (main.cpp:90-97) ---
        color = hdr
        if cfg.taa.enabled:
            color, state.taa = taa_mod.taa_resolve(hdr, gb, state.taa, cfg.taa)
            color, state.taa = q(color), q(state.taa)
        if debug:
            outputs["taa"] = color

        # --- tone map (main.cpp:98-108) ---
        outputs["ldr"] = q(tonemap_mod.tonemap(color, cfg.tonemap))

        # probe visualization over the HDR frame (deferred_shading.cpp:
        # 825-866), a debug view only
        if cfg.ddgi.enabled and debug:
            outputs["ddgi_probes"] = tonemap_mod.tonemap(
                ddgi_mod.visualize_probes(self.probe_grid, state.ddgi, cfg.ddgi, camera, hdr,
                                          gb.depth), cfg.tonemap)

        state.prev_gbuffer = gb
        state.prev_cam_pos = camera.position
        state.frame_index += 1
        return outputs, state

    # ------------------------------------------------------------------
    def make_camera(self, eye, target, frame_index: int = 0, prev_view_proj=None,
                    fov_y_deg: float = 60.0) -> Camera:
        """Per-frame camera with TAA Halton jitter (main.cpp:941-944)."""
        cfg = self.config
        jitter = (0.0, 0.0)
        if cfg.taa.enabled:
            jitter = taa_mod.halton_jitter(frame_index, cfg.width, cfg.height)
        return camera_utils.make_camera(
            eye=eye, target=target, fov_y_deg=fov_y_deg, width=cfg.width,
            height=cfg.height, jitter=jitter, prev_view_proj=prev_view_proj,
            device=self.device)
