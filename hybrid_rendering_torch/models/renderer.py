"""HybridRenderer — the frame loop on one device.

Port of ``hybrid_rendering_tpu/models/renderer.py``, in its order
(main.cpp:79-108): G-buffer -> shadows + AO (their visibility rays in ONE
K2 launch) -> DDGI probe update + screen sample -> reflections ->
deferred -> TAA -> tonemap. The DDGI update reads the previous frame's
atlases (its infinite bounce); the screen sample and the reflections read
the updated ones.

PyTorch runs eagerly, so there is no jit: ``render_frame(state, camera,
light)`` returns (outputs, state) with `state` updated in place — each
temporal buffer is rebound to this frame's tensor, so the previous frame's
buffers are freed as soon as the frame is done (what buffer donation does
in the JAX package).

Dynamic scenes: with an ``animator(frame_index) -> (I, 4, 4)`` the frame
first re-poses the soup and refits the trace structures on the device
(the reference's per-frame TLAS build, main.cpp:74), traces every pass
against them and hands the G-buffer the instances' motion.

Multi-device: with ``mesh=`` (``parallel.mesh.make_mesh``) the three
tracers shard every ray batch over the mesh's devices, each against its
device's copy of the scene (``parallel/trace.py``), as the JAX renderer's
``mesh=`` does; the rest of the frame runs on the mesh's first device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from hybrid_rendering_torch.config import RendererConfig
from hybrid_rendering_torch.models import (
    ao as ao_mod,
    ddgi as ddgi_mod,
    deferred as deferred_mod,
    gbuffer as gbuffer_mod,
    reflections as reflections_mod,
    shadows as shadows_mod,
    taa as taa_mod,
    tonemap as tonemap_mod,
)
from hybrid_rendering_torch.ops import bvh as bvh_mod
from hybrid_rendering_torch.ops import ddgi_sample, filters
from hybrid_rendering_torch.parallel import mesh as mesh_mod
from hybrid_rendering_torch.parallel import trace as parallel_trace
from hybrid_rendering_torch.scene import dynamic
from hybrid_rendering_torch.types import Camera, GBuffer, Light, SceneArrays
from hybrid_rendering_torch.utils import camera as camera_utils


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
    """Owns the scene-bound tracers and the config; every tensor it makes
    lives on `device`: the GPU unless the caller passes ``device="cpu"``
    (there is no silent move to the CPU when no GPU is present).
    `tracer_method` is ``bvh.make_tracers``'s method: "auto" (the BVH walk,
    K1/K2) or "flash_dense" (K6/K6′) among others. `animator`, a host
    function of the Python frame index returning (I, 4, 4) rigid
    per-instance transforms (indexed by the scene's mesh ids), makes the
    scene dynamic; the probe grid stays the one of the base scene. With
    `mesh` (``parallel.mesh.Mesh``) the tracers shard their rays over its
    devices and `device` is its first (another `device` is refused)."""

    def __init__(self, scene: SceneArrays, config: RendererConfig,
                 sky_radiance_fn: Callable,
                 env_irradiance_fn: Optional[Callable] = None,
                 env_prefiltered_fn: Optional[Callable] = None,
                 device=None, tracer_method: str = "auto",
                 animator: Optional[Callable] = None, mesh: Optional[mesh_mod.Mesh] = None):
        if mesh is not None:
            if device is not None and mesh_mod.canonical(device) != mesh.devices[0]:
                raise ValueError(f"HybridRenderer: device {device} is not the mesh's first "
                                 f"device {mesh.devices[0]}, where the frame runs")
            device = mesh.devices[0]
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("HybridRenderer runs on the GPU unless asked otherwise, and "
                                   "no CUDA device is available; pass device=\"cpu\" to render "
                                   "on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.scene = scene.to(self.device)
        self.config = config
        self.sky_radiance_fn = sky_radiance_fn
        self.env_irradiance_fn = env_irradiance_fn
        self.env_prefiltered_fn = env_prefiltered_fn
        self.tracer_method = tracer_method
        self.animator = animator
        self._last_pose = (None, None)  # (frame index, its transforms on the device)
        # the BVH (TraceScene), or the FlashScene for "flash_dense"
        self.trace_scene = bvh_mod.make_accel(self.scene, tracer_method)
        self.closest_fn, self.visibility_fn = bvh_mod.make_tracers(
            self.scene, self.trace_scene, tracer_method)
        self.closest_surface_fn = bvh_mod.make_surface_tracer(
            self.scene, self.trace_scene, tracer_method)
        # multi-device: every trace shards its rays over the mesh, each
        # shard against its device's copy of the scene (none where the
        # device is the renderer's)
        self.mesh = mesh
        if mesh is not None:
            self._replicas = parallel_trace.replicate(mesh, self.scene, self.trace_scene)
            self.closest_fn, self.visibility_fn, self.closest_surface_fn = \
                parallel_trace.shard_renderer_tracers(
                    mesh, self.closest_fn, self.visibility_fn, self.closest_surface_fn,
                    self._replicas, tracer_method)
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

    # ------------------------------------------------------------------
    def _pose(self, frame_index: int) -> torch.Tensor:
        """``animator(frame_index)`` on the renderer's device. A tensor on
        the host goes through pinned memory, so the copy does not wait for
        the device."""
        m = self.animator(frame_index).to(torch.float32)
        if self.device.type == "cuda" and m.device.type == "cpu":
            return m.pin_memory().to(self.device, non_blocking=True)
        return m.to(self.device)

    def posed_tracers(self, frame_index: int):
        """(closest_surface_fn, visibility_fn, motion deltas or None) for a
        frame: the scene's own tracers, or with an animator the tracers of
        the soup re-posed by ``animator(frame_index)`` over the refitted
        trace structures, and the deltas to ``animator(max(frame_index - 1,
        0))``. The animator must be a function of the frame index alone:
        the last frame's transforms are kept on the device and serve as the
        next frame's previous pose, so frames in order call it once each."""
        if self.animator is None:
            return self.closest_surface_fn, self.visibility_fn, None
        prev = max(frame_index - 1, 0)
        kept_index, kept = self._last_pose
        m_prev = kept if kept_index == prev else self._pose(prev)
        m_cur = m_prev if frame_index == prev else self._pose(frame_index)
        self._last_pose = (frame_index, m_cur)
        scene = dynamic.refit_scene(self.scene, m_cur)
        accel = bvh_mod.refit_accel(self.trace_scene, scene, self.tracer_method)
        closest_fn, visibility_fn = bvh_mod.make_tracers(scene, accel, self.tracer_method)
        closest_surface_fn = bvh_mod.make_surface_tracer(scene, accel, self.tracer_method)
        if self.mesh is not None:
            # the refit copied to the mesh's other devices, if any
            replicas = parallel_trace.replicate(
                self.mesh, scene, accel, base=(self.scene, self.trace_scene, self._replicas))
            _, visibility_fn, closest_surface_fn = parallel_trace.shard_renderer_tracers(
                self.mesh, closest_fn, visibility_fn, closest_surface_fn, replicas,
                self.tracer_method)
        return closest_surface_fn, visibility_fn, dynamic.motion_deltas(m_cur, m_prev)

    def render_frame(self, state: RenderState, camera: Camera, light: Light):
        """One frame. Returns (outputs dict, state); `state` is the same
        object, updated in place."""
        cfg = self.config
        W, H = cfg.width, cfg.height
        debug = cfg.debug_outputs
        outputs: Dict[str, torch.Tensor] = {}
        closest_surface_fn, visibility_fn, deltas = self.posed_tracers(state.frame_index)

        # --- G-buffer (main.cpp:79) ---
        gb = gbuffer_mod.render_gbuffer(closest_surface_fn, camera, W, H, motion_deltas=deltas)
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
            shadow_vis = sh_out.final
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
            ao_plane = ao_out.final
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

            def gi_sample_fn(p, n, wo, valid=None, _st=state.ddgi):
                return self.gi_sampler(_st, p, n, wo, valid=valid)

            gb_g = mip(gb_mips, cfg.ddgi.scale)
            gi_screen = ddgi_mod.sample_probe_grid_screen(
                self.probe_grid, state.ddgi, cfg.ddgi, gb_g, camera.position, self.gi_sampler)
            if cfg.ddgi.scale != 0:
                gi_screen = filters.upsample_edge_aware(
                    gi_screen, gb_g.normal, gb_g.linear_z, gb.normal, gb.linear_z,
                    int(cfg.ddgi.scale))
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
            refl_plane = refl_out.final
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
        if debug:
            outputs["deferred"] = hdr
            for k, v in comps.items():
                outputs[f"deferred_{k}"] = v

        # --- TAA (main.cpp:90-97) ---
        color = hdr
        if cfg.taa.enabled:
            color, state.taa = taa_mod.taa_resolve(hdr, gb, state.taa, cfg.taa)
        if debug:
            outputs["taa"] = color

        # --- tone map (main.cpp:98-108) ---
        outputs["ldr"] = tonemap_mod.tonemap(color, cfg.tonemap)

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
