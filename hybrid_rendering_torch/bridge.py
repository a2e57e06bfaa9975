"""Carry the JAX package's scene, light, camera and render state across
to the port.

The tests build a scene once with the JAX package and hand the same arrays
(as numpy) to both implementations; this module turns the JAX types into
the port's types. The renderer has no weights: its temporal state (probe
atlases, reflection history, the path tracer's accumulator) plays their
part, and the state converters let a test seed both implementations with
the same state. It takes any
objects with the JAX field names and never imports JAX itself.
"""
from __future__ import annotations

import numpy as np
import torch

from hybrid_rendering_torch.models.ao import AOState
from hybrid_rendering_torch.models.ddgi import DDGIState, ProbeGrid
from hybrid_rendering_torch.models.path_tracer import GroundTruthState
from hybrid_rendering_torch.models.reflections import ReflectionsState
from hybrid_rendering_torch.models.renderer import RenderState
from hybrid_rendering_torch.models.shadows import ShadowsState
from hybrid_rendering_torch.models.taa import TAAState
from hybrid_rendering_torch.scene.textures import TextureAtlas
from hybrid_rendering_torch.types import Camera, GBuffer, Light, Material, SceneArrays


def _t(a, device=None, dtype=None):
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def scene_from_jax(scene, device=None) -> SceneArrays:
    """JAX ``SceneArrays`` -> port ``SceneArrays``, its texture atlas and
    material map columns included."""
    mats = scene.materials
    opt = {}
    for f in ("bvh_nodes_min", "bvh_nodes_max", "bvh_nodes_meta", "bvh_tri_order"):
        v = getattr(scene, f)
        opt[f] = None if v is None else _t(v, device)
    cols = {f: None if getattr(mats, f) is None else _t(getattr(mats, f), device)
            for f in ("albedo_tex", "normal_tex", "roughness_tex", "metallic_tex",
                      "emissive_tex", "roughness_channel", "metallic_channel")}
    atlas = scene.atlas
    if atlas is not None:
        atlas = TextureAtlas(image=_t(atlas.image, device), rects=_t(atlas.rects, device))
    return SceneArrays(
        tri_pos=_t(scene.tri_pos, device), tri_normal=_t(scene.tri_normal, device),
        tri_uv=_t(scene.tri_uv, device), tri_mat=_t(scene.tri_mat, device),
        tri_mesh_id=_t(scene.tri_mesh_id, device),
        materials=Material(albedo=_t(mats.albedo, device), roughness=_t(mats.roughness, device),
                           metallic=_t(mats.metallic, device), emissive=_t(mats.emissive, device),
                           **cols),
        tri_tangent=_t(scene.tri_tangent, device), atlas=atlas, **opt,
    )


def light_from_jax(light, device=None) -> Light:
    return Light(
        direction=_t(light.direction, device), position=_t(light.position, device),
        color=_t(light.color, device), intensity=float(np.asarray(light.intensity)),
        radius=float(np.asarray(light.radius)), type=int(np.asarray(light.type)),
        cos_theta_outer=float(np.asarray(light.cos_theta_outer)),
        cos_theta_inner=float(np.asarray(light.cos_theta_inner)),
    )


def camera_from_jax(cam, device=None) -> Camera:
    mats = {f: _t(getattr(cam, f), device)
            for f in ("view", "proj", "view_inverse", "proj_inverse", "view_proj",
                      "view_proj_inverse", "prev_view_proj", "position")}
    return Camera(**mats, near=float(np.asarray(cam.near)), far=float(np.asarray(cam.far)),
                  jitter=tuple(float(v) for v in np.asarray(cam.jitter)),
                  prev_jitter=tuple(float(v) for v in np.asarray(cam.prev_jitter)))


def probe_grid_from_jax(grid) -> ProbeGrid:
    return ProbeGrid(counts=tuple(int(c) for c in grid.counts),
                     start=np.array(grid.start, np.float32),
                     step=np.array(grid.step, np.float32),
                     max_distance=float(grid.max_distance))


def ddgi_state_from_jax(state, device=None) -> DDGIState:
    accum = state.accum_frames
    return DDGIState(irradiance=_t(state.irradiance, device), depth=_t(state.depth, device),
                     first_frame=int(np.asarray(state.first_frame)),
                     accum_frames=0 if accum is None else int(np.asarray(accum)))


def reflections_state_from_jax(state, device=None) -> ReflectionsState:
    return ReflectionsState(history=_t(state.history, device),
                            moments=_t(state.moments, device),
                            history_length=_t(state.history_length, device))


def ground_truth_state_from_jax(state, device=None) -> GroundTruthState:
    return GroundTruthState(color=_t(state.color, device),
                            num_frames=_t(state.num_frames, device, torch.int32))


def render_state_from_jax(state, device=None) -> RenderState:
    """JAX ``RenderState`` -> port ``RenderState``: every tensor on
    `device`, the frame counters and TAA's flag as Python ints and bool."""
    gb = state.prev_gbuffer
    return RenderState(
        prev_gbuffer=GBuffer(**{f: _t(getattr(gb, f), device)
                                for f in GBuffer.__dataclass_fields__}),
        shadows=ShadowsState(history=_t(state.shadows.history, device),
                             moments=_t(state.shadows.moments, device),
                             history_length=_t(state.shadows.history_length, device)),
        ao=AOState(history=_t(state.ao.history, device),
                   history_length=_t(state.ao.history_length, device)),
        reflections=reflections_state_from_jax(state.reflections, device),
        ddgi=ddgi_state_from_jax(state.ddgi, device),
        taa=TAAState(history=_t(state.taa.history, device),
                     initialized=bool(np.asarray(state.taa.initialized))),
        prev_cam_pos=_t(state.prev_cam_pos, device),
        frame_index=int(np.asarray(state.frame_index)),
    )
