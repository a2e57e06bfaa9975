"""G-buffer pass — primary rays fill every deferred plane (albedo,
metallic, normal, motion, roughness, curvature, mesh_id, linear z, NDC
depth, position), as ``hybrid_rendering_tpu/models/gbuffer.py`` does in
place of the reference's raster G-buffer (src/g_buffer.{h,cpp}).
Motion vectors come from camera reprojection of the hit, re-posed first
through its instance's previous transform when the scene is animated
(g_buffer.vert:71-84)."""
from __future__ import annotations

from typing import Callable

import torch

from hrref.ops.math3d import INF_T, transform_h
from hrref.scene.dynamic import prev_positions
from hrref.types import Camera, GBuffer
from hrref.utils import camera as camera_utils


def _ndc_from_world(view_proj, pos):
    w = transform_h(view_proj, pos)
    return w[..., :3] / torch.clamp(torch.abs(w[..., 3:4]), min=1e-8) * torch.sign(w[..., 3:4])


def screen_curvature(normal, mask):
    """length(dN/dx) + length(dN/dy) with wrap-around forward differences
    (g_buffer.frag:71-80)."""
    dx = normal - torch.roll(normal, -1, dims=1)
    dy = normal - torch.roll(normal, -1, dims=0)
    curv = torch.sqrt(torch.sum(dx * dx, -1)) + torch.sqrt(torch.sum(dy * dy, -1))
    return torch.where(mask, curv, 0.0)


def _uv_of(ndc):
    return torch.stack([(ndc[..., 0] + 1.0) * 0.5, (1.0 - ndc[..., 1]) * 0.5], -1)


def render_gbuffer(closest_surface_fn: Callable, camera: Camera, width: int,
                   height: int, motion_deltas=None) -> GBuffer:
    """Trace primary rays and fill every G-buffer plane.
    closest_surface_fn: from ops.bvh.make_surface_tracer. motion_deltas:
    (I, 4, 4) per-instance maps from the current to the previous pose
    (scene/dynamic.py ``motion_deltas``), or None for a static scene."""
    origins, dirs = camera_utils.camera_rays(camera, width, height)
    hit, surf = closest_surface_fn(origins, dirs, INF_T)

    pos = surf.position
    normal = surf.normal
    vmask = hit.valid
    vm3 = vmask[..., None]

    ndc = _ndc_from_world(camera.view_proj, pos)
    depth = torch.where(vmask, torch.clamp(ndc[..., 2], 0.0, 1.0), 1.0)
    view_pos = transform_h(camera.view, pos)
    linear_z = torch.where(vmask, -view_pos[..., 2], camera.far)

    # motion = prev_uv - curr_uv of the same world point (g_buffer.frag:55-67)
    pos_prev = pos
    if motion_deltas is not None:
        pos_prev = prev_positions(pos, surf.mesh_id, motion_deltas)
    ndc_prev = _ndc_from_world(camera.prev_view_proj, pos_prev)
    motion = torch.where(vm3, _uv_of(ndc_prev) - _uv_of(ndc), 0.0)

    curvature = screen_curvature(torch.where(vm3, normal, 0.0), vmask)

    return GBuffer(
        albedo=torch.where(vm3, surf.albedo, 0.0),
        metallic=torch.where(vmask, surf.metallic, 0.0),
        normal=torch.where(vm3, normal, 0.0),
        motion=motion,
        roughness=torch.where(vmask, surf.roughness, 1.0),
        curvature=curvature,
        mesh_id=torch.where(vmask, surf.mesh_id, -1),
        linear_z=linear_z,
        depth=depth,
        position=torch.where(vm3, pos, 0.0),
    )


def nearest_downsample(x, step: int):
    """Nearest downsample of an (H, W, ...) plane by a power-of-two step:
    the strided slice the JAX package's _ds2 cascade computes (odd
    trailing rows/columns dropped at each level)."""
    if step & (step - 1):
        raise ValueError(f"nearest_downsample: step must be a power of two, got {step}")
    h, w = x.shape[0] // step * step, x.shape[1] // step * step
    return x[:h:step, :w:step]


def downsample_gbuffer(gb: GBuffer, scale: int) -> GBuffer:
    """Nearest-filter downsample by 2**scale (the mip chain,
    g_buffer.cpp:236-244): a strided slice of every plane, cascaded one
    2x step at a time; odd trailing rows/columns are dropped as the JAX
    package's _ds2 drops them."""
    for _ in range(scale):
        gb = gb.map(lambda x: x[: x.shape[0] // 2 * 2: 2,
                                : x.shape[1] // 2 * 2: 2].contiguous())
    return gb
