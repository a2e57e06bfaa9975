"""Dynamic (animated-instance) scenes, a port of
``hybrid_rendering_tpu/scene/dynamic.py``.

The scene keeps its world-space base pose; a per-frame (I, 4, 4) rigid
transform per instance (indexed by ``tri_mesh_id``, one id per
``SceneBuilder.add_instance``) re-poses the triangle soup on the scene's
device, as the reference rebuilds its TLAS every frame (src/main.cpp:74).
Rows are looked up by plain gathers (``take_rows``). The trace structures follow the
moved soup through ``ops/bvh.refit_accel``.

Motion vectors: a moving surface's previous position is its current one
mapped by delta_i = M_prev_i @ inv(M_cur_i) (g_buffer.vert:71-84 uses
per-draw previous model matrices the same way).

Transforms must be rigid (rotation + translation + uniform scale):
normals and tangents are turned by the 3x3 part and renormalised.
"""
from __future__ import annotations

import dataclasses

import torch

from hrref.ops.math3d import take_rows
from hrref.types import SceneArrays


def _apply(m, v):
    """m (..., 3, 3) times v (..., 3), each row summed left to right."""
    return (m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2]) + m[..., 2] * v[..., 2:3]


def _unit(v):
    """v / max(|v|, 1e-8), the squared length summed left to right."""
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])
    return v / torch.clamp(n, min=1e-8)[..., None]


def refit_scene(scene: SceneArrays, transforms: torch.Tensor) -> SceneArrays:
    """Re-pose the soup: transforms (I, 4, 4) on the scene's device,
    indexed by ``tri_mesh_id``. Returns a SceneArrays with moved positions
    and turned, renormalised normals and tangents (handedness kept); the
    triangle order, materials, atlas and BVH topology are the base scene's
    (the BVH boxes are stale until ``ops/bvh.refit_accel`` recomputes
    them)."""
    m = take_rows(transforms, scene.tri_mesh_id)  # (T, 4, 4)
    rot = m[:, None, :3, :3]
    pos = _apply(rot, scene.tri_pos) + m[:, None, :3, 3]
    nrm = _unit(_apply(rot, scene.tri_normal))
    tan = scene.tri_tangent
    tan = torch.cat([_unit(_apply(rot[:, 0], tan[:, :3])), tan[:, 3:4]], dim=1)
    return dataclasses.replace(scene, tri_pos=pos, tri_normal=nrm, tri_tangent=tan)


def motion_deltas(cur_transforms: torch.Tensor, prev_transforms: torch.Tensor) -> torch.Tensor:
    """(I, 4, 4) maps of a CURRENT world position of instance i to its
    PREVIOUS one: prev_i @ inv(cur_i). ``inv_ex`` does not check for a
    singular matrix, so nothing waits for the device."""
    return prev_transforms @ torch.linalg.inv_ex(cur_transforms).inverse


def prev_positions(pos, mesh_id, deltas):
    """Apply per-instance deltas to (..., 3) world positions by (...,)
    instance ids; an id < 0 (no geometry) keeps its position."""
    m = take_rows(deltas, torch.clamp(mesh_id, 0, deltas.shape[0] - 1))
    out = _apply(m[..., :3, :3], pos) + m[..., :3, 3]
    return torch.where((mesh_id >= 0)[..., None], out, pos)


def identity_transforms(num_instances: int, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).expand(num_instances, 4, 4)
