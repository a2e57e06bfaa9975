"""SVGF-style temporal reprojection with disocclusion tests (reference
src/shaders/reprojection.glsl), as ``hybrid_rendering_tpu/ops/
reprojection.py``: motion-vector surface reprojection, the four
disocclusion tests (out-of-frame, mesh id, plane distance, normal) and a
nearest-tap rescue where the bilinear history fails them."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hrref.ops import warp as warp_ops
from hrref.ops.math3d import transform_h
from hrref.types import Camera, GBuffer
from hrref.utils.camera import pixel_grid

PLANE_DISTANCE = 5.0  # reprojection.glsl:7
NORMAL_DISTANCE = 0.1  # reprojection.glsl:6


class ReprojectionResult(NamedTuple):
    history: torch.Tensor  # (H,W) or (H,W,C)
    history_moments: Optional[torch.Tensor]  # (H,W,2) or None
    history_length: torch.Tensor  # (H,W)
    valid: torch.Tensor  # (H,W) bool


def _disocclusion_valid(cur_pos, cur_normal, cur_mesh, prev_pos, prev_normal,
                        prev_mesh, in_frame):
    """is_reprojection_valid (reprojection.glsl:53-69)."""
    plane_ok = torch.abs(torch.sum((cur_pos - prev_pos) * cur_normal, -1)) <= PLANE_DISTANCE
    ndot = torch.abs(torch.sum(cur_normal * prev_normal, -1))
    return in_frame & (cur_mesh == prev_mesh) & plane_ok & (ndot * ndot > NORMAL_DISTANCE)


def reproject(gb: GBuffer, prev_gb: GBuffer, history, history_moments=None,
              history_length=None, reprojected_coord=None) -> ReprojectionResult:
    """Reproject `history` ((H,W) or (H,W,C)) into the current frame along
    the G-buffer motion vectors, or from the float pixel coords
    `reprojected_coord` = (hx, hy) where given."""
    H, W = gb.depth.shape
    single = history.ndim == 2
    hist_c = history[..., None] if single else history
    if reprojected_coord is None:
        yy, xx = pixel_grid(H, W, gb.depth.device)
        hx = xx + gb.motion[..., 0] * W
        hy = yy + gb.motion[..., 1] * H
    else:
        hx, hy = reprojected_coord

    C = hist_c.shape[-1]
    mom = (history_moments if history_moments is not None
           else torch.zeros((H, W, 2), device=gb.depth.device))
    hlen = (history_length if history_length is not None
            else torch.zeros((H, W), device=gb.depth.device))
    # continuous planes warp bilinearly; ids + positions warp nearest
    cont = torch.cat([hist_c, mom, hlen[..., None], prev_gb.normal], -1)
    ids = torch.cat([prev_gb.position, prev_gb.mesh_id.to(torch.float32)[..., None]], -1)

    bil, ok_b = warp_ops.warp_bilinear(cont, hx, hy)
    near, ok_n = warp_ops.warp_nearest(torch.cat([cont, ids], -1), hx, hy)

    prev_pos_n = near[..., C + 6: C + 9]
    prev_mesh_n = torch.round(near[..., C + 9]).to(torch.int32)

    def validity(warped_normal, in_frame):
        return _disocclusion_valid(gb.position, gb.normal, gb.mesh_id,
                                   prev_pos_n, warped_normal, prev_mesh_n, in_frame)

    valid_b = validity(bil[..., C + 3: C + 6], ok_b)
    valid_n = validity(near[..., C + 3: C + 6], ok_n)

    use_near = (~valid_b) & valid_n
    valid = valid_b | valid_n
    out = torch.where(use_near[..., None], near[..., : C + 3], bil[..., : C + 3])
    out = torch.where(valid[..., None], out, 0.0)

    hist_out = out[..., :C]
    return ReprojectionResult(
        history=hist_out[..., 0] if single else hist_out,
        history_moments=out[..., C: C + 2] if history_moments is not None else None,
        history_length=torch.where(valid, near[..., C + 2], 0.0),
        valid=valid,
    )


def virtual_point_coords(gb: GBuffer, camera: Camera, ray_length):
    """Virtual-point reprojection for mirror reflections
    (reprojection.glsl:78-111): the parallax point cam + camdir *
    (|camray| + hitT) through the previous view-projection. Returns float
    pixel coords (hx, hy)."""
    H, W = gb.depth.shape
    cam_ray = gb.position - camera.position
    cam_len = torch.sqrt(torch.clamp(torch.sum(cam_ray * cam_ray, -1), min=1e-12))
    cam_dir = cam_ray / cam_len[..., None]
    parallax = camera.position + cam_dir * (cam_len + ray_length)[..., None]
    clip = transform_h(camera.prev_view_proj, parallax)
    ndc = clip[..., :2] / torch.clamp(torch.abs(clip[..., 3:4]), min=1e-8) * torch.sign(
        clip[..., 3:4])
    hx = (ndc[..., 0] * 0.5 + 0.5) * W - 0.5
    hy = ((1.0 - ndc[..., 1]) * 0.5) * H - 0.5
    return hx, hy
