"""Camera construction — replaces dw::Camera + update_uniforms (reference
src/main.cpp:937-972). The matrices are built on the host in numpy exactly
as ``hybrid_rendering_tpu/utils/camera.py`` builds them, then held as
float32 tensors.

Conventions: right-handed world, y-up, view looks down -Z; NDC x,y in
[-1,1] with y = +1 at the top row, depth in [0,1].
"""
from __future__ import annotations

import numpy as np
import torch

from hrref.types import Camera


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m.astype(np.float32)


def perspective(fov_y_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Perspective with depth mapped to [0,1] (z=near -> 0, z=far -> 1)."""
    f = 1.0 / np.tan(np.deg2rad(fov_y_deg) / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def jittered_proj(proj: np.ndarray, jitter_ndc_x: float, jitter_ndc_y: float) -> np.ndarray:
    """Add subpixel jitter to a projection matrix (TAA, temporal_aa.cpp:66-81)."""
    j = proj.copy()
    j[0, 2] += jitter_ndc_x
    j[1, 2] += jitter_ndc_y
    return j


def make_camera(eye, target, fov_y_deg: float = 60.0, width: int = 256,
                height: int = 256, near: float = 1.0, far: float = 1000.0,
                jitter=(0.0, 0.0), prev_view_proj=None, prev_jitter=(0.0, 0.0),
                up=(0.0, 1.0, 0.0), device=None) -> Camera:
    """Build a Camera (reference fov 60 / near 1 / far 1000)."""
    view = look_at(eye, target, up)
    proj = perspective(fov_y_deg, width / height, near, far)
    proj_j = jittered_proj(proj, jitter[0], jitter[1])
    view_proj = (proj_j @ view).astype(np.float32)
    if prev_view_proj is None:
        prev_view_proj = view_proj
    if isinstance(prev_view_proj, torch.Tensor):
        prev_view_proj = prev_view_proj.cpu().numpy()
    f64 = np.float64

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(
        view=t(view),
        proj=t(proj_j),
        view_inverse=t(np.linalg.inv(view.astype(f64))),
        proj_inverse=t(np.linalg.inv(proj_j.astype(f64))),
        view_proj=t(view_proj),
        view_proj_inverse=t(np.linalg.inv(view_proj.astype(f64))),
        prev_view_proj=t(prev_view_proj),
        position=t(eye),
        near=float(np.float32(near)),
        far=float(np.float32(far)),
        jitter=tuple(float(v) for v in np.asarray(jitter, np.float32)),
        prev_jitter=tuple(float(v) for v in np.asarray(prev_jitter, np.float32)),
    )


def camera_rays_for_pixels(camera: Camera, px, py, width: int, height: int):
    """Primary rays through float pixel coordinates (0.5 = first center)."""
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = 1.0 - py / height * 2.0
    ndc = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, 0.5),
                       torch.ones_like(ndc_x)], -1)
    world = torch.einsum("ij,...j->...i", camera.view_proj_inverse, ndc)
    world = world[..., :3] / world[..., 3:4]
    origins = camera.position.expand(world.shape)
    d = world - origins
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return origins, d


def pixel_grid(height: int, width: int, device=None):
    """(yy, xx) float32 pixel-index grids, each (H, W)."""
    return torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )


def pixel_uv(width: int, height: int, device=None):
    """(H, W, 2) texel-centre UVs in [0, 1] (v = 0 at the top row, as
    images are laid out)."""
    y, x = pixel_grid(height, width, device)
    return torch.stack([(x + 0.5) / width, (y + 0.5) / height], -1)


def camera_rays(camera: Camera, width: int, height: int, jitter_uv=None):
    """Primary rays through pixel centers: (origins, directions), each
    (H, W, 3). jitter_uv: optional (H,W,2) subpixel offsets in [0,1) added
    to the pixel corners in place of the centers (the GT path tracer
    jitters every sample, ground_truth_path_trace.rgen:56-60)."""
    y, x = pixel_grid(height, width, camera.view.device)
    if jitter_uv is None:
        return camera_rays_for_pixels(camera, x + 0.5, y + 0.5, width, height)
    return camera_rays_for_pixels(camera, x + jitter_uv[..., 0], y + jitter_uv[..., 1],
                                  width, height)
