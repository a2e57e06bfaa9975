"""Small batched vector helpers (GLSL built-ins of the reference shader
library). A "vec3" is an (..., 3) tensor."""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

EPSILON = 1e-4
INF_T = 1e5  # reference INFINITY = 100000.0 (src/shaders/common.glsl:17)

_LUMA = (0.299, 0.587, 0.114)


def dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def length(v: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp(dot(v, v), min=1e-20))


def normalize(v: Tensor) -> Tensor:
    return v / length(v)[..., None]


def cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def reflect(i: Tensor, n: Tensor) -> Tensor:
    """GLSL reflect: i - 2*dot(n,i)*n (i points toward the surface)."""
    return i - 2.0 * dot(n, i)[..., None] * n


def dot3(a: Tensor, b: Tensor) -> Tensor:
    """dot(a, b) summed left to right, as the CUDA kernels sum it
    (torch.sum on the card may pair the three terms differently)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize3(v: Tensor) -> Tensor:
    """normalize() with the squared length summed left to right (dot3),
    the order the CUDA kernels use."""
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=1e-20))[..., None]


def luminance(rgb: Tensor) -> Tensor:
    """Reference luminance (src/shaders/common.glsl:143-146), summed left
    to right like the à-trous kernel's."""
    r, g, b = _LUMA
    return torch.clamp(rgb[..., 0] * r + rgb[..., 1] * g + rgb[..., 2] * b, min=1e-4)


def make_rotation_matrix(z: Tensor):
    """Orthonormal basis with +Z = z (reference brdf.glsl:8-16).
    Returns (x, y, z) tangent-frame columns, each (..., 3)."""
    up_y = z.new_tensor([0.0, 1.0, 0.0]).expand(z.shape)
    up_z = z.new_tensor([0.0, 0.0, 1.0]).expand(z.shape)
    use_z = (torch.abs(dot(z, up_y)) > 0.99)[..., None]
    ref = torch.where(use_z, up_z, up_y)
    x = normalize(cross(ref, z))
    y = cross(z, x)
    return x, y, z


def to_world(frame, v: Tensor) -> Tensor:
    x, y, z = frame
    return v[..., 0:1] * x + v[..., 1:2] * y + v[..., 2:3] * z


def transform_h(m: Tensor, p: Tensor) -> Tensor:
    """(4,4) matrix times (..., 3) points with w = 1; returns (..., 4)."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return torch.einsum("ij,...j->...i", m, ph)


def transform_point(m: Tensor, p: Tensor) -> Tensor:
    """(4,4) matrix times (..., 3) points with the perspective divide."""
    out = transform_h(m, p)
    return out[..., :3] / out[..., 3:4]


def transform_point_noperspective(m: Tensor, p: Tensor) -> Tensor:
    return transform_h(m, p)[..., :3]


def transform_dir(m: Tensor, d: Tensor) -> Tensor:
    """The 3x3 part of a (4,4) matrix times (..., 3) directions."""
    return torch.einsum("ij,...j->...i", m[:3, :3], d)


def world_position_from_depth(tex_coords: Tensor, ndc_depth: Tensor,
                              view_proj_inverse: Tensor) -> Tensor:
    """Depth -> world position (reference common.glsl:169-184).
    tex_coords (..., 2) in [0, 1] with v = 0 at the top row, ndc_depth
    (...,) in [0, 1]; ndc y = +1 at the top row, hence the v flip."""
    screen = torch.stack([tex_coords[..., 0] * 2.0 - 1.0, 1.0 - tex_coords[..., 1] * 2.0], -1)
    ndc = torch.cat([screen, ndc_depth[..., None], torch.ones_like(ndc_depth)[..., None]], -1)
    world = torch.einsum("ij,...j->...i", view_proj_inverse, ndc)
    return world[..., :3] / world[..., 3:4]


def linear_eye_depth(z: Tensor, z_buffer_params) -> Tensor:
    """NDC depth -> linear eye depth (reference common.glsl:188-191);
    z_buffer_params as ``Camera.z_buffer_params`` gives them."""
    return 1.0 / (z_buffer_params[2] * z + z_buffer_params[3])


def take_rows(table: Tensor, idx: Tensor) -> Tensor:
    """``table[idx]`` for a (R, ...) table and integer indices of any shape,
    as one ``torch.take`` of flat element indices. Use it for rows of 16
    or 64 bytes (a float32 4-vector, a 4x4 matrix), which PyTorch's own row
    gather moves several times slower on the card; for 24-byte rows it is
    the slower of the two (``chip_smoke.py textured_phase`` times both at
    each width)."""
    row = math.prod(table.shape[1:])
    flat = idx.to(torch.int64)[..., None] * row + torch.arange(row, device=table.device)
    return torch.take(table, flat).reshape(*idx.shape, *table.shape[1:])


def smoothstep(edge0, edge1, x: Tensor) -> Tensor:
    t = torch.clamp((x - edge0) / max(edge1 - edge0, 1e-8), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
