"""Core types shared by all render passes — dataclasses of tensors.

Counterparts of ``hybrid_rendering_tpu/types.py`` (flax pytrees there):
  - ``Light``        <- reference Light 4xvec4 pack (src/common.h:106-158)
  - ``Camera``       <- dw::Camera + the per-frame UBO matrices
  - ``SceneArrays``  <- the bindless scene descriptor set flattened into
                        dense device arrays
  - ``Hit`` / ``Surface`` / ``GBuffer``

Per-frame scalars that only the host decides (light type, cone cosines,
near/far) are Python numbers, so no pass has to read a device value back to
branch on it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

LIGHT_TYPE_DIRECTIONAL = 0
LIGHT_TYPE_POINT = 1
LIGHT_TYPE_SPOT = 2


def _to(obj, device):
    """Move every tensor field of a dataclass to `device` (new object;
    fields made by ``__post_init__`` are made anew)."""
    kw = {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = _to(v, device)
        kw[f.name] = v
    return type(obj)(**kw)


def _vec3(v) -> Tensor:
    return torch.as_tensor(np.asarray(v, np.float32))


def _unit(v) -> Tensor:
    d = _vec3(v)
    return d / torch.linalg.norm(d)


def _f32(x) -> float:
    """A Python float holding the float32 value, as the JAX package's
    float32 scalars hold it."""
    return float(np.float32(x))


@dataclasses.dataclass
class Light:
    """Single punctual light (reference common.glsl:84-139)."""

    direction: Tensor  # (3,) normalized, points FROM surface TOWARD light
    position: Tensor  # (3,)
    color: Tensor  # (3,)
    intensity: float
    radius: float  # soft-shadow disk radius
    type: int  # LIGHT_TYPE_*
    cos_theta_outer: float = 0.0  # spot outer cone
    cos_theta_inner: float = 0.0  # spot inner cone

    @staticmethod
    def directional(direction, color=(1.0, 1.0, 1.0), intensity=1.0,
                    radius=0.1):
        return Light(direction=_unit(direction), position=torch.zeros(3),
                     color=_vec3(color), intensity=_f32(intensity),
                     radius=_f32(radius), type=LIGHT_TYPE_DIRECTIONAL)

    @staticmethod
    def point(position, color=(1.0, 1.0, 1.0), intensity=1.0, radius=0.1):
        return Light(direction=_vec3((0.0, -1.0, 0.0)),
                     position=_vec3(position), color=_vec3(color),
                     intensity=_f32(intensity), radius=_f32(radius),
                     type=LIGHT_TYPE_POINT)

    @staticmethod
    def spot(position, direction, color=(1.0, 1.0, 1.0), intensity=1.0,
             radius=0.1, inner_angle_deg=20.0, outer_angle_deg=30.0):
        return Light(
            direction=_unit(direction), position=_vec3(position),
            color=_vec3(color), intensity=_f32(intensity),
            radius=_f32(radius), type=LIGHT_TYPE_SPOT,
            cos_theta_outer=_f32(math.cos(math.radians(outer_angle_deg))),
            cos_theta_inner=_f32(math.cos(math.radians(inner_angle_deg))),
        )

    def to(self, device) -> "Light":
        return _to(self, device)


@dataclasses.dataclass
class Camera:
    """Camera matrices — the per-frame UBO. Points transform as
    ``M @ [x,y,z,1]``; matrices are built on the host in numpy
    (utils/camera.py) and held here as float32 tensors."""

    view: Tensor  # (4,4) world -> view
    proj: Tensor  # (4,4) view -> clip (possibly jittered)
    view_inverse: Tensor
    proj_inverse: Tensor
    view_proj: Tensor
    view_proj_inverse: Tensor
    prev_view_proj: Tensor  # previous frame view_proj
    position: Tensor  # (3,)
    near: float
    far: float
    jitter: tuple  # (2,) current subpixel jitter in NDC units
    prev_jitter: tuple

    @property
    def z_buffer_params(self) -> tuple:
        """dw::Camera's z_buffer_params, which ``math3d.linear_eye_depth``
        reads: (1 - f/n, f/n, (1 - f/n)/f, (f/n)/f) in float32."""
        n, f = np.float32(self.near), np.float32(self.far)
        return tuple(float(v) for v in (1.0 - f / n, f / n, (1.0 - f / n) / f, (f / n) / f))

    def to(self, device) -> "Camera":
        return _to(self, device)


MAP_COLUMNS = ("albedo_tex", "normal_tex", "roughness_tex", "metallic_tex", "emissive_tex")


@dataclasses.dataclass
class Material:
    """Flat material table with the reference's five per-map texture
    indices (-1 = no map, the constant is used) and the roughness/metallic
    channel selectors (scene_descriptor_set.glsl:20-24, 180-228).

    `maps` names the texture columns that some material uses. It is read
    from the columns whenever a table is made (``.to`` and
    ``dataclasses.replace`` included), never in a surface fetch, so no
    fetch reads a device value back to decide which maps to sample."""

    albedo: Tensor  # (M,3)
    roughness: Tensor  # (M,)
    metallic: Tensor  # (M,)
    emissive: Tensor  # (M,3)
    albedo_tex: Optional[Tensor] = None  # (M,) int32 atlas texture index
    normal_tex: Optional[Tensor] = None  # (M,) int32 tangent-space normal map
    roughness_tex: Optional[Tensor] = None  # (M,) int32
    metallic_tex: Optional[Tensor] = None  # (M,) int32
    emissive_tex: Optional[Tensor] = None  # (M,) int32
    roughness_channel: Optional[Tensor] = None  # (M,) int32 texel channel
    metallic_channel: Optional[Tensor] = None  # (M,) int32
    maps: frozenset = dataclasses.field(init=False)  # the columns of MAP_COLUMNS in use

    def __post_init__(self):
        self.maps = frozenset(
            name for name in MAP_COLUMNS
            if getattr(self, name) is not None and bool((getattr(self, name) >= 0).any()))

    def to(self, device) -> "Material":
        return _to(self, device)


@dataclasses.dataclass
class SceneArrays:
    """The whole scene compiled to flat arrays: world-space triangle soup
    in BVH leaf order plus the preorder skip-link BVH, and the texture
    atlas the materials' maps index."""

    tri_pos: Tensor  # (T,3,3)
    tri_normal: Tensor  # (T,3,3) per-vertex shading normals
    tri_uv: Tensor  # (T,3,2)
    tri_mat: Tensor  # (T,) int32
    tri_mesh_id: Tensor  # (T,) int32
    materials: Material
    tri_tangent: Tensor  # (T,4) [tangent.xyz, bitangent sign]
    atlas: Optional["TextureAtlas"] = None  # scene/textures.py; None when untextured
    bvh_nodes_min: Optional[Tensor] = None  # (N,3)
    bvh_nodes_max: Optional[Tensor] = None  # (N,3)
    bvh_nodes_meta: Optional[Tensor] = None  # (N,3) int32 [first, count, skip]
    bvh_tri_order: Optional[Tensor] = None  # (T,) int32

    @property
    def num_triangles(self) -> int:
        return self.tri_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_pos.device

    def aabb(self):
        """(lo, hi) corners of the triangle soup's bounds, each (3,)."""
        flat = self.tri_pos.reshape(-1, 3)
        return flat.amin(dim=0), flat.amax(dim=0)

    def to(self, device) -> "SceneArrays":
        return _to(self, device)


@dataclasses.dataclass
class Hit:
    t: Tensor  # (...,) hit distance; t_max on a miss
    tri_id: Tensor  # (...,) int32, -1 on miss
    u: Tensor
    v: Tensor

    @property
    def valid(self) -> Tensor:
        return self.tri_id >= 0


@dataclasses.dataclass
class Surface:
    position: Tensor  # (..., 3)
    normal: Tensor  # (..., 3) shading normal, two-sided
    geo_normal: Tensor  # (..., 3)
    uv: Tensor  # (..., 2)
    albedo: Tensor  # (..., 3)
    roughness: Tensor
    metallic: Tensor
    emissive: Tensor  # (..., 3)
    mesh_id: Tensor  # int32
    mat_id: Tensor  # int32
    frontface: Tensor  # bool


@dataclasses.dataclass
class GBuffer:
    """Deferred G-buffer as named planes (reference g_buffer.h:34-37)."""

    albedo: Tensor  # (H, W, 3)
    metallic: Tensor  # (H, W)
    normal: Tensor  # (H, W, 3)
    motion: Tensor  # (H, W, 2) prev - curr uv
    roughness: Tensor  # (H, W)
    curvature: Tensor  # (H, W)
    mesh_id: Tensor  # (H, W) int32, -1 for sky
    linear_z: Tensor  # (H, W)
    depth: Tensor  # (H, W) ndc depth in [0,1], 1 = sky
    position: Tensor  # (H, W, 3) world position

    def map(self, fn) -> "GBuffer":
        return GBuffer(**{f.name: fn(getattr(self, f.name))
                          for f in dataclasses.fields(self)})
