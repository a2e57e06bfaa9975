"""Scene builder: instanced meshes + materials + textures -> flat arrays.

A frozen copy of the port's ``scene/build.py``: the scene compiles once on
the host (numpy) to a world-space triangle soup with per-triangle material /
mesh-id arrays, a BVH and a texture atlas, permuted into BVH leaf order.
The BVH is the numpy binned-SAH build of ``ops/bvh.py`` (the port
builds its own tree natively). The result lives on the
CPU; ``SceneArrays.to(device)`` moves it to the card.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from hrref.scene.primitives import Mesh
from hrref.scene.textures import AtlasBuilder
from hrref.types import Material, SceneArrays


@dataclasses.dataclass
class MaterialDef:
    """Material row mirroring the reference's material SSBO with its map
    indices and roughness/metallic channel selectors
    (scene_descriptor_set.glsl:20-24, 180-228). A texture index is an
    ``add_texture`` result, -1 for none; the albedo and emissive maps
    multiply their factors (glTF semantics)."""

    albedo: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    roughness: float = 0.5
    metallic: float = 0.0
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    albedo_tex: int = -1
    normal_tex: int = -1
    roughness_tex: int = -1
    metallic_tex: int = -1
    emissive_tex: int = -1
    roughness_channel: int = 1
    metallic_channel: int = 2


def _triangle_tangents(tp: np.ndarray, tuv: np.ndarray) -> np.ndarray:
    """Per-triangle tangent + bitangent handedness from the UV
    parameterization: (F,3,3) positions + (F,3,2) uvs -> (F,4)."""
    e1 = tp[:, 1] - tp[:, 0]
    e2 = tp[:, 2] - tp[:, 0]
    d1 = tuv[:, 1] - tuv[:, 0]
    d2 = tuv[:, 2] - tuv[:, 0]
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    ok = np.abs(det) > 1e-12
    r = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    t = r * (d2[:, 1:2] * e1 - d1[:, 1:2] * e2)
    b = r * (d1[:, 0:1] * e2 - d2[:, 0:1] * e1)
    n = np.cross(e1, e2)
    fallback = np.cross(n, np.where(
        np.abs(n[:, 1:2]) < 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]]))
    t = np.where(ok[:, None] & (np.linalg.norm(t, axis=1, keepdims=True)
                                > 1e-12), t, fallback)
    t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-12)
    sign = np.where(np.sum(np.cross(n, t) * b, axis=1) < 0.0, -1.0, 1.0)
    return np.concatenate([t, sign[:, None]], axis=1).astype(np.float32)


def translation(x, y, z) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, z]
    return m


def scaling(sx, sy=None, sz=None) -> np.ndarray:
    sy = sx if sy is None else sy
    sz = sx if sz is None else sz
    return np.diag([sx, sy, sz, 1.0]).astype(np.float32)


def rotation_y(angle_rad) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotation_x(angle_rad) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


class SceneBuilder:
    def __init__(self):
        self._tri_pos: List[np.ndarray] = []
        self._tri_nrm: List[np.ndarray] = []
        self._tri_uv: List[np.ndarray] = []
        self._tri_tan: List[np.ndarray] = []
        self._tri_mat: List[np.ndarray] = []
        self._tri_mesh: List[np.ndarray] = []
        self._materials: List[MaterialDef] = []
        self._next_mesh_id = 0
        self._atlas = AtlasBuilder()

    def add_texture(self, img) -> int:
        """Register a texture image; returns the index a MaterialDef's
        ``*_tex`` field takes."""
        return self._atlas.add(img)

    def add_material(self, mat: MaterialDef) -> int:
        self._materials.append(mat)
        return len(self._materials) - 1

    def add_instance(self, mesh: Mesh, material: int,
                     transform: Optional[np.ndarray] = None) -> int:
        """Instance a mesh with an affine transform; returns its mesh_id."""
        m = (np.eye(4, dtype=np.float32) if transform is None
             else np.asarray(transform, np.float32))
        pos_h = np.concatenate(
            [mesh.positions, np.ones_like(mesh.positions[:, :1])], axis=1)
        world_pos = (pos_h @ m.T)[:, :3]
        normal_mat = np.linalg.inv(m[:3, :3]).T
        world_nrm = mesh.normals @ normal_mat.T
        world_nrm /= np.maximum(
            np.linalg.norm(world_nrm, axis=1, keepdims=True), 1e-8)

        idx = mesh.indices
        # a mirroring transform reverses winding; swap two indices so the
        # geometric normal keeps facing the shading normals
        if np.linalg.det(m[:3, :3]) < 0.0:
            idx = idx[:, ::-1]
        self._tri_pos.append(world_pos[idx])
        self._tri_nrm.append(world_nrm[idx])
        self._tri_uv.append(mesh.uvs[idx])
        self._tri_tan.append(_triangle_tangents(world_pos[idx], mesh.uvs[idx]))
        f = idx.shape[0]
        self._tri_mat.append(np.full((f,), material, np.int32))
        self._tri_mesh.append(np.full((f,), self._next_mesh_id, np.int32))
        mesh_id = self._next_mesh_id
        self._next_mesh_id += 1
        return mesh_id

    def build(self, use_bvh: bool = True) -> SceneArrays:
        tri_pos = np.concatenate(self._tri_pos, axis=0).astype(np.float32)
        tri_nrm = np.concatenate(self._tri_nrm, axis=0).astype(np.float32)
        tri_uv = np.concatenate(self._tri_uv, axis=0).astype(np.float32)
        tri_mat = np.concatenate(self._tri_mat, axis=0)
        tri_mesh = np.concatenate(self._tri_mesh, axis=0)
        tri_tan = np.concatenate(self._tri_tan, axis=0).astype(np.float32)

        def col(name):
            return torch.as_tensor(np.asarray(
                [getattr(m, name) for m in self._materials], np.float32))

        def icol(name):
            return torch.as_tensor(np.asarray(
                [getattr(m, name) for m in self._materials], np.int32))

        mats = Material(albedo=col("albedo"), roughness=col("roughness"),
                        metallic=col("metallic"), emissive=col("emissive"),
                        **{name: icol(name) for name in (
                            "albedo_tex", "normal_tex", "roughness_tex", "metallic_tex",
                            "emissive_tex", "roughness_channel", "metallic_channel")})

        bvh_kw = {}
        if use_bvh:
            # the numpy binned-SAH build: a tree of the reference's own
            from hrref.ops import bvh as bvh_mod

            built = bvh_mod.build_bvh(tri_pos)
            nodes_min, nodes_max, nodes_meta, order = built
            # permute triangles into BVH leaf order (leaves index
            # contiguous ranges)
            tri_pos, tri_nrm, tri_uv = tri_pos[order], tri_nrm[order], tri_uv[order]
            tri_tan, tri_mat, tri_mesh = tri_tan[order], tri_mat[order], tri_mesh[order]
            bvh_kw = dict(
                bvh_nodes_min=torch.as_tensor(np.ascontiguousarray(nodes_min)),
                bvh_nodes_max=torch.as_tensor(np.ascontiguousarray(nodes_max)),
                bvh_nodes_meta=torch.as_tensor(np.ascontiguousarray(nodes_meta)),
                bvh_tri_order=torch.as_tensor(np.ascontiguousarray(order)),
            )

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a))

        return SceneArrays(
            tri_pos=t(tri_pos), tri_normal=t(tri_nrm), tri_uv=t(tri_uv),
            tri_mat=t(tri_mat), tri_mesh_id=t(tri_mesh), materials=mats,
            tri_tangent=t(tri_tan), atlas=self._atlas.build(), **bvh_kw,
        )
