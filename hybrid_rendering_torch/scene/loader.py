"""OBJ mesh loading: the native C++ parser first, a Python parser where the
library is missing, as ``hybrid_rendering_tpu/scene/loader.py`` does
(in place of dw::Mesh's Assimp path). Host numpy; the mesh goes into a
``SceneBuilder`` like any procedural one.

    mesh = load_obj("model.obj")
    b = SceneBuilder(); b.add_instance(mesh, b.add_material(MaterialDef()))

``native.obj_parser_name()`` says which parser runs.
"""
from __future__ import annotations

import numpy as np

from hybrid_rendering_torch.scene import native
from hybrid_rendering_torch.scene.primitives import Mesh


def _load_obj_python(path: str) -> Mesh:
    """v / vn / vt / f lines; faces fanned into triangles; negative
    indices count back from the last element; a missing position, uv or
    normal index gives (0,0,0), (0,0) or (0,1,0)."""
    positions, normals, uvs = [], [], []
    out_pos, out_nrm, out_uv, out_idx = [], [], [], []
    cache = {}

    def corner(spec: str) -> int:
        if spec in cache:
            return cache[spec]
        parts = spec.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        if vi < 0:
            vi = len(positions) + vi + 1
        if ti < 0:
            ti = len(uvs) + ti + 1
        if ni < 0:
            ni = len(normals) + ni + 1
        idx = len(out_pos)
        out_pos.append(positions[vi - 1] if 1 <= vi <= len(positions) else [0, 0, 0])
        out_nrm.append(normals[ni - 1] if 1 <= ni <= len(normals) else [0, 1, 0])
        out_uv.append(uvs[ti - 1] if 1 <= ti <= len(uvs) else [0, 0])
        cache[spec] = idx
        return idx

    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v" and len(t) >= 4:
                positions.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "vn" and len(t) >= 4:
                normals.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "vt" and len(t) >= 3:
                uvs.append([float(t[1]), float(t[2])])
            elif t[0] == "f" and len(t) >= 4:
                corners = [corner(s) for s in t[1:]]
                for i in range(2, len(corners)):
                    out_idx.append([corners[0], corners[i - 1], corners[i]])

    mesh = Mesh(positions=np.asarray(out_pos, np.float32),
                normals=np.asarray(out_nrm, np.float32),
                uvs=np.asarray(out_uv, np.float32),
                indices=np.asarray(out_idx, np.int32))
    return _fix_normals(mesh)


def _fix_normals(mesh: Mesh) -> Mesh:
    """Area-weighted vertex normals where the file had none (all zero, or
    all the (0,1,0) default)."""
    if np.abs(mesh.normals).sum() > 1e-6 and not np.allclose(mesh.normals, [[0, 1, 0]]):
        return mesh
    n = np.zeros_like(mesh.positions)
    tri = mesh.positions[mesh.indices]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for k in range(3):
        np.add.at(n, mesh.indices[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 1e-12, n / np.maximum(norm, 1e-12), [[0.0, 1.0, 0.0]])
    return Mesh(mesh.positions, n.astype(np.float32), mesh.uvs, mesh.indices)


def load_obj(path: str) -> Mesh:
    """Load an OBJ mesh (the native parser when the library builds)."""
    out = native.load_obj_native(path)
    if out is not None:
        return _fix_normals(Mesh(*out))
    return _load_obj_python(path)
