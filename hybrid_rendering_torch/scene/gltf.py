"""Minimal glTF 2.0 (.glb / .gltf) scene loader, a port of
``hybrid_rendering_tpu/scene/gltf.py`` (in place of dw::Mesh's Assimp
path). Host Python (json + struct + numpy): triangle primitives with
POSITION / NORMAL / TEXCOORD_0 and indices from GLB, embedded ``data:`` or
file buffers; node matrices and TRS flattened to world space; PBR
metallic-roughness materials with their base colour, normal,
metallic-roughness (G = roughness, B = metallic) and emissive PNG
textures, decoded by ``utils/image.read_png`` into the scene's atlas.

    scene = load_gltf_scene("model.glb")   # SceneArrays on the CPU
"""
from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, Optional

import numpy as np

from hybrid_rendering_torch.scene.build import MaterialDef, SceneBuilder
from hybrid_rendering_torch.scene.loader import _fix_normals
from hybrid_rendering_torch.scene.primitives import Mesh
from hybrid_rendering_torch.utils.image import read_png

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}
_PNG = b"\x89PNG\r\n\x1a\n"


def _parse_glb(data: bytes):
    """GLB container -> (the JSON document, [BIN chunks])."""
    magic, _version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    offset = 12
    gltf = None
    chunks = []
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8:offset + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # JSON
            gltf = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # BIN
            chunks.append(chunk)
        offset += 8 + chunk_len + (-chunk_len % 4)
    return gltf, chunks


def _load_buffers(gltf, bin_chunks, base_dir):
    bufs = []
    for b in gltf.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            bufs.append(bin_chunks[0])
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _accessor(gltf, bufs, idx) -> np.ndarray:
    """Accessor `idx` as a (count, components) array of its component type."""
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    buf = bufs[view.get("buffer", 0)]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize
    stride = view.get("byteStride") or (itemsize * ncomp)
    if stride == itemsize * ncomp:
        return np.frombuffer(buf, dtype, count * ncomp, start).reshape(count, ncomp)
    out = np.empty((count, ncomp), dtype)
    for i in range(count):
        out[i] = np.frombuffer(buf, dtype, ncomp, start + i * stride)
    return out


def _node_matrix(node) -> np.ndarray:
    """A node's local 4x4: its column-major `matrix`, else T @ R @ S."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]).astype(np.float32) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.eye(4, dtype=np.float32)
        r[:3, :3] = [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
        m = r @ m
    if "translation" in node:
        tmat = np.eye(4, dtype=np.float32)
        tmat[:3, 3] = node["translation"]
        m = tmat @ m
    return m


def load_gltf_scene(path: str, use_bvh: bool = True):
    """Load a .glb/.gltf file into ``SceneArrays`` (world-space soup,
    materials and atlas) on the CPU."""
    base_dir = os.path.dirname(path)
    if path.endswith(".glb"):
        with open(path, "rb") as f:
            gltf, bin_chunks = _parse_glb(f.read())
    else:
        with open(path) as f:
            gltf = json.load(f)
        bin_chunks = []
    bufs = _load_buffers(gltf, bin_chunks, base_dir)

    builder = SceneBuilder()
    mat_map: Dict[int, int] = {}
    tex_map: Dict[int, int] = {}

    def texture(tex_index: Optional[int]) -> int:
        """glTF texture -> atlas index; -1 for none, for an image that is
        not a PNG, or for one that fails to load (as the JAX loader)."""
        if tex_index is None:
            return -1
        if tex_index in tex_map:
            return tex_map[tex_index]
        out = -1
        try:
            img = gltf["images"][gltf["textures"][tex_index]["source"]]
            blob = None
            if "bufferView" in img:
                view = gltf["bufferViews"][img["bufferView"]]
                start = view.get("byteOffset", 0)
                blob = bufs[view.get("buffer", 0)][start:start + view["byteLength"]]
            elif "uri" in img and not img["uri"].startswith("data:"):
                with open(os.path.join(base_dir, img["uri"]), "rb") as f:
                    blob = f.read()
            if blob is not None and blob[:8] == _PNG:
                out = builder.add_texture(read_png(blob))
        except Exception:
            out = -1
        tex_map[tex_index] = out
        return out

    def material(mi: Optional[int]) -> int:
        key = -1 if mi is None else mi
        if key in mat_map:
            return mat_map[key]
        if mi is None:
            mdef = MaterialDef()
        else:
            m = gltf["materials"][mi]
            pbr = m.get("pbrMetallicRoughness", {})
            base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
            base_tex = pbr.get("baseColorTexture", {}).get("index")
            # metallicRoughness: roughness in G, metallic in B (glTF 2.0)
            mr_tex = texture(pbr.get("metallicRoughnessTexture", {}).get("index"))
            mdef = MaterialDef(
                albedo=tuple(base[:3]),
                roughness=float(pbr.get("roughnessFactor", 1.0)),
                metallic=float(pbr.get("metallicFactor", 1.0)),
                emissive=tuple(m.get("emissiveFactor", [0.0, 0.0, 0.0])),
                albedo_tex=texture(base_tex),
                normal_tex=texture(m.get("normalTexture", {}).get("index")),
                roughness_tex=mr_tex,
                metallic_tex=mr_tex,
                emissive_tex=texture(m.get("emissiveTexture", {}).get("index")),
                roughness_channel=1,
                metallic_channel=2,
            )
        mat_map[key] = builder.add_material(mdef)
        return mat_map[key]

    def emit_mesh(mesh_idx: int, world: np.ndarray):
        for prim in gltf["meshes"][mesh_idx]["primitives"]:
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = _accessor(gltf, bufs, attrs["POSITION"]).astype(np.float32)
            nrm = (_accessor(gltf, bufs, attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else np.zeros_like(pos))
            uv = (_accessor(gltf, bufs, attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else np.zeros((pos.shape[0], 2), np.float32))
            if "indices" in prim:
                idx = _accessor(gltf, bufs, prim["indices"]).astype(np.int32).reshape(-1, 3)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int32).reshape(-1, 3)
            mesh = Mesh(pos, nrm, uv, idx)
            if np.abs(nrm).sum() < 1e-6:
                mesh = _fix_normals(mesh)
            builder.add_instance(mesh, material(prim.get("material")), world)

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], world)
        for child in node.get("children", []):
            walk(child, world)

    for root in gltf["scenes"][gltf.get("scene", 0)].get("nodes", []):
        walk(root, np.eye(4, dtype=np.float32))
    return builder.build(use_bvh=use_bvh)
