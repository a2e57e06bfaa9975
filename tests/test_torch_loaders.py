"""The port's OBJ and glTF loaders against the JAX package on the CPU: the
Python OBJ parser, the native parser, ``load_obj``, and glTF files written
here (GLB with embedded PNG textures, a node hierarchy of matrices and
TRS, uint8/uint16/uint32 indices, a primitive without normals, an
interleaved buffer view; .gltf with a file buffer and with a ``data:``
buffer) loaded by both packages and compared array by array. Host numpy
on both sides, so every comparison is exact."""
import base64
import io
import json
import struct

import numpy as np
import pytest

from hybrid_rendering_tpu.scene import gltf as jgltf
from hybrid_rendering_tpu.scene import loader as jloader
from hybrid_rendering_tpu.scene import native as jnative
from hybrid_rendering_torch.scene import gltf as tgltf
from hybrid_rendering_torch.scene import loader as tloader
from hybrid_rendering_torch.scene import native as tnative
from hybrid_rendering_torch.utils import image as timage
from test_torch_textures import _assert_scenes_equal

OBJ_SAMPLES = {
    # tests/test_native_loader.py's sample: a quad and a triangle, mixed formats
    "mixed": """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 2 0 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
f 2/2/1 5//1 3/3/1
""",
    # negative (relative) indices, a pentagon fanned into three triangles
    "negative": """
v 0 0 0
v 1 0 0
v 1.5 1 0
v 0.5 1.8 0
v -0.5 1 0
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
vn 0 0.6 0.8
f -5/-3/-2 -4/-2/-2 -3/-1/-1 -2/-1/-1 -1/-3/-2
""",
    # faces without normals or uvs: the loaders compute area-weighted normals
    "no_normals": """
v 0 0 0
v 1 0 0
v 1 0 1
v 0 0 1
v 0.5 1 0.5
f 1 2 5
f 2 3 5
f 3 4 5
f 4 1 5
f 1 4 3 2
""",
}


@pytest.fixture(params=sorted(OBJ_SAMPLES))
def obj_file(request, tmp_path):
    path = tmp_path / f"{request.param}.obj"
    path.write_text(OBJ_SAMPLES[request.param])
    return str(path)


def _mesh_arrays(mesh):
    return mesh.positions, mesh.normals, mesh.uvs, mesh.indices


def test_python_obj_parser_matches_jax(obj_file):
    got = _mesh_arrays(tloader._load_obj_python(obj_file))
    ref = _mesh_arrays(jloader._load_obj_python(obj_file))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert np.isfinite(got[1]).all() and got[3].shape[0] >= 3


def test_native_obj_parser_matches_python_and_jax(obj_file):
    """The native parser through the port's binding: the same arrays as the
    JAX package's binding, and the same triangle soup as the Python parser
    (vertex order may differ)."""
    out = tnative.load_obj_native(obj_file)
    assert out is not None, "the native library did not build"
    for g, r in zip(out, jnative.load_obj_native(obj_file)):
        np.testing.assert_array_equal(g, r)
    ref = tloader._load_obj_python(obj_file)
    pos, _, _, idx = out
    assert idx.shape == ref.indices.shape
    np.testing.assert_allclose(np.sort(pos[idx].reshape(-1, 9), axis=0),
                               np.sort(ref.positions[ref.indices].reshape(-1, 9), axis=0),
                               atol=1e-6)
    assert tnative.obj_parser_name().startswith("native")


def test_load_obj_matches_jax(obj_file):
    for g, r in zip(_mesh_arrays(tloader.load_obj(obj_file)),
                    _mesh_arrays(jloader.load_obj(obj_file))):
        np.testing.assert_array_equal(g, r)


def test_load_obj_falls_back_to_python(obj_file, monkeypatch):
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert tnative.obj_parser_name().startswith("python")
    for g, r in zip(_mesh_arrays(tloader.load_obj(obj_file)),
                    _mesh_arrays(tloader._load_obj_python(obj_file))):
        np.testing.assert_array_equal(g, r)


# ---------------------------------------------------------------------------
# glTF
# ---------------------------------------------------------------------------


def _png(img):
    buf = io.BytesIO()
    timage.write_png(buf, img)
    return buf.getvalue()


class _Gltf:
    """Writes a glTF document and its one binary buffer."""

    def __init__(self):
        self.blob = bytearray()
        self.doc = {"asset": {"version": "2.0"}, "bufferViews": [], "accessors": []}

    def view(self, data: bytes, stride=None) -> int:
        self.blob += b"\x00" * (-len(self.blob) % 4)
        v = {"buffer": 0, "byteOffset": len(self.blob), "byteLength": len(data)}
        if stride:
            v["byteStride"] = stride
        self.blob += data
        self.doc["bufferViews"].append(v)
        return len(self.doc["bufferViews"]) - 1

    def accessor(self, arr, kind, view=None, offset=0, count=None) -> int:
        ctype = {np.dtype(np.float32): 5126, np.dtype(np.uint8): 5121,
                 np.dtype(np.uint16): 5123, np.dtype(np.uint32): 5125}[arr.dtype]
        a = {"bufferView": self.view(arr.tobytes()) if view is None else view,
             "componentType": ctype, "count": len(arr) if count is None else count,
             "type": kind}
        if offset:
            a["byteOffset"] = offset
        self.doc["accessors"].append(a)
        return len(self.doc["accessors"]) - 1


def _scene_doc(rs):
    """Three meshes under a node hierarchy: a grid of quads with uint16
    indices and normals; a pyramid with uint8 indices and no normals; a
    strip with uint32 indices whose positions and uvs interleave in one
    strided view. Four PNG textures (base colour, normal,
    metallic-roughness, emissive) in buffer views."""
    g = _Gltf()
    n = 4
    xs, zs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
    pos = np.stack([xs, rs.uniform(-0.05, 0.05, xs.shape), zs], -1).reshape(-1, 3)
    quads = [(r * n + c, (r + 1) * n + c, (r + 1) * n + c + 1, r * n + c + 1)
             for r in range(n - 1) for c in range(n - 1)]
    grid_idx = np.asarray([[a, b, c, a, c, d] for a, b, c, d in quads], np.uint16).ravel()
    grid = {"attributes": {
        "POSITION": g.accessor(pos.astype(np.float32), "VEC3"),
        "NORMAL": g.accessor(np.tile(np.float32([[0, 1, 0]]), (n * n, 1)), "VEC3"),
        "TEXCOORD_0": g.accessor(((pos[:, [0, 2]] + 1) * 1.5).astype(np.float32), "VEC2")},
        "indices": g.accessor(grid_idx, "SCALAR"), "material": 0}
    pyr_pos = np.float32([[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1], [0.5, 0.8, 0.5]])
    pyr_idx = np.uint8([0, 1, 4, 1, 2, 4, 2, 3, 4, 3, 0, 4])
    pyramid = {"attributes": {"POSITION": g.accessor(pyr_pos, "VEC3")},
               "indices": g.accessor(pyr_idx, "SCALAR"), "material": 1}
    strip_pos = rs.uniform(-1, 1, size=(6, 3)).astype(np.float32)
    strip_uv = rs.uniform(0, 2, size=(6, 2)).astype(np.float32)
    inter = np.concatenate([strip_pos, strip_uv], 1).astype(np.float32)  # 20-byte rows
    iv = g.view(inter.tobytes(), stride=20)
    strip = {"attributes": {
        "POSITION": g.accessor(strip_pos, "VEC3", view=iv),
        "NORMAL": g.accessor(np.tile(np.float32([[0, 0, 1]]), (6, 1)), "VEC3"),
        "TEXCOORD_0": g.accessor(strip_uv, "VEC2", view=iv, offset=12)},
        "indices": g.accessor(np.uint32([0, 1, 2, 2, 1, 3, 2, 3, 4, 4, 3, 5]), "SCALAR")}
    images = [rs.uniform(size=(8, 8, 3)), rs.uniform(size=(4, 6, 3)),
              rs.uniform(size=(16, 4, 3)), rs.uniform(size=(2, 2, 3))]
    g.doc["images"] = [{"bufferView": g.view(_png(im.astype(np.float32))),
                        "mimeType": "image/png"} for im in images]
    g.doc["textures"] = [{"source": i} for i in range(4)]
    g.doc["materials"] = [
        {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.7, 0.5, 1.0],
                                  "baseColorTexture": {"index": 0},
                                  "metallicRoughnessTexture": {"index": 2},
                                  "roughnessFactor": 0.8, "metallicFactor": 0.3},
         "normalTexture": {"index": 1}},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.4, 0.9, 1.0]},
         "emissiveTexture": {"index": 3}, "emissiveFactor": [1.0, 0.5, 0.25]}]
    g.doc["meshes"] = [{"primitives": [grid]}, {"primitives": [pyramid]},
                       {"primitives": [strip, {**strip, "mode": 1}]}]
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    m[:3, 3] = [0.5, 0.0, -1.0]
    g.doc["nodes"] = [
        {"mesh": 0, "children": [1, 2], "scale": [2.0, 2.0, 2.0], "translation": [0, -0.2, 0]},
        {"mesh": 1, "rotation": [0.0, 0.3826834, 0.0, 0.9238795], "translation": [0.3, 0, 0.2]},
        {"children": [3], "matrix": m.T.ravel().tolist()},
        {"mesh": 2, "translation": [0, 0.5, 0]}]
    g.doc["scenes"] = [{"nodes": [0]}]
    g.doc["scene"] = 0
    return g


def _write(kind, tmp_path):
    g = _scene_doc(np.random.RandomState(5))
    blob = bytes(g.blob) + b"\x00" * (-len(g.blob) % 4)
    if kind == "glb":
        g.doc["buffers"] = [{"byteLength": len(blob)}]
        js = json.dumps(g.doc).encode()
        js += b" " * (-len(js) % 4)
        path = tmp_path / "scene.glb"
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob)))
            f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)
        return str(path)
    if kind == "gltf_file":
        (tmp_path / "scene.bin").write_bytes(blob)
        g.doc["buffers"] = [{"byteLength": len(blob), "uri": "scene.bin"}]
    else:
        g.doc["buffers"] = [{"byteLength": len(blob), "uri": "data:application/octet-stream;"
                             "base64," + base64.b64encode(blob).decode()}]
    path = tmp_path / "scene.gltf"
    path.write_text(json.dumps(g.doc))
    return str(path)


@pytest.mark.parametrize("kind", ["glb", "gltf_file", "gltf_data_uri"])
def test_gltf_scene_matches_jax_array_for_array(kind, tmp_path):
    path = _write(kind, tmp_path)
    jscene = jgltf.load_gltf_scene(path, use_bvh=True)
    tscene = tgltf.load_gltf_scene(path, use_bvh=True)
    _assert_scenes_equal(tscene, jscene)
    # 18 grid + 4 pyramid + 4 strip triangles; the line primitive is skipped
    assert tscene.num_triangles == 26 and tscene.atlas.num_textures == 4
    assert tscene.materials.maps == frozenset(
        {"albedo_tex", "normal_tex", "roughness_tex", "metallic_tex", "emissive_tex"})
    # the pyramid had no normals: computed ones are unit length
    nrm = tscene.tri_normal.numpy()[tscene.tri_mat.numpy() == 1]
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=-1), 1.0, atol=1e-5)


def test_glb_roundtrip(tmp_path):
    """tests/test_gltf.py on the port: a translated red metallic quad."""
    from test_gltf import _make_glb

    p = str(tmp_path / "quad.glb")
    _make_glb(p)
    scene = tgltf.load_gltf_scene(p, use_bvh=True)
    assert scene.num_triangles == 2
    pos = scene.tri_pos.numpy().reshape(-1, 3)
    assert pos[:, 0].min() >= 2.0 - 1e-5 and pos[:, 0].max() <= 3.0 + 1e-5
    np.testing.assert_allclose(scene.materials.albedo[0].numpy(), [0.8, 0.1, 0.1], atol=1e-6)
    assert abs(float(scene.materials.roughness[0]) - 0.3) < 1e-6
    assert abs(float(scene.materials.metallic[0]) - 0.9) < 1e-6
    assert scene.bvh_nodes_min is not None and scene.atlas is None
