"""The port's textures and material maps against the JAX package on the CPU:
the atlas packing, ``sample_atlas``, the textured scene build, the bridge,
``apply_material_maps`` through both surface fetches, the assertions of
``tests/test_textures.py`` and ``tests/test_materials.py`` on the port, and
two frames of a textured scene through both renderers. Inputs come from
seeded numpy; each test states its tolerance."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rendering_tpu import config as jcfg
from hybrid_rendering_tpu.models import renderer as jrenderer
from hybrid_rendering_tpu.ops import sh as jsh
from hybrid_rendering_tpu.ops import sky as jsky
from hybrid_rendering_tpu.scene import build as jbuild
from hybrid_rendering_tpu.scene import fetch as jfetch
from hybrid_rendering_tpu.scene import primitives as jprim
from hybrid_rendering_tpu.scene import textures as jtex
from hybrid_rendering_tpu.types import Hit as JHit
from hybrid_rendering_tpu.types import Light as JLight
from hybrid_rendering_torch import bridge
from hybrid_rendering_torch import config as tcfg
from hybrid_rendering_torch.models import renderer as trenderer
from hybrid_rendering_torch.ops import bvh as tbvh
from hybrid_rendering_torch.ops import sh as tsh
from hybrid_rendering_torch.ops import sky as tsky
from hybrid_rendering_torch.scene import build as tbuild
from hybrid_rendering_torch.scene import fetch as tfetch
from hybrid_rendering_torch.scene import primitives as tprim
from hybrid_rendering_torch.scene import textures as ttex
from hybrid_rendering_torch.utils import image as timage
from test_torch_reflections import jax_attr_surface_tracer
from test_torch_slice import GBUFFER_TOL, SHADED_TOL, TAA_MAX, TAA_TOL, _share_outside

# sample_atlas: the same gather and the same left-to-right bilinear sum on
# both sides; 1e-6 allows an ulp of the weights at texel values up to 1
SAMPLE_ATOL = 1e-6
# a surface field: the maps' arithmetic is elementwise in the same order
# on both sides (the shading normal's normalizations sum left to right in
# the port, XLA's reduce over 3 does too on the CPU)
SURFACE_ATOL = 2e-6
W, H = 32, 24
SURFACE_FIELDS = ("albedo", "normal", "roughness", "metallic", "emissive")


def _images(seed=0):
    """Textures of every kind AtlasBuilder takes: a 2-D gray image, RGB
    and RGBA, of several heights, one wider than 256 texels."""
    rs = np.random.RandomState(seed)
    return [rs.uniform(size=(12, 20)).astype(np.float32),
            rs.uniform(size=(32, 32, 3)).astype(np.float32),
            rs.uniform(size=(16, 48, 4)).astype(np.float32),
            rs.uniform(size=(5, 300, 3)).astype(np.float32),
            rs.uniform(size=(32, 7, 3)).astype(np.float32),
            rs.uniform(size=(9, 9)).astype(np.float32)]


def _normal_map(rs, n=16):
    """Tangent-space normals tilted up to ~40 degrees, encoded to [0, 1]."""
    xy = rs.uniform(-0.6, 0.6, size=(n, n, 2))
    z = np.sqrt(np.maximum(1.0 - (xy ** 2).sum(-1, keepdims=True), 0.1))
    nrm = np.concatenate([xy, z], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return (nrm * 0.5 + 0.5).astype(np.float32)


def textured_scene(build, prim, seed=0, use_bvh=True):
    """A small scene using every map: a checkered, normal-mapped ground; a
    box with a metallic-roughness map (G, B) whose roughness texels are 0
    on a quarter of the texture (the 0.1 floor); a standing panel with an
    emissive map and a gray albedo map; a sphere reading roughness from R
    and metallic from A; an untextured box. `build`/`prim`: either
    package's scene/build.py and primitives.py."""
    rs = np.random.RandomState(seed)
    b = build.SceneBuilder()
    checker = b.add_texture(jtex.checkerboard(64, a=(0.9, 0.8, 0.7), b=(0.1, 0.2, 0.3), cells=8))
    nm = b.add_texture(_normal_map(rs))
    mr = rs.uniform(size=(32, 32, 3)).astype(np.float32)
    mr[:16, :16, 1] = 0.0
    mr = b.add_texture(mr)
    em = b.add_texture(rs.uniform(size=(8, 8, 3)).astype(np.float32))
    gray = b.add_texture(rs.uniform(0.3, 1.0, size=(12, 20)).astype(np.float32))
    rgba = b.add_texture(rs.uniform(size=(16, 24, 4)).astype(np.float32))
    M = build.MaterialDef
    ground = b.add_material(M(albedo=(1.0, 1.0, 1.0), roughness=0.6, albedo_tex=checker,
                              normal_tex=nm))
    shiny = b.add_material(M(albedo=(0.8, 0.3, 0.2), roughness=0.5, metallic=0.1,
                             roughness_tex=mr, metallic_tex=mr))
    glow = b.add_material(M(albedo=(0.9, 0.9, 0.9), emissive=(2.0, 1.5, 1.0), emissive_tex=em,
                            albedo_tex=gray))
    ball = b.add_material(M(albedo=(0.3, 0.6, 0.9), roughness=0.3, roughness_tex=rgba,
                            roughness_channel=0, metallic_tex=rgba, metallic_channel=3))
    plain = b.add_material(M(albedo=(0.5, 0.5, 0.5), roughness=0.8))
    b.add_instance(prim.plane(8.0, 8.0), ground)
    b.add_instance(prim.box(1.2, 1.2, 1.2), shiny, build.translation(-1.5, 0.6, 0.0))
    b.add_instance(prim.plane(2.0, 1.5), glow,
                   build.translation(1.0, 1.0, -2.0) @ build.rotation_x(np.pi / 2))
    b.add_instance(prim.uv_sphere(0.7, 8, 16), ball, build.translation(1.4, 0.7, 0.8))
    b.add_instance(prim.box(0.8, 0.8, 0.8), plain,
                   build.translation(0.0, 0.4, 1.8) @ build.rotation_y(0.6))
    return b.build(use_bvh=use_bvh)


def _rays(n, seed=1):
    """Rays from above the scene toward points on its objects."""
    rs = np.random.RandomState(seed)
    o = np.stack([rs.uniform(-4, 4, n), rs.uniform(2.5, 5.0, n), rs.uniform(-4, 4, n)], 1)
    target = np.stack([rs.uniform(-3, 3, n), rs.uniform(0.0, 1.5, n), rs.uniform(-3, 3, n)], 1)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
    jscene = textured_scene(jbuild, jprim)
    return jscene, bridge.scene_from_jax(jscene)


# ---------------------------------------------------------------------------
# the atlas
# ---------------------------------------------------------------------------


def test_atlas_builder_matches_jax_bit_for_bit():
    jb, tb = jtex.AtlasBuilder(), ttex.AtlasBuilder()
    for img in _images():
        assert jb.add(img) == tb.add(img)
    ja, ta = jb.build(), tb.build()
    assert ta.num_textures == ja.num_textures == 6
    np.testing.assert_array_equal(ta.image.numpy(), np.asarray(ja.image))
    np.testing.assert_array_equal(ta.rects.numpy(), np.asarray(ja.rects))
    assert ta.image.shape[1] == 512  # the 300-texel image: next power of two
    assert ttex.AtlasBuilder().build() is None


def test_sample_atlas_matches_jax():
    """uv in [-3, 3] with exact 0, 1, negative integers and texel centres
    of each rect, tex_idx -1 and a valid mask; the atlas is random, so a
    texel picked wrong by floor or remainder shows as a large error."""
    jb, tb = jtex.AtlasBuilder(), ttex.AtlasBuilder()
    for img in _images(3):
        jb.add(img)
        tb.add(img)
    ja, ta = jb.build(), tb.build()
    rs = np.random.RandomState(2)
    n = 4096
    uv = rs.uniform(-3, 3, size=(n, 2)).astype(np.float32)
    exact = np.asarray([0.0, 1.0, -1.0, 2.0, -3.0, 3.0, 0.5, -0.5], np.float32)
    uv[:64] = exact[rs.randint(0, len(exact), size=(64, 2))]
    idx = rs.randint(-1, 6, size=n).astype(np.int32)
    rects = np.asarray(ja.rects)
    # texel centres: u = (i + 0.5) / w of the sampled rect, shifted by whole turns
    k = np.arange(64, 512)
    r = rects[np.maximum(idx[k], 0)]
    uv[k, 0] = (rs.randint(0, 64, size=k.size) % r[:, 2] + 0.5) / r[:, 2] + rs.randint(-2, 2, k.size)
    uv[k, 1] = (rs.randint(0, 64, size=k.size) % r[:, 3] + 0.5) / r[:, 3] + rs.randint(-2, 2, k.size)
    valid = rs.uniform(size=n) > 0.1
    ref = np.asarray(jtex.sample_atlas(ja, jnp.asarray(idx), jnp.asarray(uv), jnp.asarray(valid)))
    got = ttex.sample_atlas(ta, torch.from_numpy(idx), torch.from_numpy(uv),
                            torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SAMPLE_ATOL)
    np.testing.assert_array_equal(got[(idx < 0) | ~valid], 1.0)
    ref_nv = np.asarray(jtex.sample_atlas(ja, jnp.asarray(idx), jnp.asarray(uv)))
    got_nv = ttex.sample_atlas(ta, torch.from_numpy(idx), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got_nv, ref_nv, rtol=0, atol=SAMPLE_ATOL)


def test_checkerboard_equals_jax():
    for args in ((64,), (32, (1, 0, 0), (0, 0, 1), 2), (48, (0.5, 0.5, 0.5), (0, 0, 0), 6)):
        np.testing.assert_array_equal(ttex.checkerboard(*args), jtex.checkerboard(*args))


# ---------------------------------------------------------------------------
# the scene and the bridge
# ---------------------------------------------------------------------------


def _assert_scenes_equal(t, j):
    for f in ("tri_pos", "tri_normal", "tri_uv", "tri_mat", "tri_mesh_id", "tri_tangent",
              "bvh_nodes_min", "bvh_nodes_max", "bvh_nodes_meta", "bvh_tri_order"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    for f in ("albedo", "roughness", "metallic", "emissive", "albedo_tex", "normal_tex",
              "roughness_tex", "metallic_tex", "emissive_tex", "roughness_channel",
              "metallic_channel"):
        np.testing.assert_array_equal(getattr(t.materials, f).numpy(),
                                      np.asarray(getattr(j.materials, f)), err_msg=f)
    np.testing.assert_array_equal(t.atlas.image.numpy(), np.asarray(j.atlas.image))
    np.testing.assert_array_equal(t.atlas.rects.numpy(), np.asarray(j.atlas.rects))


def test_textured_build_matches_jax_array_for_array(scenes):
    jscene, _ = scenes
    tscene = textured_scene(tbuild, tprim)
    _assert_scenes_equal(tscene, jscene)
    assert tscene.materials.maps == frozenset(
        {"albedo_tex", "normal_tex", "roughness_tex", "metallic_tex", "emissive_tex"})


def test_scene_from_jax_carries_the_atlas(scenes):
    jscene, tscene = scenes
    _assert_scenes_equal(tscene, jscene)
    assert tscene.materials.maps == textured_scene(tbuild, tprim).materials.maps
    moved = tscene.to(torch.device("cpu"))
    assert moved.atlas is not tscene.atlas and moved.materials.maps == tscene.materials.maps


# ---------------------------------------------------------------------------
# apply_material_maps through both surface fetches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def surfaces(scenes):
    """Port and JAX surfaces on the same hits: the hits and rows from the
    port's plain walk, through ``surface_from_attrs`` and through
    ``fetch_surface`` on each side."""
    jscene, tscene = scenes
    o, d = _rays(2048)
    ts = tbvh.make_trace_scene(tscene)
    hit, rows = tbvh.closest_hit_attrs_plain(ts, torch.from_numpy(o), torch.from_numpy(d),
                                             torch.full((o.shape[0],), 1e5))
    jhit = JHit(t=jnp.asarray(hit.t.numpy()), tri_id=jnp.asarray(hit.tri_id.numpy()),
                u=jnp.asarray(hit.u.numpy()), v=jnp.asarray(hit.v.numpy()))
    to, td, jo, jd = torch.from_numpy(o), torch.from_numpy(d), jnp.asarray(o), jnp.asarray(d)
    return hit, {
        "attrs": (tfetch.surface_from_attrs(tscene, to, td, hit, rows),
                  jfetch.surface_from_attrs(jscene, jo, jd, jhit, jnp.asarray(rows.numpy()))),
        "fetch": (tfetch.fetch_surface(tscene, to, td, hit),
                  jfetch.fetch_surface(jscene, jo, jd, jhit)),
    }


@pytest.mark.parametrize("field", SURFACE_FIELDS)
@pytest.mark.parametrize("path", ["attrs", "fetch"])
def test_material_maps_match_jax(surfaces, path, field):
    hit, by_path = surfaces
    got, ref = by_path[path]
    np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                               rtol=0, atol=SURFACE_ATOL)


def test_material_maps_cover_every_case(scenes, surfaces):
    """The rays reach every textured material, the 0.1 roughness floor and
    the R and A channel selectors, and the maps move each field."""
    _, tscene = scenes
    hit, by_path = surfaces
    surf = by_path["attrs"][0]
    valid = hit.valid.numpy()
    mat = surf.mat_id.numpy()
    assert valid.mean() > 0.8 and set(mat[valid]) == {0, 1, 2, 3, 4}
    rough = surf.roughness.numpy()
    assert (rough[valid & (mat == 1)] == np.float32(0.1)).sum() > 5  # the floor
    # the sphere reads roughness from R and metallic from A of its texture
    assert np.ptp(rough[valid & (mat == 3)]) > 0.3
    assert np.ptp(surf.metallic.numpy()[valid & (mat == 3)]) > 0.3
    plain = dataclasses.replace(tscene, atlas=None)
    base = tfetch.fetch_surface(plain, *map(torch.from_numpy, _rays(2048)), hit)
    for field in SURFACE_FIELDS:
        moved = np.abs(getattr(surf, field).numpy() - getattr(base, field).numpy())
        assert moved.max() > 0.05, field


# ---------------------------------------------------------------------------
# tests/test_textures.py and tests/test_materials.py, on the port
# ---------------------------------------------------------------------------


def test_atlas_pack_and_sample():
    b = ttex.AtlasBuilder()
    b.add(np.full((32, 32, 3), 0.25, np.float32))
    b.add(np.full((16, 48, 3), 0.75, np.float32))
    atlas = b.build()
    assert atlas.num_textures == 2
    uv = torch.tensor([[0.5, 0.5], [0.1, 0.9]])
    s0 = ttex.sample_atlas(atlas, torch.tensor([0, 0]), uv).numpy()
    np.testing.assert_allclose(s0[:, :3], 0.25, atol=1e-5)
    s1 = ttex.sample_atlas(atlas, torch.tensor([1, 1]), uv).numpy()
    np.testing.assert_allclose(s1[:, :3], 0.75, atol=1e-5)
    np.testing.assert_allclose(ttex.sample_atlas(atlas, torch.tensor([-1, -1]), uv).numpy(), 1.0)


def test_checker_uv_lookup():
    b = ttex.AtlasBuilder()
    ti = b.add(ttex.checkerboard(64, a=(1, 1, 1), b=(0, 0, 0), cells=2))
    atlas = b.build()
    uv = torch.tensor([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]])
    s = ttex.sample_atlas(atlas, torch.full((4,), ti, dtype=torch.int32), uv).numpy()[:, 0]
    assert abs(s[0] - s[3]) < 1e-5 and abs(s[1] - s[2]) < 1e-5
    assert abs(s[0] - s[1]) > 0.9


def _trace_plane(mdef_kwargs, textures, n_rays=2):
    """A 2x2 ground plane with the given maps, straight-down rays at two
    quadrant centres through the port's surface tracer; the Surface."""
    b = tbuild.SceneBuilder()
    tex_ids = {k: b.add_texture(img) for k, img in textures.items()}
    kw = {k: tex_ids[v] if isinstance(v, str) else v for k, v in mdef_kwargs.items()}
    b.add_instance(tprim.plane(2.0, 2.0), b.add_material(tbuild.MaterialDef(**kw)))
    closest_surface = tbvh.make_surface_tracer(b.build(use_bvh=True))
    o = torch.tensor([[-0.5, 1.0, -0.5], [0.5, 1.0, 0.5]])[:n_rays]
    d = torch.tensor([0.0, -1.0, 0.0]).expand(n_rays, 3)
    hit, surf = closest_surface(o, d, 10.0)
    assert bool(hit.valid.all())
    return surf


def test_textured_surface_fetch():
    b = tbuild.SceneBuilder()
    tex = b.add_texture(ttex.checkerboard(64, a=(1, 0, 0), b=(0, 0, 1), cells=2))
    b.add_instance(tprim.plane(2.0, 2.0),
                   b.add_material(tbuild.MaterialDef(albedo=(1.0, 1.0, 1.0), albedo_tex=tex)))
    scene = b.build(use_bvh=True)
    assert scene.atlas is not None
    o = torch.tensor([[-0.5, 1.0, -0.5], [0.5, 1.0, -0.5]])
    hit, surf = tbvh.make_surface_tracer(scene)(o, torch.tensor([0.0, -1.0, 0.0]).expand(2, 3),
                                                10.0)
    assert bool(hit.valid.all())
    alb = surf.albedo.numpy()
    assert abs(alb[0] - alb[1]).max() > 0.9
    assert set(np.argmax(alb, axis=1)) == {0, 2}


def test_triangle_tangents_orthonormal():
    tp = np.asarray([[[0, 0, 0], [2, 0, 0], [0, 0, 2]]], np.float32)
    tuv = np.asarray([[[0, 0], [1, 0], [0, 1]]], np.float32)
    t4 = tbuild._triangle_tangents(tp, tuv)
    assert t4.shape == (1, 4)
    np.testing.assert_allclose(t4[0, :3], [1, 0, 0], atol=1e-6)
    t4d = tbuild._triangle_tangents(tp, np.zeros_like(tuv))
    assert np.isfinite(t4d).all() and abs(np.linalg.norm(t4d[0, :3]) - 1.0) < 1e-5


def test_normal_map_perturbs_shading_normal():
    nm = np.zeros((8, 8, 3), np.float32)
    nm[..., 0] = 0.6 * 0.5 + 0.5
    nm[..., 1] = 0.5
    nm[..., 2] = 0.8 * 0.5 + 0.5
    n = _trace_plane({"normal_tex": "nm"}, {"nm": nm}).normal.numpy()
    n0 = _trace_plane({}, {"dummy": nm}).normal.numpy()
    np.testing.assert_allclose(n0, [[0, 1, 0]] * 2, atol=1e-4)
    assert np.all(np.abs(np.linalg.norm(n, axis=1) - 1.0) < 1e-4)
    assert np.all(n[:, 1] < 0.9) and np.all(np.abs(n[:, 0]) + np.abs(n[:, 2]) > 0.4)


def test_metallic_roughness_channel_selectors():
    mr = np.zeros((8, 8, 3), np.float32)
    mr[..., 1] = 0.7
    mr[..., 2] = 0.9
    surf = _trace_plane({"roughness": 0.2, "metallic": 0.0, "roughness_tex": "mr",
                         "metallic_tex": "mr", "roughness_channel": 1, "metallic_channel": 2},
                        {"mr": mr})
    np.testing.assert_allclose(surf.roughness.numpy(), 0.7, atol=0.02)
    np.testing.assert_allclose(surf.metallic.numpy(), 0.9, atol=0.02)


def test_roughness_floor():
    surf = _trace_plane({"roughness": 0.5, "roughness_tex": "mr", "roughness_channel": 1},
                        {"mr": np.zeros((8, 8, 3), np.float32)})
    np.testing.assert_allclose(surf.roughness.numpy(), 0.1, atol=1e-5)


def test_emissive_map_multiplies_factor():
    em = np.zeros((8, 8, 3), np.float32)
    em[..., 0] = 0.5
    e = _trace_plane({"emissive": (2.0, 2.0, 2.0), "emissive_tex": "em"}, {"em": em})
    e = e.emissive.numpy()
    np.testing.assert_allclose(e[:, 0], 1.0, atol=0.02)
    np.testing.assert_allclose(e[:, 1:], 0.0, atol=0.02)


def test_untextured_materials_unchanged():
    surf = _trace_plane({"albedo": (0.3, 0.4, 0.5), "roughness": 0.33, "metallic": 0.66},
                        {"pad": np.zeros((4, 4, 3), np.float32)})
    np.testing.assert_allclose(surf.albedo.numpy(), [[0.3, 0.4, 0.5]] * 2, atol=1e-5)
    np.testing.assert_allclose(surf.roughness.numpy(), 0.33, atol=1e-5)
    np.testing.assert_allclose(surf.metallic.numpy(), 0.66, atol=1e-5)


def test_gltf_material_maps_import(tmp_path):
    """tests/test_materials.py's glTF (a .gltf with a data: buffer and three
    PNG files) loaded by the port: the maps land in the right columns."""
    import base64

    from hybrid_rendering_torch.scene.gltf import load_gltf_scene

    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    uvc = np.asarray([[0, 0], [1, 0], [0, 1]], np.float32)
    blob = pos.tobytes() + uvc.tobytes() + np.asarray([0, 1, 2], np.uint16).tobytes()
    names = []
    for i, rgb in enumerate(((0.5, 0.5, 1.0), (0.0, 0.8, 0.6), (1.0, 0.5, 0.25))):
        img = np.zeros((4, 4, 3), np.float32)
        img[:] = rgb
        timage.write_png(str(tmp_path / f"t{i}.png"), img)
        names.append(f"t{i}.png")
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1],
                                                "metallicRoughnessTexture": {"index": 1}},
                       "normalTexture": {"index": 0}, "emissiveTexture": {"index": 2},
                       "emissiveFactor": [2.0, 2.0, 2.0]}],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "images": [{"uri": n} for n in names],
        "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 24},
                        {"buffer": 0, "byteOffset": 60, "byteLength": 6}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
                      {"bufferView": 1, "componentType": 5126, "count": 3, "type": "VEC2"},
                      {"bufferView": 2, "componentType": 5123, "count": 3, "type": "SCALAR"}],
    }
    path = str(tmp_path / "scene.gltf")
    with open(path, "w") as f:
        json.dump(gltf, f)
    mats = load_gltf_scene(path, use_bvh=False).materials
    assert int(mats.normal_tex[0]) >= 0 and int(mats.emissive_tex[0]) >= 0
    assert int(mats.roughness_tex[0]) >= 0 and int(mats.roughness_tex[0]) == int(mats.metallic_tex[0])
    assert int(mats.roughness_channel[0]) == 1 and int(mats.metallic_channel[0]) == 2


# ---------------------------------------------------------------------------
# the whole frame
# ---------------------------------------------------------------------------


# the frame tests' cameras roll 0.1 rad about their view axis
ROLLED_UP = (float(np.sin(0.1)), float(np.cos(0.1)), 0.0)


def rolled_cameras(jr, tr, eye, target, frame, jprev, tprev):
    """The JAX and port cameras of `frame`, as ``HybridRenderer.make_camera``
    makes them (TAA's Halton jitter) but rolled: a camera without roll sees
    a level face with exactly equal depths along each image row, and TAA's
    velocity dilation (the nearest of 3x3 depths by a strict '<', ROADMAP
    §3) then picks its motion vector by the last ulp of depth, which the
    two packages round apart (measured on these scenes without the roll:
    the TAA plane 3.5-34% of pixels beyond 1e-3, max 0.08-0.24, with every
    G-buffer plane within 2e-5 and TAA equal on equal inputs). Rolling the
    scene instead makes level normals non-axis-aligned, whose ulp noise
    flips the reflections' ``curvature == 0`` test (ROADMAP §3)."""
    from hybrid_rendering_tpu.models import taa as jtaa
    from hybrid_rendering_tpu.utils import camera as jcamera
    from hybrid_rendering_torch.models import taa as ttaa
    from hybrid_rendering_torch.utils import camera as tcamera

    cfg = tr.config
    kw = dict(eye=eye, target=target, width=cfg.width, height=cfg.height, up=ROLLED_UP)
    jc = jcamera.make_camera(**kw, jitter=jtaa.halton_jitter(frame, cfg.width, cfg.height),
                             prev_view_proj=jprev)
    tc = tcamera.make_camera(**kw, jitter=ttaa.halton_jitter(frame, cfg.width, cfg.height),
                             prev_view_proj=tprev)
    return jc, tc


def _config(m):
    """Reflections on, DDGI off: DDGI's probe rays reach their surfaces
    through the same tracer as the reflections' (their maps are held by
    test_material_maps_match_jax), and DDGI doubles the JAX side's compile
    (~52 s with it, ~30 s without, alone on the CPU);
    test_torch_dynamic.py's animated frame runs it."""
    return m.RendererConfig(
        width=W, height=H, debug_outputs=True,
        shadows=m.ShadowsConfig(scale=m.RayTraceScale.FULL),
        ao=m.AOConfig(scale=m.RayTraceScale.HALF),
        reflections=m.ReflectionsConfig(scale=m.RayTraceScale.HALF),
        ddgi=m.DDGIConfig(enabled=False),
        taa=m.TAAConfig(enabled=True))


def test_textured_frames_match_jax_renderer(scenes):
    """The textured scene at 32x24 with reflections (``_config``): two
    frames of a moving camera through the JAX renderer (jitted, its
    surfaces from the attribute rows as on its main path) and the port,
    plane by plane, with test_torch_slice.py's tolerances; the cameras are
    rolled (``rolled_cameras``)."""
    jscene, tscene = scenes
    light = JLight.directional((0.4, 0.85, 0.3), intensity=3.0)
    jsk = jsky.ProceduralSky.create(sun_direction=np.asarray(light.direction))
    tsk = tsky.ProceduralSky.create(sun_direction=np.asarray(light.direction))
    jr = jrenderer.HybridRenderer(jscene, _config(jcfg), jsk.radiance,
                                  *jsh.make_env_fallbacks(jsk.radiance))
    jr.closest_surface_fn = jax_attr_surface_tracer(jscene)
    tr = trenderer.HybridRenderer(tscene, _config(tcfg), tsk.radiance,
                                  *tsh.make_env_fallbacks(tsk.radiance), device="cpu")
    tl = bridge.light_from_jax(light)
    jstate, tstate = jr.create_state(), tr.create_state()
    jstep = jax.jit(jr.render_frame)
    jprev = tprev = None
    report, failed = [], []
    for f in range(2):
        eye = (0.3 * f, 4.0, 7.0)
        jcam, tcam = rolled_cameras(jr, tr, eye, (0.0, 0.5, 0.0), f, jprev, tprev)
        jprev, tprev = np.asarray(jcam.view_proj), tcam.view_proj
        jout, jstate = jstep(jstate, jcam, light)
        tout, tstate = tr.render_frame(tstate, tcam, tl)
        assert sorted(tout) == sorted(jout)
        for key in sorted(jout):
            got, ref = tout[key].numpy(), np.asarray(jout[key])
            assert got.shape == ref.shape, key
            atol, share = (GBUFFER_TOL if key.startswith("gbuffer") else
                           TAA_TOL if key in ("taa", "ldr") else SHADED_TOL)
            outside, worst = _share_outside(got, ref, atol)
            report.append(f"frame {f} {key}: {outside:.4%} beyond {atol} (max {worst:.3g})")
            if outside > share or (key in ("taa", "ldr") and worst > TAA_MAX):
                failed.append(report[-1])
    print("\n".join(report))
    assert not failed, failed
    ldr = tout["ldr"].numpy()
    assert np.isfinite(ldr).all() and ldr.std() > 0.02
