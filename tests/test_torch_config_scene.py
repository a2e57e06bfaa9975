"""PyTorch port vs JAX package: config dataclasses, presets and the scene
build (host-side numpy, so every comparison here is exact)."""
import dataclasses
import enum

import numpy as np
import pytest
import torch

from hybrid_rendering_tpu import config as jcfg
from hybrid_rendering_tpu.scene import presets as jpresets
from hybrid_rendering_tpu.scene import scenes as jscenes
from hybrid_rendering_torch import bridge
from hybrid_rendering_torch import config as tcfg
from hybrid_rendering_torch.scene import build as tbuild
from hybrid_rendering_torch.scene import presets as tpresets
from hybrid_rendering_torch.scene import scenes as tscenes

PORTED_SCENES = tuple(jscenes.SCENE_NAMES)


def _as_plain(obj):
    """Dataclass tree -> nested (class name, dict) with enums as (name,
    value), so the two packages' trees compare by field name and value."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _as_plain(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name, obj.value)
    if isinstance(obj, (tuple, list)):
        return tuple(_as_plain(o) for o in obj)
    return obj


def test_config_defaults_field_for_field():
    assert _as_plain(tcfg.RendererConfig()) == _as_plain(jcfg.RendererConfig())
    assert ([(m.name, m.value) for m in tcfg.RayTraceScale]
            == [(m.name, m.value) for m in jcfg.RayTraceScale])
    assert _as_plain(tcfg.PathTracerConfig()) == _as_plain(jcfg.PathTracerConfig())


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_preset_table_field_for_field(name):
    assert name in tpresets.PRESETS
    assert _as_plain(tpresets.PRESETS[name]) == _as_plain(jpresets.PRESETS[name])


@pytest.mark.parametrize("name", PORTED_SCENES)
def test_apply_preset_config_and_light(name):
    kw = dict(width=64, height=48)
    _, jl, jcam, jc, _ = jpresets.apply_preset(name, jcfg.RendererConfig(**kw))
    _, tl, tcam, tc, _ = tpresets.apply_preset(name, tcfg.RendererConfig(**kw))
    assert _as_plain(tc) == _as_plain(jc)
    assert tcam == jcam
    bl = bridge.light_from_jax(jl)
    for f in ("direction", "position", "color"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), getattr(bl, f).numpy())
    for f in ("intensity", "radius", "type", "cos_theta_outer", "cos_theta_inner"):
        assert getattr(tl, f) == getattr(bl, f), f


@pytest.mark.parametrize("name", PORTED_SCENES)
def test_scene_build_equals_jax(name):
    """Same soup, materials and BVH, array for array (exact): both use the
    native builder when g++ is there, the Python builder otherwise."""
    jscene, _, _ = jscenes.load_scene(name)
    tscene, _, _ = tscenes.load_scene(name)
    ref = bridge.scene_from_jax(jscene)
    for f in ("tri_pos", "tri_normal", "tri_uv", "tri_mat", "tri_mesh_id",
              "tri_tangent", "bvh_nodes_min", "bvh_nodes_max", "bvh_nodes_meta",
              "bvh_tri_order"):
        a, b = getattr(tscene, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    for f in ("albedo", "roughness", "metallic", "emissive"):
        np.testing.assert_array_equal(getattr(tscene.materials, f).numpy(),
                                      getattr(ref.materials, f).numpy(), err_msg=f)


def test_python_builder_equals_jax():
    """The fallback Morton builder is the JAX package's, value for value."""
    from hybrid_rendering_tpu.ops import bvh as jbvh
    from hybrid_rendering_torch.ops import bvh as tbvh

    tri = np.random.RandomState(0).uniform(-3, 3, (300, 3, 3)).astype(np.float32)
    for a, b in zip(tbvh.build_bvh(tri), jbvh.build_bvh(tri)):
        np.testing.assert_array_equal(a, b)


def test_scene_names_equal_jax():
    """The JAX package's scenes, and besides them only the port's own
    textured hall (``sponza_pbr``, at 1024² and 64² maps)."""
    assert set(tscenes.FACTORIES) == set(jscenes.FACTORIES) | {"sponza_pbr", "sponza_pbr_small"}


def test_unknown_scene_raises_key_error():
    assert "no_such_scene" not in jscenes.FACTORIES
    with pytest.raises(KeyError, match="unknown scene"):
        tscenes.load_scene("no_such_scene")


def test_textured_material_raises():
    """Textured materials no longer raise: the texture and the material
    that indexes it build into the scene's atlas and map columns."""
    from hybrid_rendering_torch.scene import primitives as tprim

    b = tbuild.SceneBuilder()
    tex = b.add_texture(np.zeros((4, 4, 3), np.float32))
    m = b.add_material(tbuild.MaterialDef(albedo_tex=tex))
    b.add_instance(tprim.plane(1.0, 1.0), m)
    scene = b.build(use_bvh=False)
    assert scene.atlas is not None and scene.atlas.num_textures == 1
    assert scene.materials.albedo_tex.tolist() == [tex]
    assert scene.materials.maps == frozenset({"albedo_tex"})


def test_scene_to_device_keeps_values():
    scene, _, _ = tscenes.load_scene("gi_test")
    moved = scene.to(torch.device("cpu"))
    assert moved is not scene
    np.testing.assert_array_equal(moved.tri_pos.numpy(), scene.tri_pos.numpy())
    assert moved.num_triangles == 64
