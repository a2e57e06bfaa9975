"""``sponza_pbr``, the port's textured hall (``scene/scenes.py``,
``scene/pbr_maps.py``), on the CPU at 64² maps (``sponza_pbr_small``):
24 materials of three maps each, packed as glTF packs them; the atlas as
the shelf packer lays it out and the same bit for bit on every build;
``sponza_scan``'s triangles and tree with UVs that repeat a map about
every 2 m and tangents that follow them; and a small hybrid frame that
the maps change."""
import numpy as np
import pytest
import torch

from hybrid_rendering_torch import config as tcfg
from hybrid_rendering_torch.models.renderer import HybridRenderer
from hybrid_rendering_torch.ops.sky import ProceduralSky
from hybrid_rendering_torch.scene import pbr_maps, scenes
from hybrid_rendering_torch.scene.textures import AtlasBuilder

SIZE = 64
W, H = 32, 24


@pytest.fixture(scope="module")
def hall():
    """(sponza_pbr at 64² maps, sponza_scan, their light and camera), both
    scenes with their trees."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    pbr, light, cam = scenes.load_scene("sponza_pbr_small")
    scan, scan_light, scan_cam = scenes.load_scene("sponza_scan")
    assert cam == scan_cam and torch.equal(light.direction, scan_light.direction)
    yield pbr, scan, light, cam
    torch.set_num_threads(threads)


def test_24_materials_and_72_maps(hall):
    pbr = hall[0]
    m = pbr.materials
    assert m.albedo.shape[0] == len(pbr_maps.MATERIALS) == 24
    assert pbr.atlas.num_textures == 72
    assert m.maps == {"albedo_tex", "normal_tex", "roughness_tex", "metallic_tex"}
    # three maps a material, every map one material's; roughness and
    # metallic share the packed map and read its G and B
    assert torch.equal(m.roughness_tex, m.metallic_tex)
    used = torch.cat([m.albedo_tex, m.normal_tex, m.roughness_tex])
    assert torch.equal(used.sort().values, torch.arange(72, dtype=used.dtype))
    assert bool((m.roughness_channel == 1).all()) and bool((m.metallic_channel == 2).all())
    assert bool((m.emissive_tex < 0).all())
    assert torch.equal(pbr.tri_mat.unique(), torch.arange(24, dtype=pbr.tri_mat.dtype))


def test_the_atlas_follows_the_shelf_packer(hall):
    """Maps of one size, in the order they were added, `per` to a shelf of
    the atlas's width, the next power of two of the widest map and at
    least 256: at 1024² that is one a shelf, 73,728 rows."""
    atlas = hall[0].atlas
    width = max(256, SIZE)
    per = width // SIZE
    assert tuple(atlas.image.shape) == (-(-72 // per) * SIZE, width, 4)
    i = torch.arange(72)
    want = torch.stack([(i % per) * SIZE, (i // per) * SIZE, torch.full_like(i, SIZE),
                        torch.full_like(i, SIZE)], 1).float()
    assert torch.equal(atlas.rects, want)
    assert -(-72 // (max(256, 1024) // 1024)) * 1024 == 73_728


def test_the_same_seed_gives_the_same_atlas_bit_for_bit(hall):
    b = AtlasBuilder()
    for k in range(24):
        for img in pbr_maps.material_maps(k, SIZE):
            b.add(img)
    assert torch.equal(b.build().image, hall[0].atlas.image)


def test_the_maps_are_glTF_packed_and_some_metal():
    metal = 0
    for k in range(24):
        albedo, normal, mr = pbr_maps.material_maps(k, SIZE)
        for img in (albedo, normal, mr):
            assert img.shape == (SIZE, SIZE, 3) and img.dtype == np.float32
            assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
        n = normal * 2.0 - 1.0
        assert np.allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5) and (n[..., 2] > 0).all()
        assert (mr[..., 0] == 1.0).all() and mr[..., 1].min() >= 0.1  # occlusion 1
        metal += bool(mr[..., 2].max() == 1.0 and mr[..., 2].min() == 0.0)
    assert metal >= 2  # metal over part of the map


def test_the_hall_is_sponza_scans_with_tiled_uvs_and_tangents(hall):
    pbr, scan = hall[:2]
    assert pbr.num_triangles == scan.num_triangles == 249_765
    for f in ("tri_pos", "tri_normal", "tri_mesh_id", "bvh_nodes_min", "bvh_nodes_max",
              "bvh_nodes_meta", "bvh_tri_order"):
        assert torch.equal(getattr(pbr, f), getattr(scan, f)), f
    # the floor (material 0) spans 36 x 18 m: 18 x 9 repeats; every
    # material's UVs pass 1
    floor = pbr.tri_uv[pbr.tri_mat == 0].reshape(-1, 2)
    assert torch.allclose(floor.amax(0), torch.tensor([18.0, 9.0]))
    assert float(floor.amin()) >= 0.0
    for k in range(24):
        assert float(pbr.tri_uv[pbr.tri_mat == k].amax()) > 1.0, k
    t = pbr.tri_tangent
    assert bool(torch.isfinite(t).all())
    assert torch.allclose(t[:, :3].norm(dim=1), torch.ones(t.shape[0]), atol=1e-5)
    assert set(t[:, 3].unique().tolist()) <= {-1.0, 1.0}


def _frame(scene, light, cam):
    cfg = tcfg.RendererConfig(
        width=W, height=H,
        shadows=tcfg.ShadowsConfig(atrous_iterations=2),
        ao=tcfg.AOConfig(scale=tcfg.RayTraceScale.HALF),
        reflections=tcfg.ReflectionsConfig(scale=tcfg.RayTraceScale.HALF),
        ddgi=tcfg.DDGIConfig(probe_distance=12.0, rays_per_probe=16,
                             scale=tcfg.RayTraceScale.QUARTER),
        taa=tcfg.TAAConfig(enabled=True))
    sky = ProceduralSky.create(sun_direction=tuple(light.direction.tolist()))
    r = HybridRenderer(scene, cfg, sky.radiance, device="cpu")
    out, _ = r.render_frame(r.create_state(), r.make_camera(cam["eye"], cam["target"], 0), light)
    return out["ldr"]


def test_a_textured_frame_is_finite_and_not_the_untextured_one(hall):
    pbr, scan, light, cam = hall
    textured, plain = _frame(pbr, light, cam), _frame(scan, light, cam)
    assert textured.shape == plain.shape and textured.shape[:2] == (H, W)
    assert bool(torch.isfinite(textured).all())
    assert float((textured - plain).abs().amax()) > 0.05
