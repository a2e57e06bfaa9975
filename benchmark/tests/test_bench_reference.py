"""The plain reference's own parts, on the CPU: its tree and walk against
brute force (``hrref.ops.brute``), its lookup of a scene by file, and its
scenes against the program's for every configuration of the benchmark.

The walk must agree with brute force on every ray: the same any-hit, the
same closest t, and the same triangle, u and v wherever no other triangle
lies at that t. It is run walking to the end (no hand-over) and with the
hand-over to brute force at its card setting."""
import json
import os

import numpy as np
import pytest
import torch

from hrbench import cells
from hrref.ops import brute, bvh
from hrref.scene import scenes as ref_scenes
from test_bench_correct import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def shadows_test():
    scene, light, cam = ref_scenes.load_scene("shadows_test")
    return scene, bvh.make_trace_scene(scene), cam


@pytest.fixture(scope="module")
def sponza_scan():
    scene, light, cam = ref_scenes.load_scene("sponza_scan")
    return scene, bvh.make_trace_scene(scene), cam


def _rays(n, seed, lo, hi):
    g = torch.Generator().manual_seed(seed)
    lo, hi = torch.tensor(lo), torch.tensor(hi)
    o = lo + torch.rand(n, 3, generator=g) * (hi - lo)
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.rand(n, generator=g) * 40.0
    t_max[: n // 8] = float("inf")
    return o, d, t_max


def _edge_rays(cam):
    """Rays with t_max <= t_min, rays parallel to the boxes' faces (a zero
    component, both axis signs), rays from the camera that miss upward
    and rays from far outside the scene pointing away."""
    eye = torch.tensor(cam["eye"], dtype=torch.float32)
    target = torch.tensor(cam["target"], dtype=torch.float32)
    fwd = (target - eye) / (target - eye).norm()
    axes = torch.eye(3)
    o = torch.cat([eye.expand(6, 3), eye.expand(6, 3), eye.expand(2, 3),
                   torch.tensor([[0.0, 500.0, 0.0], [500.0, 1.0, 0.0]])])
    d = torch.cat([fwd.expand(6, 3), torch.cat([axes, -axes]),
                   torch.tensor([[0.0, 1.0, 0.0], [0.1, 0.995, 0.0]]),
                   torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])])
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.cat([torch.tensor([0.0, 1e-3, 5e-4, -1.0, 1e-3 + 1e-9, float("inf")]),
                       torch.full((6,), 100.0), torch.full((4,), float("inf"))])
    return o, d, t_max


def _agree(ts, o, d, t_max):
    """The walk's closest and any hit against brute force, on every ray."""
    ref = brute.closest_hit(ts.tri_pos, o, d, t_max)
    hit = bvh.traverse(ts, o, d, t_max)
    assert torch.equal(hit.valid, ref.valid)
    assert torch.equal(hit.t, ref.t)
    # the triangle, u and v where no second triangle lies at the same t
    rays = torch.nonzero(ref.valid).squeeze(1)
    ties = torch.zeros_like(ref.valid)
    if rays.numel():
        t, _, _, ok = brute._tests(o[rays], d[rays], ts.tri_pos, 1e-3)
        ties[rays] = ((ok & (t == ref.t[rays, None])).sum(dim=1) > 1)
    clean = ~ties
    assert torch.equal(hit.tri_id[clean], ref.tri_id[clean])
    assert torch.equal(hit.u[clean], ref.u[clean]) and torch.equal(hit.v[clean], ref.v[clean])
    anyhit = bvh.traverse(ts, o, d, t_max, any_hit=True)
    assert torch.equal(anyhit.valid, ref.valid)
    assert torch.equal(bvh.visibility_plain(ts, o, d, t_max),
                       brute.visibility(ts.tri_pos, o, d, t_max))
    return ref.valid


@pytest.fixture(params=["walk", "hand-over"])
def hand_over(request, monkeypatch):
    pairs = 0 if request.param == "walk" else bvh.BRUTE_PAIRS["cuda"]
    monkeypatch.setitem(bvh.BRUTE_PAIRS, "cpu", pairs)
    return request.param


def test_the_walk_agrees_with_brute_force_on_shadows_test(shadows_test, hand_over):
    scene, ts, cam = shadows_test
    o, d, t_max = _rays(3000, 2**31 + 17, [-15.0, 0.0, -15.0], [15.0, 9.0, 15.0])
    valid = _agree(ts, o, d, t_max)
    assert 0.2 < valid.float().mean() < 0.8  # hits and misses both


def test_the_walk_agrees_with_brute_force_on_sponza_scan(sponza_scan, hand_over):
    scene, ts, cam = sponza_scan
    o, d, t_max = _rays(300, 2**31 + 19, [-14.0, 0.5, -5.0], [14.0, 6.0, 5.0])
    valid = _agree(ts, o, d, t_max)
    assert 0.2 < valid.float().mean() < 0.95


@pytest.mark.parametrize("scene_fixture", ["shadows_test", "sponza_scan"])
def test_the_walk_edge_cases(request, scene_fixture, hand_over):
    scene, ts, cam = request.getfixturevalue(scene_fixture)
    o, d, t_max = _edge_rays(cam)
    valid = _agree(ts, o, d, t_max)
    assert not valid[:5].any()  # t_max <= t_min: nothing hit, visible
    assert torch.equal(bvh.visibility_plain(ts, o[:5], d[:5], t_max[:5]), torch.ones(5))
    assert not valid[-2:].any()  # outside, pointing away


def test_the_tree_holds_every_triangle_once_inside_its_boxes(shadows_test):
    scene, ts, _ = shadows_test
    meta = scene.bvh_nodes_meta.to(torch.int64)
    N = meta.shape[0]
    leaf = meta[:, 1] > 0
    assert int(meta[leaf, 1].sum()) == scene.num_triangles
    assert int(meta[:, 1].max()) <= bvh.LEAF_SIZE
    seen = torch.cat([torch.arange(int(a), int(a + c)) for a, c in meta[leaf, :2]])
    assert torch.equal(seen.sort().values, torch.arange(scene.num_triangles))
    for i in torch.nonzero(leaf).squeeze(1).tolist():
        a, c = int(meta[i, 0]), int(meta[i, 1])
        tri = scene.tri_pos[a:a + c].reshape(-1, 3)
        assert (tri >= scene.bvh_nodes_min[i]).all() and (tri <= scene.bvh_nodes_max[i]).all()
    # preorder: an internal node's subtree ends where its skip link leads
    skip = meta[:, 2]
    internal = torch.nonzero(~leaf).squeeze(1)
    assert bool((skip[internal] > internal + 1).all()) and int(skip.max()) == N
    assert scene.bvh_tri_order.sort().values.equal(
        torch.arange(scene.num_triangles, dtype=scene.bvh_tri_order.dtype))


def test_the_sah_tree_is_shallower_than_a_median_split(sponza_scan):
    """What the binned SAH buys: a primary ray down sponza_scan's hall
    visits about a quarter of the nodes of the old Morton median split
    (65 against 274 a ray at 192x108 from the first camera keyframe)."""
    scene, ts, cam = sponza_scan
    o, d, t_max = _rays(500, 2**31 + 23, [-14.0, 2.5, -1.0], [14.0, 3.5, 1.0])
    t_max[:] = float("inf")
    best = bvh.traverse(ts, o, d, t_max).t
    meta, done = ts.nodes_meta, ts.nodes_meta.shape[0] - 1
    node = torch.zeros(o.shape[0], dtype=torch.int64)
    inv = bvh._safe_inv(d)
    steps = torch.zeros(o.shape[0])
    while bool((node < done).any()):
        steps += (node < done).float()
        t0 = (ts.nodes_min[node] - o) * inv
        t1 = (ts.nodes_max[node] - o) * inv
        tnear = torch.clamp(torch.minimum(t0, t1).amax(dim=1), min=1e-3)
        tfar = torch.minimum(torch.maximum(t0, t1).amin(dim=1), best)
        down = (tnear <= tfar) & (meta[node, 1] == 0)
        node = torch.clamp(torch.where(down, node + 1, meta[node, 2]), max=done)
    assert steps.mean() < 150  # nodes a ray visits, knowing its hit


def test_a_scene_file_is_found_by_load_scene(tmp_path, monkeypatch):
    (tmp_path / "two_boxes.py").write_text(
        "from hrref.scene import primitives as prim\n"
        "from hrref.scene.build import MaterialDef, SceneBuilder, translation\n"
        "from hrref.types import Light\n\n\n"
        "def build(use_bvh=True):\n"
        "    b = SceneBuilder()\n"
        "    m = b.add_material(MaterialDef())\n"
        "    b.add_instance(prim.box(1.0, 1.0, 1.0), m)\n"
        "    b.add_instance(prim.box(1.0, 1.0, 1.0), m, translation(3.0, 0.0, 0.0))\n"
        "    light = Light.directional(direction=(0.0, 1.0, 0.0), color=(1.0, 1.0, 1.0),\n"
        "                              intensity=1.0, radius=0.05)\n"
        "    return b.build(use_bvh=use_bvh), light, dict(eye=(0, 2, 6), target=(1, 0, 0))\n")
    monkeypatch.setattr(ref_scenes, "EXTRA_DIR", str(tmp_path))
    scene, light, cam = ref_scenes.load_scene("two_boxes")
    assert scene.num_triangles == 24 and scene.bvh_nodes_meta is not None
    with pytest.raises(KeyError):
        ref_scenes.load_scene("no_such_scene")


def _config_scenes():
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = set()
    for c in bench["configs"]:
        with open(os.path.join(cells.ROOT, c["file"])) as f:
            names.add(json.load(f)["scene"])
    return sorted(names)


def _equal(got, ref, path="scene"):
    """Every tensor of the reference's value equal to the program's of the
    same field name, nested."""
    import dataclasses

    if isinstance(ref, torch.Tensor):
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == ref.dtype and torch.equal(got, ref), path
    elif dataclasses.is_dataclass(ref):
        for f in dataclasses.fields(ref):
            _equal(getattr(got, f.name), getattr(ref, f.name), f"{path}.{f.name}")
    elif isinstance(ref, np.ndarray):
        assert np.array_equal(np.asarray(got), ref), path
    else:
        assert got == ref, path


@pytest.mark.parametrize("name", _config_scenes())
def test_the_program_and_the_reference_build_the_same_scene(name):
    """Triangles, materials and atlas of each configuration's scene, before
    either side orders them by its own tree."""
    from hybrid_rendering_torch.scene import scenes as prog_scenes

    got, got_light, got_cam = prog_scenes.load_scene(name, use_bvh=False)
    ref, ref_light, ref_cam = ref_scenes.load_scene(name, use_bvh=False)
    assert ref.num_triangles == got.num_triangles > 0
    _equal(got, ref)
    _equal(got_light, ref_light, "light")
    assert got_cam == ref_cam
