"""The port's multi-device rendering (``hybrid_rendering_torch/parallel``)
on the CPU, a mesh being a list of devices that repeats ``"cpu"``.

- The sharded tracers (closest hit, visibility, surface and ``.many``)
  equal the unsharded ones bit for bit, for 1, 2, 3 and 8 shards, through
  the BVH walk and the dense tracer: K1/K2 and K6/K6′ (their plain versions
  here) answer each ray alone, whatever the batch it rides in.
- ``make_mesh``, the layouts and ``frame_shardings`` against the JAX
  package's specs on a RenderState (JAX has 8 CPU devices under pytest).
- The sharded GT path tracer equals the unsharded one bit for bit (the
  RNG is seeded by the global row; measured max deviation 0) and is held
  to JAX's ``path_trace_frame_sharded`` with the path tracer's tolerance
  (``PATH_TOL``: 1e-4 on >= 99% of pixels).
- Sharded hybrid frames (static, and animated through ``posed_tracers``)
  equal the unsharded frames bit for bit, every output plane.
- The device guard of the kernel wrappers, and ``entry_torch.py``.
The JAX side imports only ``hybrid_rendering_tpu.parallel`` besides the
scene, config and path tracer modules it needs."""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import bench_torch
import entry_torch
from hybrid_rendering_tpu import config as jcfg
from hybrid_rendering_tpu.models import path_tracer as jpt
from hybrid_rendering_tpu.models import renderer as jrenderer
from hybrid_rendering_tpu.ops import sky as jsky
from hybrid_rendering_tpu.parallel import mesh as jmesh
from hybrid_rendering_tpu.parallel import render as jrender
from hybrid_rendering_tpu.parallel import sharding as jsharding
from hybrid_rendering_tpu.scene import build as jbuild
from hybrid_rendering_tpu.scene import primitives as jprim
from hybrid_rendering_tpu.types import Light as JLight
from hybrid_rendering_tpu.utils import camera as jcam
from hybrid_rendering_torch import bridge
from hybrid_rendering_torch import config as tcfg
from hybrid_rendering_torch.models import path_tracer as tpt
from hybrid_rendering_torch.models import renderer as trenderer
from hybrid_rendering_torch.ops import bvh as tbvh
from hybrid_rendering_torch.ops import kernels
from hybrid_rendering_torch.ops import sky as tsky
from hybrid_rendering_torch.parallel import mesh as tmesh
from hybrid_rendering_torch.parallel import render as trender
from hybrid_rendering_torch.parallel import sharding as tsharding
from hybrid_rendering_torch.parallel import trace as ttrace
from test_torch_path_tracer import PATH_TOL, _close

SHARDS = (1, 2, 3, 8)
GT_W = GT_H = 16


def _jax_tiny_scene():
    """tests/test_parallel.py's scene: a ground plane, a red box and a
    sphere, built by the JAX package."""
    b = jbuild.SceneBuilder()
    ground = b.add_material(jbuild.MaterialDef(albedo=(0.8, 0.8, 0.8), roughness=0.9))
    red = b.add_material(jbuild.MaterialDef(albedo=(0.8, 0.2, 0.2), roughness=0.4))
    b.add_instance(jprim.plane(20.0, 20.0), ground)
    b.add_instance(jprim.box(1.0, 1.0, 1.0), red, jbuild.translation(0, 0.5, 0))
    b.add_instance(jprim.uv_sphere(0.6, 8, 12), ground, jbuild.translation(1.5, 0.6, 0.5))
    return b.build(use_bvh=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread in this module (as in tests/test_torch_apps.py):
    the suite runs several workers on the machine's cores, and torch's
    parallel regions then wait on threads other processes hold (the
    3-frame tests below ran ~50x slower under the whole suite with torch's
    default threads than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    jscene = _jax_tiny_scene()
    return jscene, bridge.scene_from_jax(jscene)


def cpu_mesh(n):
    return tmesh.make_mesh(devices=["cpu"] * n)


def _rays(shape, seed):
    """Rays from above the scene in random directions, (*shape, 3) each."""
    rs = np.random.RandomState(seed)
    n = int(np.prod(shape))
    o = rs.uniform(-2, 2, (n, 3)).astype(np.float32) + np.float32([0, 2, 0])
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).reshape(*shape, 3), torch.from_numpy(d).reshape(*shape, 3))


def _t_max(shape, seed):
    """Per-ray limits in [-1, 40): about one ray in 40 masked (t_max <=
    t_min)."""
    return torch.from_numpy(np.random.RandomState(seed).uniform(-1, 40, shape).astype(np.float32))


def assert_bits_equal(got, ref, label):
    """Equal bit for bit: tensors, Hit/Surface fields, tuples of those."""
    if isinstance(ref, torch.Tensor):
        assert got.shape == ref.shape and got.dtype == ref.dtype, label
        if ref.dtype == torch.float32:
            got, ref = got.view(torch.int32), ref.view(torch.int32)
        assert torch.equal(got, ref), label
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), label
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_bits_equal(g, r, f"{label}[{i}]")
    else:
        for f in dataclasses.fields(ref):
            assert_bits_equal(getattr(got, f.name), getattr(ref, f.name), f"{label}.{f.name}")


# ---------------------------------------------------------------------------
# the sharded tracers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["auto", "flash_dense"])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_tracers_match_unsharded(scenes, n, method):
    """Closest hit, visibility and surface, each sharded over n shards,
    against the unsharded tracer bit for bit: image batches whose H divides
    by n (24 rows: the row split, except n = 1 of course nothing to split)
    and does not (25 rows: flattened and padded), a flat batch of 203 rays
    (padded unless n = 1), an array t_max with masked rays and a scalar
    one; and ``.many`` of two requests (an image and a flat batch)."""
    _, tscene = scenes
    accel = tbvh.make_accel(tscene, method)
    closest, vis = tbvh.make_tracers(tscene, accel, method)
    surface = tbvh.make_surface_tracer(tscene, accel, method)
    mesh = cpu_mesh(n)
    sharded = ttrace.shard_renderer_tracers(mesh, closest, vis, surface, method=method)
    for shape in ((24, 16), (25, 16), (203,)):
        o, d = _rays(shape, seed=sum(shape))
        tm = _t_max(shape, seed=1)
        assert bool((tm <= 1e-3).any()), "no masked ray"
        for t_max in (tm, 30.0):
            for name, ref_fn, fn in zip(("closest", "visibility", "surface"),
                                        (closest, vis, surface), sharded):
                label = f"{name} {shape} t_max {'array' if t_max is tm else 'scalar'}"
                assert_bits_equal(fn(o, d, t_max), ref_fn(o, d, t_max), label)
    o1, d1 = _rays((24, 16), seed=5)
    o2, d2 = _rays((77,), seed=6)
    reqs = [(o1, d1, 30.0), (o2, d2, _t_max((77,), seed=2))]
    got = sharded[1].many(reqs)
    assert_bits_equal(got, vis.many(reqs), ".many")
    assert [tuple(g.shape) for g in got] == [(24, 16), (77,)]


def test_shard_ray_fn_splits_rows_and_pads_flat_batches():
    """What each shard is given: contiguous row blocks of an image whose H
    divides by n (each block traced whole, so the tracer blocks its own
    pixels), else the flattened batch padded with its last ray to a
    multiple of n; an array t_max goes with its rays, a scalar to every
    shard (a number as one 0-d tensor made on the batch's device, so no
    shard copies it from the host); the result is the unpadded batch in
    its shape."""
    calls = []

    def fn(o, d, tm):
        calls.append((tuple(o.shape), o.clone(), tm.clone()))
        return o[..., 0] + tm

    wrapped = ttrace.shard_ray_fn(cpu_mesh(3), fn)
    o = torch.arange(6 * 4 * 3, dtype=torch.float32).reshape(6, 4, 3)
    out = wrapped(o, o, 1.0)
    assert [c[0] for c in calls] == [(2, 4, 3)] * 3
    assert torch.equal(calls[1][1], o[2:4])
    assert all(c[2].shape == () and c[2].item() == 1.0 for c in calls)
    assert torch.equal(out, o[..., 0] + 1.0)
    calls.clear()
    flat = torch.arange(7 * 3, dtype=torch.float32).reshape(7, 3)
    tm = torch.arange(7, dtype=torch.float32)
    out = wrapped(flat, flat, tm)
    assert [c[0] for c in calls] == [(3, 3)] * 3
    assert torch.equal(calls[2][1], torch.cat([flat[6:], flat[6:], flat[6:]]))
    assert torch.equal(calls[2][2], torch.tensor([6.0, 6.0, 6.0]))
    assert torch.equal(out, flat[:, 0] + tm)
    with pytest.raises(ValueError, match="2 tracers for 3 shards"):
        ttrace.shard_ray_fn(cpu_mesh(3), [fn, fn])


def test_replicas_only_on_other_devices(scenes):
    """A mesh that repeats the scene's device makes no copy; a refit's copy
    reuses every tensor of the base copy that the refit kept."""
    _, tscene = scenes
    accel = tbvh.make_accel(tscene)
    assert ttrace.replicate(cpu_mesh(4), tscene, accel) == {}
    meta = torch.device("meta")
    mesh = tmesh.Mesh((torch.device("cpu"), meta))
    reps = ttrace.replicate(mesh, tscene, accel)
    assert list(reps) == [meta] and reps[meta][0].tri_pos.device == meta
    assert reps[meta][1].nodes_packed.device == meta
    moved = dataclasses.replace(tscene, tri_pos=tscene.tri_pos + 1.0)
    again = ttrace.replicate(mesh, moved, accel, base=(tscene, accel, reps))
    assert again[meta][1] is reps[meta][1]  # the accel is the base's own
    assert again[meta][0].materials is reps[meta][0].materials
    assert again[meta][0].tri_uv is reps[meta][0].tri_uv
    assert again[meta][0].tri_pos is not reps[meta][0].tri_pos


# ---------------------------------------------------------------------------
# the mesh and the layout
# ---------------------------------------------------------------------------


def test_make_mesh(monkeypatch):
    """No GPU and no devices: refused, never the CPU in the card's place.
    Devices given are taken as they are, repeats included."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(2)
    mesh = tmesh.make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.shape[tmesh.TILE_AXIS] == 3 == mesh.shape["tiles"]
    assert tmesh.row_sharding(mesh).spec == ("tiles",)
    assert tmesh.replicated(mesh).spec == ()
    assert [tmesh.pad_rows(h, 3) for h in (6, 7, 8, 9)] == [6, 9, 9, 9]
    with pytest.raises(ValueError):
        tmesh.make_mesh(devices=[])


def _renderer_config(m, width, height):
    return m.RendererConfig(
        width=width, height=height,
        shadows=m.ShadowsConfig(atrous_iterations=2),
        ao=m.AOConfig(scale=m.RayTraceScale.HALF),
        reflections=m.ReflectionsConfig(scale=m.RayTraceScale.HALF),
        ddgi=m.DDGIConfig(probe_distance=4.0, rays_per_probe=32, scale=m.RayTraceScale.HALF),
        taa=m.TAAConfig(enabled=True))


def _flatten_specs(tree, prefix=""):
    """{dotted path: spec} of the port's layout tree."""
    if isinstance(tree, tmesh.Sharding):
        return {prefix: tree.spec}
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    else:
        items = list(tree.items())
    out = {}
    for k, v in items:
        if v is not None:
            out.update(_flatten_specs(v, f"{prefix}.{k}"))
    return out


# state fields only one side has (none: the port's DDGI frame counters are
# Python numbers where JAX's are device scalars, replicated on both sides)
ONLY_JAX = set()
ONLY_PORT = set()


@pytest.mark.parametrize("n", [8, 3])
def test_frame_shardings_match_jax(scenes, n):
    """The port's layout of a RenderState at H = 48 (planes at 48, 24 and
    12 rows) equals JAX's ``frame_shardings(...).spec`` on every field the
    two states share; the fields only one side has are named above."""
    jscene, tscene = scenes
    width, height = 64, 48
    sky = jsky.ProceduralSky.create(sun_direction=(0.3, 0.9, 0.2))
    jstate = jrenderer.HybridRenderer(jscene, _renderer_config(jcfg, width, height),
                                      sky.radiance).create_state()
    jspecs = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in jax.tree_util.tree_flatten_with_path(
        jsharding.frame_shardings(jstate, jmesh.make_mesh(n), height))[0]}
    tsk = tsky.ProceduralSky.create(sun_direction=(0.3, 0.9, 0.2))
    tr = trenderer.HybridRenderer(tscene, _renderer_config(tcfg, width, height), tsk.radiance,
                                  device="cpu")
    tstate = tr.create_state()
    tspecs = _flatten_specs(tsharding.frame_shardings(tstate, cpu_mesh(n), height))
    assert set(jspecs) - set(tspecs) == ONLY_JAX
    assert set(tspecs) - set(jspecs) == ONLY_PORT
    shared = sorted(set(jspecs) & set(tspecs))
    assert len(shared) == 26
    assert {k: tspecs[k] for k in shared} == {k: jspecs[k] for k in shared}
    split = {k for k in shared if tspecs[k]}
    assert {".prev_gbuffer.depth", ".ao.history", ".taa.history"} <= split
    assert not split & {".ddgi.irradiance", ".prev_cam_pos", ".frame_index"}
    # shard_frame_state puts the state on the mesh's first device, where
    # the frame runs; a tensor already there is the same tensor
    placed = tsharding.shard_frame_state(tstate, cpu_mesh(n), height)
    assert placed.taa.history is tstate.taa.history and placed.frame_index == 0


# ---------------------------------------------------------------------------
# the GT path tracer, a row block a shard
# ---------------------------------------------------------------------------


def _gt_setup(tscene):
    light = JLight.directional(direction=(0.3, 0.9, 0.2), intensity=5.0, radius=0.05)
    jcamera = jcam.make_camera(eye=(4.0, 3.0, 6.0), target=(0.0, 0.5, 0.0), width=GT_W,
                               height=GT_H)
    tsk = tsky.ProceduralSky.create(sun_direction=np.asarray(light.direction))
    return (light, jcamera, bridge.light_from_jax(light), bridge.camera_from_jax(jcamera),
            tsk, tcfg.PathTracerConfig(max_ray_bounces=2))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_gt_matches_unsharded(scenes, n):
    """Two samples at 16x16: the sharded step against ``render_progressive``
    through the "bvh" tracers, bit for bit (measured max deviation 0: the
    RNG is seeded by the global row, each ray traced alone)."""
    _, tscene = scenes
    _, _, tlight, tcamera, tsk, cfg = _gt_setup(tscene)
    ref = tpt.render_progressive(
        tscene, tbvh.make_surface_tracer(tscene, method="bvh"),
        tbvh.make_tracers(tscene, method="bvh")[1], tcamera, tlight, tsk.radiance,
        GT_W, GT_H, 2, cfg)
    step = trender.path_trace_frame_sharded(cpu_mesh(n), tscene, tcamera, tlight, tsk,
                                            GT_W, GT_H, cfg)
    state = tpt.GroundTruthState.create(GT_H, GT_W)
    for _ in range(2):
        state = step(state)
    assert int(state.num_frames) == 2
    print(f"sharded GT over {n}: max |d| {(state.color - ref.color).abs().max().item()}")
    assert_bits_equal(state.color, ref.color, f"GT over {n} shards")
    with pytest.raises(ValueError, match="divide"):
        trender.path_trace_frame_sharded(cpu_mesh(3), tscene, tcamera, tlight, tsk, GT_W,
                                         GT_H, cfg)


def test_sharded_gt_matches_jax(scenes):
    """The port's sharded step against JAX's ``path_trace_frame_sharded``
    over 2 shards, 2 samples at 16x16, with the path tracer's tolerance
    (the RNG streams are bit-identical; ulps in hit points remain)."""
    jscene, tscene = scenes
    jlight, jcamera, tlight, tcamera, tsk, cfg = _gt_setup(tscene)
    jsk = jsky.ProceduralSky.create(sun_direction=np.asarray(jlight.direction))
    jstep = jrender.path_trace_frame_sharded(jmesh.make_mesh(2), jscene, jcamera, jlight, jsk,
                                             GT_W, GT_H, jcfg.PathTracerConfig(max_ray_bounces=2))
    tstep = trender.path_trace_frame_sharded(cpu_mesh(2), tscene, tcamera, tlight, tsk, GT_W,
                                             GT_H, cfg)
    jst, tst = jpt.GroundTruthState.create(GT_H, GT_W), tpt.GroundTruthState.create(GT_H, GT_W)
    for _ in range(2):
        jst, tst = jstep(jst), tstep(tst)
    img = tst.color.numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01 and int(tst.num_frames) == 2
    _close(img, np.asarray(jst.color), PATH_TOL, "sharded GT, 2 spp, port vs JAX")


# ---------------------------------------------------------------------------
# the sharded hybrid frame
# ---------------------------------------------------------------------------


def _frames(r, light, camkw, n_frames=3):
    """`n_frames` frames of a camera sliding along x: every output plane."""
    state, prev, frames = r.create_state(), None, []
    for f in range(n_frames):
        eye = tuple(np.asarray(camkw["eye"]) + [0.2 * f, 0.0, 0.0])
        cam = r.make_camera(eye, camkw["target"], f, prev_view_proj=prev)
        prev = cam.view_proj
        out, state = r.render_frame(state, cam, light)
        frames.append(out)
    return frames


def _hero_animator(frame):
    """shadows_test's hero (instance 13) turned 0.3 rad about y a frame and
    moved along x; the other instances at identity."""
    m = torch.eye(4).repeat(14, 1, 1)
    c, s = np.cos(0.3 * frame), np.sin(0.3 * frame)
    m[13, 0, 0], m[13, 0, 2], m[13, 2, 0], m[13, 2, 2] = c, s, -s, c
    m[13, 0, 3] = 0.4 * frame
    return m


@pytest.fixture(scope="module")
def bench32():
    """The bench frame's renderer at 32x24 (shadows_test, DDGI and
    reflections on, debug planes), its light and camera; DDGI at 32 rays a
    probe, since the probe rays' plain walk is most of the frame's time on
    the CPU."""
    r, light, camkw = bench_torch._build("shadows_test", 32, 24, device="cpu", debug=True)
    cfg = r.config.replace(ddgi=dataclasses.replace(r.config.ddgi, rays_per_probe=32))
    return r, cfg, light, camkw


@pytest.mark.parametrize("animated", [False, True], ids=["static", "animated"])
def test_sharded_frame_matches_unsharded(bench32, animated):
    """The bench frame at 32x24, 3 frames of a moving camera, over 3 shards
    against the unsharded frame: every plane bit for bit. 3 shards split
    the 24, 12 and 6 rows of the full-, half- and quarter-res traces and
    pad the 36,992 probe rays (+1); the shadow + AO trace goes through the
    sharded ``.many``. Animated: shadows_test's hero moved through
    ``posed_tracers``."""
    base, cfg, light, camkw = bench32

    def renderer(mesh):
        return trenderer.HybridRenderer(
            base.scene, cfg, base.sky_radiance_fn, base.env_irradiance_fn,
            base.env_prefiltered_fn, animator=_hero_animator if animated else None,
            **(dict(mesh=mesh) if mesh else dict(device="cpu")))

    ref = _frames(renderer(None), light, camkw)
    r = renderer(cpu_mesh(3))
    assert r.device == torch.device("cpu") and r.mesh.shape["tiles"] == 3
    got = _frames(r, light, camkw)
    for f, (g, want) in enumerate(zip(got, ref)):
        assert sorted(g) == sorted(want)
        for key in sorted(want):
            assert_bits_equal(g[key], want[key], f"frame {f} {key}")
    assert float(got[-1]["ldr"].std()) > 0.02


def test_renderer_mesh_device():
    """With a mesh the frame runs on its first device; another device is
    refused."""
    scene, _, sky, _, _ = entry_torch._tiny_setup(16, 16, "cpu")
    cfg = tcfg.RendererConfig(width=16, height=16)
    r = trenderer.HybridRenderer(scene, cfg, sky.radiance, mesh=cpu_mesh(2))
    assert r.device == torch.device("cpu")
    assert hasattr(r.visibility_fn, "many") and hasattr(r.closest_fn, "many")
    with pytest.raises(ValueError, match="first device"):
        trenderer.HybridRenderer(scene, cfg, sky.radiance, device="meta", mesh=cpu_mesh(2))


# ---------------------------------------------------------------------------
# the device guard and the entry points
# ---------------------------------------------------------------------------


def _fake_operand(device):
    """What ``kernels.require`` reads of a tensor, on a device this machine
    does not have."""
    return types.SimpleNamespace(device=torch.device(device), dtype=torch.float32,
                                 shape=(4, 3), is_contiguous=lambda: True)


def test_require_refuses_an_operand_on_another_card(monkeypatch):
    """A kernel launches on its operands' device: an operand on another
    card is refused, not moved (a mesh over two cards once launched shard
    1's kernel into card 0's stream with card 1's pointers)."""
    kernels.require(_fake_operand("cuda:1"), "origin", torch.float32, (4, 3),
                    torch.device("cuda", 1))
    with pytest.raises(ValueError, match="origin: on cuda:1, but the kernel launches on cuda:0"):
        kernels.require(_fake_operand("cuda:1"), "origin", torch.float32, (4, 3),
                        torch.device("cuda", 0))
    # no device given: the current card's
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    kernels.require(_fake_operand("cuda:1"), "x", torch.float32)
    with pytest.raises(ValueError, match="launches on cuda:1"):
        kernels.require(_fake_operand("cuda:0"), "x", torch.float32)


def test_entry_and_dryrun_on_the_cpu():
    """``entry(device="cpu")`` renders a finite 64x64 frame;
    ``dryrun_multichip(2, device="cpu")`` runs the sharded frame, the
    sharded GT and the sharded tracers on 19 rays against the unsharded
    ones; without a card and a device both refuse."""
    fn, (state,) = entry_torch.entry(device="cpu")
    ldr, state = fn(state)
    assert tuple(ldr.shape) == (64, 64, 3) and bool(torch.isfinite(ldr).all())
    assert 0.05 < ldr.mean().item() < 0.99
    figures = entry_torch.dryrun_multichip(2, device="cpu")
    assert figures["devices"] == ["cpu", "cpu"] and figures["rays"] == 19
    assert 0.05 < figures["ldr_mean"] < 0.99 and figures["hits"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry_torch.dryrun_multichip(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry_torch.entry()


def test_entry_torch_runs_without_jax():
    """With jax and flax blocked, ``python3 entry_torch.py --dryrun 2
    --device cpu`` runs to its end: the script and the parallel package
    need nothing of JAX."""
    import os
    import subprocess
    import sys
    import textwrap

    script = textwrap.dedent("""
        import sys
        sys.modules.update(jax=None, jaxlib=None, flax=None, hybrid_rendering_tpu=None)
        import entry_torch
        sys.exit(entry_torch.main(["--dryrun", "2", "--device", "cpu"]))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip(2) OK on ['cpu', 'cpu']" in proc.stdout
