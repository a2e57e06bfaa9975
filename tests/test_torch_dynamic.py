"""The port's dynamic scenes against the JAX package on the CPU: the soup's
refit, the motion deltas and previous positions, the trace structures
refitted on the scene's device (boxes, packed records, K2's 4-wide
records, the walks against brute force on the moved soup), the G-buffer's
motion plane and three animated frames of shadows_test through both
renderers. Inputs come from seeded numpy; each test states its
tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rendering_tpu import config as jcfg
from hybrid_rendering_tpu.models import gbuffer as jgbuffer
from hybrid_rendering_tpu.models import renderer as jrenderer
from hybrid_rendering_tpu.ops import bvh as jbvh
from hybrid_rendering_tpu.ops import sh as jsh
from hybrid_rendering_tpu.ops import sky as jsky
from hybrid_rendering_tpu.scene import dynamic as jdyn
from hybrid_rendering_tpu.scene import scenes as jscenes
from hybrid_rendering_tpu.utils import camera as jcam
from hybrid_rendering_torch import bridge
from hybrid_rendering_torch import config as tcfg
from hybrid_rendering_torch.models import gbuffer as tgbuffer
from hybrid_rendering_torch.models import renderer as trenderer
from hybrid_rendering_torch.ops import bvh as tbvh
from hybrid_rendering_torch.ops import intersect as tintersect
from hybrid_rendering_torch.ops import sh as tsh
from hybrid_rendering_torch.ops import sky as tsky
from hybrid_rendering_torch.scene import dynamic as tdyn
from hybrid_rendering_torch.utils import camera as tcam
from test_torch_reflections import jax_attr_surface_tracer
from test_torch_slice import (GBUFFER_TOL, REFL_MAX, REFL_TEMPORAL_PLANES, REFL_TEMPORAL_TOL,
                              SHADED_TOL, TAA_MAX, TAA_TOL, _share_outside)
from test_torch_textures import rolled_cameras
from test_torch_trace import _wide_walk

HERO = 13  # shadows_test's torus knot; 0 is the ground, 1-12 the pillars
HERO_CENTER = (0.0, 1.8, 0.0)
# refit: a rotation, a translation and a renormalization, each summed in
# another order than XLA's einsum; positions reach |x| ~ 30
POS_ATOL = 1e-5
DIR_ATOL = 1e-6
# torch.linalg.inv and jnp.linalg.inv of a 4x4 differ in the last bits;
# the deltas and the positions they map (|x| <= 30) hold 1e-5
DELTA_ATOL = 1e-5
# the motion plane is a difference of two projected uvs in [0, 1]: the
# deltas' last bits move it by up to ~1e-6
MOTION_ATOL = 1e-5
W, H = 32, 24


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rigid(rs, scale=1.0):
    """A random rotation (about a random axis) with a translation and a
    uniform scale, (4, 4) float32."""
    axis = rs.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = rs.uniform(-np.pi, np.pi)
    k = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    m = np.eye(4)
    m[:3, :3] = scale * (np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k)
    m[:3, 3] = rs.uniform(-3, 3, 3)
    return m.astype(np.float32)


def hero_transforms(frame, num_instances=14):
    """shadows_test's hero turned about y around its centre by 0.3 rad a
    frame and moved by (0.4, 0.05, -0.2) a frame; the rest at identity.
    (num_instances, 4, 4) float32 numpy."""
    c, s = np.cos(0.3 * frame), np.sin(0.3 * frame)
    rot = np.eye(4)
    rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = c, s, -s, c
    to, back = np.eye(4), np.eye(4)
    to[:3, 3] = np.asarray(HERO_CENTER) + np.asarray([0.4, 0.05, -0.2]) * frame
    back[:3, 3] = -np.asarray(HERO_CENTER)
    m = np.tile(np.eye(4), (num_instances, 1, 1))
    m[HERO] = to @ rot @ back
    return m.astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
    jscene = jscenes.load_scene("shadows_test")[0]
    return jscene, bridge.scene_from_jax(jscene)


def test_refit_scene_matches_jax(scenes):
    jscene, tscene = scenes
    rs = np.random.RandomState(0)
    m = np.stack([_rigid(rs, scale=rs.uniform(0.5, 2.0)) for _ in range(14)])
    ref = jdyn.refit_scene(jscene, jnp.asarray(m))
    got = tdyn.refit_scene(tscene, _t(m))
    np.testing.assert_allclose(got.tri_pos.numpy(), np.asarray(ref.tri_pos), rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(got.tri_normal.numpy(), np.asarray(ref.tri_normal), rtol=0,
                               atol=DIR_ATOL)
    np.testing.assert_allclose(got.tri_tangent.numpy(), np.asarray(ref.tri_tangent), rtol=0,
                               atol=DIR_ATOL)
    for f in ("tri_uv", "tri_mat", "tri_mesh_id"):
        assert getattr(got, f) is getattr(tscene, f)
    # the identity leaves the positions as they were, bit for bit; the
    # directions are renormalized
    same = tdyn.refit_scene(tscene, tdyn.identity_transforms(14))
    assert torch.equal(same.tri_pos, tscene.tri_pos)
    for f in ("tri_normal", "tri_tangent"):
        np.testing.assert_allclose(getattr(same, f).numpy(), getattr(tscene, f).numpy(), atol=2e-7)


def test_refit_moves_only_the_instance(scenes):
    """tests/test_dynamic.py's first test on the port: a pure translation
    moves the hero's triangles and nothing else, and turns no normal."""
    _, tscene = scenes
    m = tdyn.identity_transforms(14).clone()
    m[HERO, 0, 3] = 1.0
    moved = tdyn.refit_scene(tscene, m)
    inst = tscene.tri_mesh_id.numpy()
    base, new = tscene.tri_pos.numpy(), moved.tri_pos.numpy()
    np.testing.assert_allclose(new[inst != HERO], base[inst != HERO], atol=1e-6)
    np.testing.assert_allclose(new[inst == HERO][..., 0], base[inst == HERO][..., 0] + 1.0, atol=1e-5)
    np.testing.assert_allclose(new[inst == HERO][..., 1:], base[inst == HERO][..., 1:], atol=1e-6)
    np.testing.assert_allclose(moved.tri_normal.numpy(), tscene.tri_normal.numpy(), atol=1e-6)


def test_motion_deltas_and_prev_positions_match_jax():
    rs = np.random.RandomState(1)
    cur = np.stack([_rigid(rs) for _ in range(5)])
    prev = np.stack([_rigid(rs) for _ in range(5)])
    ref = np.asarray(jdyn.motion_deltas(jnp.asarray(cur), jnp.asarray(prev)))
    got = tdyn.motion_deltas(_t(cur), _t(prev))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=DELTA_ATOL)
    pos = rs.uniform(-30, 30, size=(7, 9, 3)).astype(np.float32)
    ids = rs.randint(-1, 5, size=(7, 9)).astype(np.int32)
    pref = np.asarray(jdyn.prev_positions(jnp.asarray(pos), jnp.asarray(ids), jnp.asarray(ref)))
    pgot = tdyn.prev_positions(_t(pos), _t(ids), _t(ref)).numpy()
    np.testing.assert_allclose(pgot, pref, rtol=0, atol=DELTA_ATOL)
    np.testing.assert_array_equal(pgot[ids < 0], pos[ids < 0])
    # a current position mapped back lands where the previous pose put it
    p0 = rs.uniform(-1, 1, size=3).astype(np.float32)
    at_cur = (cur[2] @ np.append(p0, 1.0))[:3]
    back = tdyn.prev_positions(_t(at_cur[None].astype(np.float32)),
                               torch.tensor([2], dtype=torch.int32), got).numpy()[0]
    np.testing.assert_allclose(back, (prev[2] @ np.append(p0, 1.0))[:3], atol=1e-4)
    np.testing.assert_array_equal(tdyn.identity_transforms(3).numpy(),
                                  np.asarray(jdyn.identity_transforms(3)))


# ---------------------------------------------------------------------------
# the trace structures, refitted
# ---------------------------------------------------------------------------


def _expected_wide(ts_base, ts):
    """K2's records over `ts`'s boxes in the base tree's grouping, built by
    a host loop: each used slot holds the box of the binary node
    ``pack_wide_nodes`` put there, unused slots zeros, words unchanged."""
    _, src = tbvh.pack_wide_nodes(ts_base.nodes_min, ts_base.nodes_max, ts_base.nodes_meta)
    src = src.numpy()
    lo, hi = ts.nodes_min.numpy(), ts.nodes_max.numpy()
    M = src.shape[0]
    boxes = np.zeros((M, 6, tbvh.WIDE), np.float32)
    for w in range(M):
        for slot in range(tbvh.WIDE):
            if src[w, slot] >= 0:
                boxes[w, 0:3, slot] = lo[src[w, slot]]
                boxes[w, 3:6, slot] = hi[src[w, slot]]
    return np.concatenate([boxes.reshape(M, -1).view(np.int32),
                           ts_base.wide_packed[:, 6 * tbvh.WIDE:].numpy()], axis=1)


def _probe_rays(scene, n, rs):
    lo, hi = [v.numpy() for v in scene.aabb()]
    ext = hi - lo
    o = rs.uniform(lo - 0.1 * ext, hi + 0.1 * ext, (n, 3)).astype(np.float32)
    cent = scene.tri_pos.numpy().mean(axis=1)
    d = cent[rs.randint(0, cent.shape[0], n)] - o + rs.normal(scale=0.5, size=(n, 3))
    d[: n // 4] = rs.normal(size=(n // 4, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.uniform(size=n) < 0.5, 1e5, rs.uniform(0.5, 20.0, n))
    return _t(o), _t(d.astype(np.float32)), _t(t_max.astype(np.float32))


@pytest.mark.parametrize("name,instance", [("shadows_test", HERO), ("gi_test", 3)])
def test_refitted_trace_scene(name, instance):
    """The tree refitted over a moved soup: every leaf box is its moved
    triangles' bounds and every inner box the union of its children's;
    the packed records and K2's 4-wide records equal their host-built
    counterparts bit for bit; the identity refit reproduces the built
    tree; and the plain walks and K2's wide walk on the refitted tree
    answer as brute force on the moved soup does."""
    from hybrid_rendering_torch.scene import scenes as tscenes

    scene = tscenes.load_scene(name)[0]
    ts = tbvh.make_trace_scene(scene)
    same = tbvh.refit_trace_scene(ts, scene)
    for f in ("nodes_min", "nodes_max", "nodes_packed", "tris_packed", "wide_packed", "attrs"):
        assert torch.equal(getattr(same, f), getattr(ts, f)), f

    rs = np.random.RandomState(7)
    num_i = int(scene.tri_mesh_id.max()) + 1
    m = np.tile(np.eye(4, dtype=np.float32), (num_i, 1, 1))
    m[instance] = _rigid(rs)
    moved = tdyn.refit_scene(scene, _t(m))
    rts = tbvh.refit_trace_scene(ts, moved)
    meta = rts.nodes_meta.numpy().astype(np.int64)
    lo, hi, tp = rts.nodes_min.numpy(), rts.nodes_max.numpy(), moved.tri_pos.numpy()
    for i in range(meta.shape[0]):
        if meta[i, 1] > 0:
            span = tp[meta[i, 0]:meta[i, 0] + meta[i, 1]].reshape(-1, 3)
            want_lo, want_hi = span.min(0), span.max(0)
        else:
            kids = [i + 1, meta[i + 1, 2]]
            want_lo, want_hi = lo[kids].min(0), hi[kids].max(0)
        np.testing.assert_array_equal(lo[i], want_lo)
        np.testing.assert_array_equal(hi[i], want_hi)
    assert not np.array_equal(lo, ts.nodes_min.numpy())  # the refit moved boxes
    assert torch.equal(rts.nodes_packed, tbvh.pack_nodes(rts.nodes_min, rts.nodes_max,
                                                         rts.nodes_meta))
    assert torch.equal(rts.tris_packed, tbvh.pack_tris(moved.tri_pos))
    assert torch.equal(rts.attrs, tbvh.attr_table(moved))
    np.testing.assert_array_equal(rts.wide_packed.numpy(), _expected_wide(ts, rts))

    o, d, t_max = _probe_rays(moved, 4096, rs)
    hit = tbvh.traverse(rts, o, d, t_max)
    ref = tintersect.closest_hit_brute(moved.tri_pos, o, d, t_max)
    assert torch.equal(hit.valid, ref.valid)
    differ = hit.tri_id != ref.tri_id
    # another id only where the two t agree to 1e-5: a ray through an edge
    # two triangles share hits both, and the two tracers round t apart
    np.testing.assert_allclose(hit.t[differ].numpy(), ref.t[differ].numpy(), rtol=1e-5)
    assert differ.float().mean() < 0.01
    np.testing.assert_allclose(hit.t[hit.valid].numpy(), ref.t[hit.valid].numpy(), rtol=1e-5)
    vis = tbvh.visibility_plain(rts, o, d, t_max)
    assert torch.equal(vis, tintersect.occluded_brute(moved.tri_pos, o, d, t_max))
    assert torch.equal(_wide_walk(rts, o, d, t_max)[0], vis)
    assert 0.05 < hit.valid.float().mean() < 0.95 and 0.05 < vis.mean() < 0.95


def test_refit_accel_by_method(scenes):
    _, tscene = scenes
    moved = tdyn.refit_scene(tscene, _t(hero_transforms(2)))
    fs = tbvh.refit_accel(None, moved, "flash_dense")
    assert fs.num_tris == tscene.num_triangles and torch.equal(fs.attrs, tbvh.attr_table(moved))
    assert tbvh.refit_accel(None, moved, "brute") is None
    with pytest.raises(ValueError):
        tbvh.refit_accel(None, moved, "nope")


def test_posed_tracers_call_the_animator_once_a_frame(scenes):
    """Frames in order call the animator once each (the last frame's
    transforms are the next one's previous pose); a frame out of order asks
    for its previous pose again. The deltas are those of the two poses,
    bit for bit."""
    _, tscene = scenes
    calls = []

    def animator(f):
        calls.append(f)
        return _t(hero_transforms(f))

    sk = tsky.ProceduralSky.create(sun_direction=np.asarray([0.4, 0.85, 0.3]))
    r = trenderer.HybridRenderer(tscene, tcfg.RendererConfig(width=W, height=H), sk.radiance,
                                 device="cpu", animator=animator)
    for f in (0, 1, 2, 5):
        _, _, deltas = r.posed_tracers(f)
        ref = tdyn.motion_deltas(_t(hero_transforms(f)), _t(hero_transforms(max(f - 1, 0))))
        assert torch.equal(deltas, ref), f
    assert calls == [0, 1, 2, 4, 5]


# ---------------------------------------------------------------------------
# the motion plane and the whole frame
# ---------------------------------------------------------------------------


def test_render_gbuffer_motion_matches_jax(scenes):
    """A static camera over the hero moved between two frames: every plane
    against JAX's ``render_gbuffer(motion_deltas=)`` on the same moved
    soup (brute force there, the refitted walk here), the motion non-zero
    on the hero and at most 1e-4 on static geometry."""
    jscene, tscene = scenes
    w, h = 96, 64
    kw = dict(eye=(0.0, 4.0, 8.0), target=(0.0, 1.5, 0.0), width=w, height=h)
    jc0 = jcam.make_camera(**kw)
    jc = jcam.make_camera(**kw, prev_view_proj=np.asarray(jc0.view_proj))
    tc = tcam.make_camera(**kw, prev_view_proj=tcam.make_camera(**kw).view_proj)
    cur, prev = hero_transforms(2), hero_transforms(1)
    jmoved = jdyn.refit_scene(jscene, jnp.asarray(cur))
    jgb = jgbuffer.render_gbuffer(jmoved, jbvh.make_surface_tracer(jmoved), jc, w, h,
                                  motion_deltas=jdyn.motion_deltas(jnp.asarray(cur),
                                                                   jnp.asarray(prev)))
    tmoved = tdyn.refit_scene(tscene, _t(cur))
    accel = tbvh.refit_accel(tbvh.make_accel(tscene), tmoved)
    tgb = tgbuffer.render_gbuffer(tbvh.make_surface_tracer(tmoved, accel), tc, w, h,
                                  motion_deltas=tdyn.motion_deltas(_t(cur), _t(prev)))
    for f in dataclasses.fields(tgb):
        got, ref = getattr(tgb, f.name).numpy(), np.asarray(getattr(jgb, f.name))
        atol = MOTION_ATOL if f.name == "motion" else GBUFFER_TOL[0]
        outside, worst = _share_outside(got, ref, atol)
        assert outside <= GBUFFER_TOL[1], (f.name, outside, worst)
    mesh, motion = tgb.mesh_id.numpy(), np.abs(tgb.motion.numpy()).max(-1)
    assert (mesh == HERO).sum() > 100
    assert np.median(motion[mesh == HERO]) > 1.0 / w
    assert motion[(mesh >= 0) & (mesh != HERO)].max() <= 1e-4


def _small_scene(build, prim):
    """A ground, a box that moves (instance 1), a static box and a static
    sphere: the animated frame's scene, small enough for the JAX side's
    brute-force tracer (its refitted scene has no BVH)."""
    b = build.SceneBuilder()
    M = build.MaterialDef
    b.add_instance(prim.plane(12.0, 12.0), b.add_material(M(albedo=(0.7, 0.7, 0.7), roughness=0.9)))
    b.add_instance(prim.box(1.0, 1.0, 1.0), b.add_material(M(albedo=(0.8, 0.2, 0.1), roughness=0.3)),
                   build.translation(-1.0, 0.5, 0.0))
    b.add_instance(prim.box(0.8, 2.0, 0.8), b.add_material(M(albedo=(0.2, 0.5, 0.8), roughness=0.6)),
                   build.translation(1.5, 1.0, -1.0))
    b.add_instance(prim.uv_sphere(0.6, 8, 16),
                   b.add_material(M(albedo=(0.9, 0.9, 0.9), roughness=0.1, metallic=0.8)),
                   build.translation(0.5, 0.6, 1.2))
    return b.build(use_bvh=True)


def box_transforms(frame):
    """The small scene's box moved by (0.3, 0.1, 0.2) a frame; the rest at
    identity. It does not turn: a turned face's normals are not
    axis-aligned, and their ulp noise decides the reflections'
    ``curvature == 0`` test (ROADMAP §3) differently in the two packages
    on a few pixels (measured with 0.4 rad a frame: 1-3 flips a frame, the
    deferred plane 0.5% of pixels beyond 1e-3, max 1.8e-3, where 0.1% is
    less than a pixel at 32x24). Turning instances are held by
    test_refit_scene_matches_jax, test_refitted_trace_scene and
    test_render_gbuffer_motion_matches_jax."""
    m = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    m[1, :3, 3] = np.float32([0.3, 0.1, 0.2]) * frame
    return m


def test_animated_frames_match_jax_renderer(monkeypatch):
    """A small scene with one box animated, DDGI and reflections on, at
    32x24: three frames of a moving camera through the JAX renderer
    (jitted; the animator indexes a table of transforms by the traced
    frame index, and the refitted scene's surfaces come from the
    attribute rows, as on its main path) and the port
    (``HybridRenderer(animator=)`` refitting its tree), plane by plane,
    with test_torch_slice.py's tolerances; the cameras are rolled
    (test_torch_textures.py ``rolled_cameras``)."""
    from hybrid_rendering_tpu.scene import build as jbuild
    from hybrid_rendering_tpu.scene import primitives as jprim
    from hybrid_rendering_tpu.types import Light as JLight

    table = np.stack([box_transforms(f) for f in range(4)])
    jtable = jnp.asarray(table)
    # the refitted JAX scene has no BVH: its surface tracer would fetch by
    # triangle id (the CPU path); take the attribute rows instead
    monkeypatch.setattr(jbvh, "make_surface_tracer",
                        lambda scene, *a, **k: jax_attr_surface_tracer(scene))

    def config(m):
        return m.RendererConfig(
            width=W, height=H, debug_outputs=True,
            shadows=m.ShadowsConfig(scale=m.RayTraceScale.FULL),
            ao=m.AOConfig(scale=m.RayTraceScale.HALF),
            reflections=m.ReflectionsConfig(scale=m.RayTraceScale.HALF),
            ddgi=m.DDGIConfig(probe_distance=3.0, rays_per_probe=64),
            taa=m.TAAConfig(enabled=True))

    jscene = _small_scene(jbuild, jprim)
    light = JLight.directional((0.4, 0.85, 0.3), intensity=3.0)
    sky = jsky.ProceduralSky.create(sun_direction=np.asarray(light.direction))
    tsk = tsky.ProceduralSky.create(sun_direction=np.asarray(light.direction))
    jr = jrenderer.HybridRenderer(jscene, config(jcfg), sky.radiance,
                                  *jsh.make_env_fallbacks(sky.radiance),
                                  animator=lambda f: jtable[f])
    tc = config(tcfg)
    tr = trenderer.HybridRenderer(bridge.scene_from_jax(jscene), tc, tsk.radiance,
                                  *tsh.make_env_fallbacks(tsk.radiance), device="cpu",
                                  animator=lambda f: _t(table[f]))
    tl = bridge.light_from_jax(light)
    jstate, tstate = jr.create_state(), tr.create_state()
    jstep = jax.jit(jr.render_frame)
    jprev = tprev = None
    report, failed = [], []
    for f in range(3):
        eye, target = (0.5 + 0.2 * f, 3.5, 6.0), (0.0, 0.6, 0.0)
        jcm, tcm = rolled_cameras(jr, tr, eye, target, f, jprev, tprev)
        jprev, tprev = np.asarray(jcm.view_proj), tcm.view_proj
        jout, jstate = jstep(jstate, jcm, light)
        tout, tstate = tr.render_frame(tstate, tcm, tl)
        assert sorted(tout) == sorted(jout)
        for key in sorted(jout):
            got, ref = tout[key].numpy(), np.asarray(jout[key])
            if key.startswith("gbuffer"):
                atol, share = GBUFFER_TOL
            elif key in ("taa", "ldr"):
                atol, share = TAA_TOL
            elif key in REFL_TEMPORAL_PLANES:
                atol, share = REFL_TEMPORAL_TOL
            else:
                atol, share = SHADED_TOL
            outside, worst = _share_outside(got, ref, atol)
            report.append(f"frame {f} {key}: {outside:.4%} beyond {atol} (max {worst:.3g})")
            if outside > share or (key in ("taa", "ldr") and worst > TAA_MAX) or (
                    key in REFL_TEMPORAL_PLANES and worst > REFL_MAX):
                failed.append(report[-1])
    print("\n".join(report))
    assert not failed, failed
    # the box moved: the last frame's G-buffer is not the static scene's,
    # and its motion plane is not the camera's alone
    static = trenderer.HybridRenderer(tr.scene, tc, tsk.radiance, device="cpu")
    gb = tgbuffer.render_gbuffer(static.closest_surface_fn, tcm, W, H)
    moved = tstate.prev_gbuffer
    assert (gb.mesh_id != moved.mesh_id).sum() > 5
    box = moved.mesh_id == 1
    assert (moved.motion - gb.motion)[box & (gb.mesh_id == 1)].abs().max() > 1e-3


# ---------------------------------------------------------------------------
# the leftovers of ported modules
# ---------------------------------------------------------------------------


def _leftover_inputs():
    rs = np.random.RandomState(4)
    kw = dict(eye=(3.0, 2.0, 5.0), target=(0.0, 0.5, 0.0), width=40, height=30,
              jitter=(0.01, -0.02))
    return rs, jcam.make_camera(**kw), tcam.make_camera(**kw)


@pytest.mark.parametrize("name", ["transform_point", "transform_point_noperspective",
                                  "transform_dir", "world_position_from_depth",
                                  "linear_eye_depth", "diffuse_from_metallic", "pixel_uv"])
def test_leftover_helpers_match_jax(name):
    """math3d's transforms and depth helpers, brdf.diffuse_from_metallic
    and camera.pixel_uv against the JAX package: elementwise and 4x4
    products of the same float32 inputs, held to 1e-6 relative to the
    values' scale (einsum sums in its own order on each side); the
    reconstruction from depth to 2e-5 relative: near the far plane it
    divides by a w of ~1e-3, which scales the sum's last-bit difference
    (measured 4.2e-6)."""
    from hybrid_rendering_tpu.ops import brdf as jbrdf
    from hybrid_rendering_tpu.ops import math3d as jm
    from hybrid_rendering_torch.ops import brdf as tbrdf
    from hybrid_rendering_torch.ops import math3d as tm

    rs, jc, tc = _leftover_inputs()
    p = rs.uniform(-10, 10, size=(6, 7, 3)).astype(np.float32)
    if name == "pixel_uv":
        got, ref = tcam.pixel_uv(40, 30).numpy(), np.asarray(jcam.pixel_uv(40, 30))
    elif name == "diffuse_from_metallic":
        m = rs.uniform(size=(6, 7)).astype(np.float32)
        got = tbrdf.diffuse_from_metallic(_t(p), _t(m)).numpy()
        ref = np.asarray(jbrdf.diffuse_from_metallic(jnp.asarray(p), jnp.asarray(m)))
    elif name == "world_position_from_depth":
        uv = rs.uniform(size=(6, 7, 2)).astype(np.float32)
        z = rs.uniform(0.5, 0.999, size=(6, 7)).astype(np.float32)
        got = tm.world_position_from_depth(_t(uv), _t(z), tc.view_proj_inverse).numpy()
        ref = np.asarray(jm.world_position_from_depth(jnp.asarray(uv), jnp.asarray(z),
                                                      jc.view_proj_inverse))
    elif name == "linear_eye_depth":
        z = rs.uniform(0.0, 1.0, size=(6, 7)).astype(np.float32)
        np.testing.assert_array_equal(np.float32(tc.z_buffer_params),
                                      np.asarray(jc.z_buffer_params))
        got = tm.linear_eye_depth(_t(z), tc.z_buffer_params).numpy()
        ref = np.asarray(jm.linear_eye_depth(jnp.asarray(z), jc.z_buffer_params))
    else:
        got = getattr(tm, name)(tc.view_proj, _t(p)).numpy()
        ref = np.asarray(getattr(jm, name)(jc.view_proj, jnp.asarray(p)))
    assert got.shape == ref.shape
    rtol = 2e-5 if name == "world_position_from_depth" else 1e-6
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-6 * np.abs(ref).max())
