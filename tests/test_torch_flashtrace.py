"""PyTorch port vs JAX package: the dense FlashTrace tracer — the scene
columns, the plain versions of kernels K6 (closest hit, with and without
the winner's attribute row) and K6′ (any-hit visibility), and
``make_tracers(method="flash_dense")``. The JAX side runs its Pallas
kernels in interpret mode, as tests/test_flashtrace.py does. Inputs come
from numpy with fixed seeds.

Tolerances (measured values in brackets, on these inputs): hit/miss agree
on >= 99.9% of rays [100%]; triangle ids on >= 99.5% [100%] (XLA's dot
order vs the port's left-to-right sums can flip ties at shared edges);
where the ids agree, t within 1e-5 (1 + |t|) on >= 99.9% of rays [100%]
and within 1e-3 (1 + |t|) on all [max 4.6e-7 (1 + |t|)] (the affine
product cancels near large walls, which amplifies ulp-level order
differences), u and v within 1e-4 [max 4.4e-5], attribute rows equal;
visibility agrees on >= 99.9% of live rays [100%]."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hybrid_rendering_tpu.ops import bvh as jbvh
from hybrid_rendering_tpu.ops.pallas import flashtrace as jflash
from hybrid_rendering_tpu.scene import scenes as jscenes
from hybrid_rendering_tpu.utils import camera as jcam
from hybrid_rendering_torch import bridge
from hybrid_rendering_torch.ops import bvh as tbvh
from hybrid_rendering_torch.ops import flashtrace as tflash

CAM_W, CAM_H = 64, 48


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_tris(n, seed=0, scale=3.0):
    rs = np.random.RandomState(seed)
    base = rs.uniform(-scale, scale, size=(n, 1, 3))
    offs = rs.uniform(-0.4, 0.4, size=(n, 3, 3))
    return (base + offs).astype(np.float32)


def _random_rays(n, tri, seed):
    """Random rays, half aimed at triangle centroids; t_max mixes unbounded,
    short and masked (t_max = 0) rays."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-5.0, 5.0, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    cent = tri.mean(axis=1)
    k = n // 2
    d[:k] = cent[rs.randint(0, cent.shape[0], k)] + rs.normal(scale=0.05, size=(k, 3)) - o[:k]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.uniform(size=n) < 0.5, 1e5, rs.uniform(0.5, 8.0, n)).astype(np.float32)
    t_max[rs.uniform(size=n) < 0.1] = 0.0
    return o, d.astype(np.float32), t_max


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in ("gi_test", "shadows_test"):
        jscene, light, camkw = jscenes.load_scene(name)
        tscene = bridge.scene_from_jax(jscene)
        jfs = jflash.make_flash_scene(jscene.tri_pos, jscene.tri_normal, jscene.tri_uv,
                                      jscene.tri_mat, jscene.tri_mesh_id, jscene.tri_tangent)
        tfs = tflash.make_flash_scene(tscene.tri_pos, tbvh.attr_table(tscene))
        out[name] = (jscene, tscene, jfs, tfs, light, camkw)
    return out


def _camera_rays(camkw):
    cam = jcam.make_camera(width=CAM_W, height=CAM_H, **camkw)
    o, d = jcam.camera_rays(cam, CAM_W, CAM_H)
    return np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)


def _check_closest(hit, ref, t_max, attrs=None, ref_attrs=None):
    gid, rid = hit.tri_id.numpy(), np.asarray(ref.tri_id)
    assert ((gid >= 0) == (rid >= 0)).mean() >= 0.999
    assert (gid == rid).mean() >= 0.995
    agree = (gid == rid) & (gid >= 0)
    t, rt = hit.t.numpy()[agree], np.asarray(ref.t)[agree]
    scale = 1.0 + np.abs(rt)
    assert (np.abs(t - rt) <= 1e-5 * scale).mean() >= 0.999
    assert (np.abs(t - rt) <= 1e-3 * scale).all()
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(hit, f).numpy()[agree],
                                   np.asarray(getattr(ref, f))[agree], atol=1e-4, err_msg=f)
    miss = gid < 0
    np.testing.assert_array_equal(hit.t.numpy()[miss], t_max[miss])
    assert (hit.u.numpy()[miss] == 0).all() and (hit.v.numpy()[miss] == 0).all()
    if attrs is not None:
        np.testing.assert_array_equal(attrs.numpy()[agree], np.asarray(ref_attrs)[agree])
        assert (attrs.numpy()[miss] == 0).all()
    return agree


def _cols_from_jax(jfs, T):
    """JAX's (16, NTT*4*128) tile-blocked trimat -> (10, 4, T): the
    coefficient of feature k in det/t/u/v of each triangle."""
    m = np.asarray(jfs.trimat).reshape(jflash.FEAT, jfs.num_tri_tiles, 4, jflash.TRI_TILE)
    return m.transpose(0, 2, 1, 3).reshape(jflash.FEAT, 4, -1)[:tflash.FEAT, :, :T]


def _cols_from_coef(coef):
    """The port's (T, 20) record of non-zero coefficients -> (10, 4, T),
    zero where NONZERO has no entry."""
    cols = np.zeros((tflash.FEAT, 4, coef.shape[0]), np.float32)
    off = 0
    for q, ks in enumerate(tflash.NONZERO):
        cols[list(ks), q] = coef[:, off:off + len(ks)].T
        off += len(ks)
    assert off == tflash.COEF - 1
    return cols


@pytest.mark.parametrize("source", ["random37", "random600", "gi_test", "shadows_test"])
def test_scene_columns_match_jax(scenes, source):
    if source.startswith("random"):
        tri = _random_tris(int(source[6:]), seed=2)
        jfs, tfs = jflash.make_flash_scene(jnp.asarray(tri)), tflash.make_flash_scene(_t(tri))
    else:
        _, _, jfs, tfs, _, _ = scenes[source]
        np.testing.assert_array_equal(tfs.attrs.numpy(), np.asarray(jfs.attrs)[:tfs.num_tris])
    T = tfs.num_tris
    np.testing.assert_allclose(tfs.center.numpy(), np.asarray(jfs.center), rtol=1e-6, atol=1e-6)
    # XLA contracts the cross products' a*b - c*d into fused multiply-adds
    # on the CPU, so an entry that cancels (e.g. -0.75 from products ~100)
    # differs by ulps of the products: 1e-6 of the triangle's largest
    # coefficient [measured 1.2e-7]
    # the record holds the non-zero coefficients in NONZERO's order, then
    # a zero pad; every coefficient it leaves out is zero on the JAX side.
    # Zero rows follow the last triangle up to a whole tile of K6's scan
    coef = tfs.coef.numpy()
    assert coef.shape == (-(-T // tflash.TILE) * tflash.TILE, tflash.COEF)
    assert not coef[T:].any()
    coef = coef[:T]
    assert (coef[:, -1] == 0).all()
    ref = _cols_from_jax(jfs, T)
    scale = np.abs(ref).max(axis=(0, 1))
    assert (np.abs(_cols_from_coef(coef) - ref) <= 1e-6 * scale).all()


@pytest.mark.parametrize("ntri", [37, 600])  # below and above the 128-triangle tile
def test_plain_k6_k6p_match_jax_on_random_triangles(ntri):
    tri = _random_tris(ntri, seed=2)
    o, d, t_max = _random_rays(400, tri, seed=3)
    jfs, tfs = jflash.make_flash_scene(jnp.asarray(tri)), tflash.make_flash_scene(_t(tri))
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    ref = jflash.flash_closest_hit(jfs, *args, interpret=True)
    hit = tflash.flash_closest_hit(tfs, _t(o), _t(d), _t(t_max))
    agree = _check_closest(hit, ref, t_max)
    assert agree.sum() > 60
    ref_vis = np.asarray(jflash.flash_visibility(jfs, *args, interpret=True))
    vis = tflash.flash_visibility(tfs, _t(o), _t(d), _t(t_max)).numpy()
    live = t_max > 1e-3
    assert (vis[live] == ref_vis[live]).mean() >= 0.999
    assert 0.1 < vis[live].mean() < 0.9
    # the masked-ray rule: blocked on both sides
    assert (vis[~live] == 0).all() and (ref_vis[~live] == 0).all()


@pytest.mark.parametrize("name", ["gi_test", "shadows_test"])
def test_plain_k6_k6p_match_jax_on_camera_rays(scenes, name):
    """Primary rays of the scene's camera at 64x48 (closest hit with
    attribute rows), then shadow rays from the hits toward the light."""
    jscene, tscene, jfs, tfs, light, camkw = scenes[name]
    o, d = _camera_rays(camkw)
    t_max = np.full(o.shape[0], 1e5, np.float32)
    ref, ref_attrs = jflash.flash_closest_hit_attrs(
        jfs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), interpret=True)
    hit, attrs = tflash.flash_closest_hit_attrs(tfs, _t(o), _t(d), _t(t_max))
    agree = _check_closest(hit, ref, t_max, attrs, ref_attrs)
    assert agree.mean() > 0.3

    valid = hit.tri_id.numpy() >= 0
    p = o + hit.t.numpy()[:, None] * d
    n = attrs.numpy()[:, 17:20]
    n = np.where((n * d).sum(1, keepdims=True) > 0, -n, n)
    so = (p + 0.01 * n).astype(np.float32)
    sd = np.broadcast_to(np.asarray(light.direction, np.float32), so.shape).copy()
    st = np.where(valid, 1e4, 0.0).astype(np.float32)
    ref_vis = np.asarray(jflash.flash_visibility(
        jfs, jnp.asarray(so), jnp.asarray(sd), jnp.asarray(st), interpret=True))
    vis = tflash.flash_visibility(tfs, _t(so), _t(sd), _t(st)).numpy()
    assert (vis[valid] == ref_vis[valid]).mean() >= 0.999
    assert (vis[~valid] == 0).all()


def test_masked_rays_blocked_and_t_max_respected():
    tri = np.asarray([[[-5.0, -5.0, -3.0], [5.0, -5.0, -3.0], [0.0, 5.0, -3.0]]], np.float32)
    o = np.zeros((3, 3), np.float32)
    d = np.tile(np.asarray([0.0, 0.0, -1.0], np.float32), (3, 1))
    t_max = np.asarray([10.0, 1.0, 0.0], np.float32)
    tfs = tflash.make_flash_scene(_t(tri))
    hit = tflash.flash_closest_hit(tfs, _t(o), _t(d), _t(t_max))
    assert hit.tri_id.tolist() == [0, -1, -1]
    assert abs(hit.t[0].item() - 3.0) < 1e-5 and hit.t[1:].tolist() == [1.0, 0.0]
    vis = tflash.flash_visibility(tfs, _t(o), _t(d), _t(t_max))
    # hit within t_max: blocked; t_max short of the triangle: visible;
    # t_max = 0 (masked): blocked, the flash rule (K2's walk says visible)
    assert vis.tolist() == [0.0, 1.0, 0.0]
    jfs = jflash.make_flash_scene(jnp.asarray(tri))
    ref = jflash.flash_visibility(jfs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                  interpret=True)
    assert np.asarray(ref).tolist() == vis.tolist()


def test_plain_version_chunks_give_the_same_result(scenes, monkeypatch):
    """The plain version's ray chunks (CHUNK_PAIRS) change nothing."""
    _, _, _, tfs, _, camkw = scenes["gi_test"]
    o, d = _camera_rays(camkw)
    t_max = _t(np.full(o.shape[0], 1e5, np.float32))
    whole = tflash.flash_closest_hit_attrs(tfs, _t(o), _t(d), t_max)
    vis = tflash.flash_visibility(tfs, _t(o), _t(d), t_max)
    monkeypatch.setattr(tflash, "CHUNK_PAIRS", 7 * tfs.num_tris)
    chunked = tflash.flash_closest_hit_attrs(tfs, _t(o), _t(d), t_max)
    for f in ("t", "u", "v", "tri_id"):
        assert torch.equal(getattr(whole[0], f), getattr(chunked[0], f)), f
    assert torch.equal(whole[1], chunked[1])
    assert torch.equal(vis, tflash.flash_visibility(tfs, _t(o), _t(d), t_max))


def test_cpu_tensors_take_plain_path_and_other_devices_are_refused(scenes):
    _, _, _, tfs, _, camkw = scenes["gi_test"]
    o, d = _camera_rays(camkw)
    o, d, t_max = _t(o[:64]), _t(d[:64]), torch.full((64,), 1e5)
    tflash.flash_closest_hit(tfs, o, d, t_max)
    tflash.flash_closest_hit_attrs(tfs, o, d, t_max)
    tflash.flash_visibility(tfs, o, d, t_max)
    assert (tflash.flash_closest_hit.launches, tflash.flash_closest_hit_attrs.launches,
            tflash.flash_visibility.launches) == (0, 0, 0)
    m = torch.zeros((4, 3), device="meta")
    for fn in (tflash.flash_closest_hit, tflash.flash_closest_hit_attrs,
               tflash.flash_visibility):
        with pytest.raises(ValueError, match="meta"):
            fn(tfs, m, m, torch.zeros(4, device="meta"))


def test_make_tracers_flash_dense_with_many(scenes):
    """make_tracers / make_surface_tracer(method="flash_dense") against the
    JAX package's: image requests in 16x16 blocks, .many split per
    request; unknown methods are refused."""
    jscene, tscene, _, _, _, camkw = scenes["gi_test"]
    cam = jcam.make_camera(width=32, height=16, **camkw)
    o, d = (np.asarray(a) for a in jcam.camera_rays(cam, 32, 16))
    rs = np.random.RandomState(5)
    o2 = rs.uniform(-3, 3, (50, 3)).astype(np.float32)
    d2 = rs.normal(size=(50, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)

    jclosest, jvis = jbvh.make_tracers(jscene, method="flash_dense")
    tclosest, tvis = tbvh.make_tracers(tscene, method="flash_dense")
    jh = jclosest(jnp.asarray(o), jnp.asarray(d), 1e4)
    th = tclosest(_t(o), _t(d), 1e4)
    assert th.tri_id.shape == (16, 32)
    assert (th.tri_id.numpy() == np.asarray(jh.tri_id)).mean() >= 0.995
    jv_img, jv_flat = jvis.many([(jnp.asarray(o), jnp.asarray(d), 6.0),
                                 (jnp.asarray(o2), jnp.asarray(d2), 3.0)])
    tv_img, tv_flat = tvis.many([(_t(o), _t(d), 6.0), (_t(o2), _t(d2), 3.0)])
    assert tv_img.shape == (16, 32) and tv_flat.shape == (50,)
    assert (tv_img.numpy() == np.asarray(jv_img)).mean() >= 0.999
    assert (tv_flat.numpy() == np.asarray(jv_flat)).mean() >= 0.98
    assert torch.equal(tv_img, tvis(_t(o), _t(d), 6.0))

    surf_fn = tbvh.make_surface_tracer(tscene, method="flash_dense")
    (h1, s1), (h2, s2) = surf_fn.many([(_t(o), _t(d), 1e4), (_t(o2), _t(d2), 1e4)])
    h_img, s_img = surf_fn(_t(o), _t(d), 1e4)
    assert s1.normal.shape == (16, 32, 3) and s2.normal.shape == (50, 3)
    assert torch.equal(h1.tri_id, h_img.tri_id) and torch.equal(h1.tri_id, th.tri_id)
    assert torch.equal(s1.position, s_img.position)
    with pytest.raises(ValueError, match="tracer method"):
        tbvh.make_tracers(tscene, method="rtx")


@pytest.mark.parametrize("method", ["bvh", "flash", "brute"])
def test_make_tracers_other_methods_match_auto(scenes, method):
    """"bvh" and "flash" are the walk that "auto" runs; "brute" is the
    plain oracle of ops/intersect.py, whose surfaces come from
    fetch_surface: the same hits and surfaces, and the walk's visibility,
    masked rays included [measured: every id and visibility equal, t
    within 3.8e-6 for "brute", equal for the others]."""
    _, tscene, _, _, _, camkw = scenes["gi_test"]
    o, d = (_t(a) for a in _camera_rays(camkw))
    ref_closest, ref_vis = tbvh.make_tracers(tscene)
    closest, vis = tbvh.make_tracers(tscene, method=method)
    ref, hit = ref_closest(o, d, 1e4), closest(o, d, 1e4)
    assert (hit.tri_id == ref.tri_id).float().mean() >= 0.999
    agree = (hit.tri_id == ref.tri_id) & hit.valid
    torch.testing.assert_close(hit.t[agree], ref.t[agree], rtol=1e-5, atol=1e-5)
    t_max = torch.where(torch.arange(o.shape[0]) % 7 == 0, 0.0, 3.0)
    assert (vis(o, d, t_max) == ref_vis(o, d, t_max)).float().mean() >= 0.999
    (_, surf), (_, ref_surf) = (tbvh.make_surface_tracer(tscene, method=m)(o, d, 1e4)
                                for m in (method, "auto"))
    for f in ("position", "normal", "albedo"):
        torch.testing.assert_close(getattr(surf, f)[agree], getattr(ref_surf, f)[agree],
                                   rtol=1e-4, atol=1e-4, msg=f)
