"""PyTorch port vs JAX package: the tracer (plain versions of kernels K1
closest-hit + attributes and K2 any-hit), the brute oracle, the tracer
interface and the surface fetch. Inputs come from numpy with fixed seeds;
the scene is the 64-triangle gi_test built by the JAX package and carried
across with the bridge."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hybrid_rendering_tpu.ops import bvh as jbvh
from hybrid_rendering_tpu.ops import intersect as jintersect
from hybrid_rendering_tpu.ops.pallas import flashtrace
from hybrid_rendering_tpu.scene import fetch as jfetch
from hybrid_rendering_tpu.scene import scenes as jscenes
from hybrid_rendering_torch import bridge
from hybrid_rendering_torch.ops import bvh as tbvh
from hybrid_rendering_torch.ops import intersect as tintersect
from hybrid_rendering_torch.ops import kernels
from hybrid_rendering_torch.scene import fetch as tfetch

N_RAYS = 4096


@pytest.fixture(scope="module")
def scenes():
    jscene, _, _ = jscenes.load_scene("gi_test")
    tscene = bridge.scene_from_jax(jscene)
    return jscene, tscene, tbvh.make_trace_scene(tscene)


@pytest.fixture(scope="module")
def rays(scenes):
    """Rays from inside and around the Cornell box, half aimed at triangle
    centroids; t_max mixes unbounded, short (so some any-hit rays end
    before their blocker) and masked (t_max = 0) rays."""
    jscene = scenes[0]
    rs = np.random.RandomState(7)
    o = rs.uniform([-6, -1, -6], [6, 11, 6], (N_RAYS, 3)).astype(np.float32)
    d = rs.normal(size=(N_RAYS, 3)).astype(np.float32)
    cent = np.asarray(jscene.tri_pos).mean(axis=1)
    k = N_RAYS // 2
    d[:k] = cent[rs.randint(0, cent.shape[0], k)] + rs.normal(scale=0.3, size=(k, 3)) - o[:k]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.uniform(size=N_RAYS) < 0.5, 1e4,
                     rs.uniform(0.5, 8.0, N_RAYS)).astype(np.float32)
    t_max[rs.uniform(size=N_RAYS) < 0.1] = 0.0
    return o, d.astype(np.float32), t_max


def _jax_traverse(jscene, o, d, t_max, any_hit=False):
    return jbvh.traverse(jscene.bvh_nodes_min, jscene.bvh_nodes_max,
                         jscene.bvh_nodes_meta, jscene.tri_pos, jnp.asarray(o),
                         jnp.asarray(d), jnp.asarray(t_max), any_hit=any_hit)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_plain_k1_matches_jax_traverse(scenes, rays):
    jscene, _, ts = scenes
    o, d, t_max = rays
    ref = _jax_traverse(jscene, o, d, t_max)
    hit, attrs = tbvh.closest_hit_attrs(ts, _t(o), _t(d), _t(t_max))
    ref_id = np.asarray(ref.tri_id)
    got_id = hit.tri_id.numpy()
    # same walk, same tests: hit or miss agrees on every ray, and the id on
    # all but ulp-level ties: gi_test's walls overlap at the corners, so a
    # ray can meet two coplanar triangles at the same t, and the last ulp
    # of the JAX reduction vs the port's written-out dot picks the winner
    np.testing.assert_array_equal(got_id >= 0, ref_id >= 0)
    assert (got_id >= 0).sum() > N_RAYS // 3
    tie = got_id != ref_id
    assert tie.sum() <= 0.005 * N_RAYS
    np.testing.assert_allclose(hit.t.numpy()[tie], np.asarray(ref.t)[tie], rtol=1e-6)
    sel = (got_id >= 0) & ~tie
    # the JAX walk sums its dot products with XLA reductions, the port
    # writes them out; a few ulp at t ~ 10
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(hit, f).numpy()[sel], np.asarray(getattr(ref, f))[sel],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    rows = ts.attrs.numpy()[got_id[sel]]
    np.testing.assert_array_equal(attrs.numpy()[sel], rows)
    assert (attrs.numpy()[got_id < 0] == 0).all()


def test_plain_k2_matches_jax_traverse_on_live_rays(scenes, rays):
    jscene, _, ts = scenes
    o, d, t_max = rays
    ref = _jax_traverse(jscene, o, d, t_max, any_hit=True)
    ref_vis = np.where(np.asarray(ref.tri_id) >= 0, 0.0, 1.0)
    vis = tbvh.visibility(ts, _t(o), _t(d), _t(t_max)).numpy()
    live = t_max > 0
    np.testing.assert_array_equal(vis[live], ref_vis[live])
    assert 0.1 < vis[live].mean() < 0.9
    # masked rays follow the bvh rule: visible
    assert (vis[~live] == 1.0).all()


def test_plain_k1_k2_match_flash_interpret(scenes, rays):
    """Against the Pallas kernels themselves (interpret mode). Flash
    computes in bf16x3 on the MXU: t at test_flashtrace.py's 3e-4, u/v at
    3e-3, attribute rows at 3e-3 (bf16 one-hot select); ids may differ on
    ties at shared edges and overlapping coplanar walls."""
    jscene, _, ts = scenes
    o, d, t_max = rays
    fs = flashtrace.make_flash_scene(jscene.tri_pos, jscene.tri_normal, jscene.tri_uv,
                                     jscene.tri_mat, jscene.tri_mesh_id, jscene.tri_tangent)
    live = t_max > 0
    o, d, t_max = o[live], d[live], t_max[live]
    fhit, fattrs = flashtrace.flash_closest_hit_attrs_sparse(
        fs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), interpret=True)
    hit, attrs = tbvh.closest_hit_attrs(ts, _t(o), _t(d), _t(t_max))
    fid, gid = np.asarray(fhit.tri_id), hit.tri_id.numpy()
    assert ((fid >= 0) == (gid >= 0)).mean() >= 0.999  # grazing rays
    sel = (gid >= 0) & (fid >= 0)
    agree = sel & (fid == gid)
    assert agree.sum() >= 0.99 * sel.sum()
    # t: test_flashtrace.py's 3e-4 on 99.5% of rays; the rest are rays that
    # start close to gi_test's large walls, where the affine bf16x3 product
    # loses more (measured up to 3.4e-3 at t ~ 2)
    dt = np.abs(hit.t.numpy() - np.asarray(fhit.t))[agree]
    t_ref = np.abs(hit.t.numpy()[agree])
    assert (dt <= 3e-4 + 3e-4 * t_ref).mean() >= 0.995
    assert (dt <= 5e-3 * (1.0 + t_ref)).all()
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(hit, f).numpy()[agree],
                                   np.asarray(getattr(fhit, f))[agree], atol=3e-3)
    np.testing.assert_allclose(attrs.numpy()[agree], np.asarray(fattrs)[agree], atol=3e-3)

    fvis = np.asarray(flashtrace.flash_visibility_sparse(
        fs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), interpret=True))
    vis = tbvh.visibility(ts, _t(o), _t(d), _t(t_max)).numpy()
    assert (fvis == vis).mean() >= 0.999


def test_surface_from_attrs_matches_jax_fetch_surface(scenes, rays):
    """The port builds the Surface from K1's attribute rows; the JAX
    package's CPU path gathers from the scene arrays. Normals are
    renormalized from the same floats (1e-5); the geometric normal comes
    from the row (precomputed) vs a fresh cross product (1e-5)."""
    jscene, tscene, ts = scenes
    o, d, t_max = rays
    ref_hit = _jax_traverse(jscene, o, d, t_max)
    ref = jfetch.fetch_surface(jscene, jnp.asarray(o), jnp.asarray(d), ref_hit)
    hit, attrs = tbvh.closest_hit_attrs(ts, _t(o), _t(d), _t(t_max))
    surf = tfetch.surface_from_attrs(tscene, _t(o), _t(d), hit, attrs)
    sel = hit.valid.numpy() & (hit.tri_id.numpy() == np.asarray(ref_hit.tri_id))
    assert sel.sum() > N_RAYS // 3
    for f in ("position", "normal", "geo_normal", "uv", "albedo", "roughness",
              "metallic", "emissive"):
        np.testing.assert_allclose(getattr(surf, f).numpy()[sel],
                                   np.asarray(getattr(ref, f))[sel],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    for f in ("mesh_id", "mat_id", "frontface"):
        np.testing.assert_array_equal(getattr(surf, f).numpy()[sel],
                                      np.asarray(getattr(ref, f))[sel], err_msg=f)
    assert (surf.mesh_id.numpy()[~hit.valid.numpy()] == -1).all()
    # the gather path of the port agrees with its attribute path
    gathered = tfetch.fetch_surface(tscene, _t(o), _t(d), hit)
    for f in ("normal", "geo_normal", "uv", "albedo", "mesh_id"):
        np.testing.assert_allclose(getattr(gathered, f).numpy()[sel],
                                   getattr(surf, f).numpy()[sel], atol=1e-5, err_msg=f)


def test_brute_oracle_matches_jax_and_walk(scenes, rays):
    jscene, tscene, ts = scenes
    o, d, t_max = rays
    ref = jintersect.closest_hit_brute(jscene.tri_pos, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(t_max))
    got = tintersect.closest_hit_brute(tscene.tri_pos, _t(o), _t(d), _t(t_max))
    # ids agree up to the coplanar ulp-level ties (see above)
    agree = got.tri_id.numpy() == np.asarray(ref.tri_id)
    assert agree.mean() >= 0.995
    sel = agree & (got.tri_id.numpy() >= 0)
    np.testing.assert_allclose(got.t.numpy()[sel], np.asarray(ref.t)[sel], rtol=1e-5, atol=1e-5)
    walk = tbvh.closest_hit_attrs(ts, _t(o), _t(d), _t(t_max))[0]
    np.testing.assert_array_equal(walk.tri_id.numpy(), got.tri_id.numpy())
    live = t_max > 0
    vis = tintersect.occluded_brute(tscene.tri_pos, _t(o), _t(d), _t(t_max)).numpy()
    ref_vis = np.asarray(jintersect.occluded_brute(jscene.tri_pos, jnp.asarray(o),
                                                   jnp.asarray(d), jnp.asarray(t_max)))
    np.testing.assert_array_equal(vis[live], ref_vis[live])


def test_tracer_interface_blocks_and_many(scenes):
    """make_tracers/make_surface_tracer keep the JAX interface: image
    requests are traced in 16x16 pixel blocks and come back in image
    layout; .many runs several requests in one launch, split per request
    exactly as the JAX _concat_trace_split does."""
    jscene, tscene, ts = scenes
    rs = np.random.RandomState(3)
    H, W = 32, 48
    o = np.tile(np.asarray([0.0, 5.0, 9.0], np.float32), (H, W, 1))
    d = rs.normal(size=(H, W, 3)).astype(np.float32)
    d[..., 2] = -np.abs(d[..., 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o2 = rs.uniform(-4, 4, (100, 3)).astype(np.float32)
    d2 = rs.normal(size=(100, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)

    jclosest, jvis = jbvh.make_tracers(jscene)
    tclosest, tvis = tbvh.make_tracers(tscene, ts)
    jh = jclosest(jnp.asarray(o), jnp.asarray(d), 1e4)
    th = tclosest(_t(o), _t(d), 1e4)
    assert th.tri_id.shape == (H, W)
    np.testing.assert_array_equal(th.tri_id.numpy(), np.asarray(jh.tri_id))

    jv_img, jv_flat = jvis.many([(jnp.asarray(o), jnp.asarray(d), 6.0),
                                 (jnp.asarray(o2), jnp.asarray(d2), 3.0)])
    tv_img, tv_flat = tvis.many([(_t(o), _t(d), 6.0), (_t(o2), _t(d2), 3.0)])
    assert tv_img.shape == (H, W) and tv_flat.shape == (100,)
    np.testing.assert_array_equal(tv_img.numpy(), np.asarray(jv_img))
    np.testing.assert_array_equal(tv_flat.numpy(), np.asarray(jv_flat))
    np.testing.assert_array_equal(tv_img.numpy(), tvis(_t(o), _t(d), 6.0).numpy())

    surf_fn = tbvh.make_surface_tracer(tscene, ts)
    (h1, s1), (h2, s2) = surf_fn.many([(_t(o), _t(d), 1e4), (_t(o2), _t(d2), 1e4)])
    h_img, s_img = surf_fn(_t(o), _t(d), 1e4)
    assert s1.normal.shape == (H, W, 3) and s2.normal.shape == (100, 3)
    np.testing.assert_array_equal(h1.tri_id.numpy(), h_img.tri_id.numpy())
    np.testing.assert_array_equal(s1.position.numpy(), s_img.position.numpy())


def test_cpu_tensors_take_plain_path_and_count_no_launch(scenes, rays):
    _, _, ts = scenes
    o, d, t_max = rays
    before = (tbvh.closest_hit_attrs.launches, tbvh.visibility.launches)
    tbvh.closest_hit_attrs(ts, _t(o[:64]), _t(d[:64]), _t(t_max[:64]))
    tbvh.visibility(ts, _t(o[:64]), _t(d[:64]), _t(t_max[:64]))
    assert (tbvh.closest_hit_attrs.launches, tbvh.visibility.launches) == before == (0, 0)


def test_wrappers_refuse_other_devices(scenes):
    """No fallback: a tensor that is neither on the CPU nor on the card is
    refused, never silently traced by the plain walk."""
    _, _, ts = scenes
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        tbvh.visibility(ts, o, o, torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.require(torch.zeros(3), "x", torch.float32)


@pytest.mark.parametrize("name", ["shadows_test", "gi_test"])
def test_packed_records_unpack_to_the_scene(name):
    """K1/K2 read nodes as two and triangles as three 16-byte records;
    they hold exactly what the plain walk reads, the edges formed by the
    fp32 subtraction ``_moller`` does."""
    from hybrid_rendering_torch.scene import scenes as tscenes

    ts = tbvh.make_trace_scene(tscenes.load_scene(name)[0])
    N, T = ts.nodes_min.shape[0], ts.tri_pos.shape[0]
    nodes, tris = ts.nodes_packed, ts.tris_packed
    assert nodes.dtype == torch.int32 and tuple(nodes.shape) == (N, 8)
    assert tris.dtype == torch.float32 and tuple(tris.shape) == (T, 12)
    for rec in (nodes, tris, ts.attrs):
        assert rec.is_contiguous() and rec.data_ptr() % 16 == 0
    assert (ts.attrs.shape[1] * 4) % 16 == 0  # a row is six 16-byte pieces
    assert torch.equal(nodes[:, 0:3].contiguous().view(torch.float32), ts.nodes_min)
    assert torch.equal(nodes[:, 4:7].contiguous().view(torch.float32), ts.nodes_max)
    meta = torch.stack([nodes[:, 3] >> 3, nodes[:, 3] & 7, nodes[:, 7]], dim=1)
    assert torch.equal(meta, ts.nodes_meta)
    assert int(ts.nodes_meta[:, 1].max()) <= tbvh.LEAF_SIZE
    v0, v1, v2 = ts.tri_pos[:, 0], ts.tri_pos[:, 1], ts.tri_pos[:, 2]
    assert torch.equal(tris[:, 0:3], v0)
    assert torch.equal(tris[:, 4:7], v1 - v0)
    assert torch.equal(tris[:, 8:11], v2 - v0)
    assert (tris[:, 3::4] == 0).all()


def test_pack_nodes_refuses_what_does_not_fit():
    lo, hi = torch.zeros((1, 3)), torch.ones((1, 3))
    with pytest.raises(ValueError, match="7 triangles"):
        tbvh.pack_nodes(lo, hi, torch.tensor([[0, 8, 1]], dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\^28"):
        tbvh.pack_nodes(lo, hi, torch.tensor([[1 << 28, 1, 1]], dtype=torch.int32))


# ---------------------------------------------------------------------------
# K2's collapsed tree: the 4-wide records and the stack walk over them
# ---------------------------------------------------------------------------


def _port_scene(name):
    from hybrid_rendering_torch.scene import scenes as tscenes

    return tbvh.make_trace_scene(tscenes.load_scene(name)[0])


def _unpack_wide(ts):
    """(child boxes (M,6,4) f32, child words (M,4) i32) of the wide records."""
    wide = ts.wide_packed
    M = wide.shape[0]
    boxes = wide[:, :6 * tbvh.WIDE].contiguous().view(torch.float32).reshape(M, 6, tbvh.WIDE)
    return boxes, wide[:, 6 * tbvh.WIDE:]


@pytest.mark.parametrize("name", ["shadows_test", "gi_test"])
def test_wide_records_unpack_to_the_binary_bvh(name):
    """K2 reads the binary BVH collapsed to 4 children a node, seven
    16-byte records a node. Every binary leaf is the child of exactly one
    node with its own box and triangle range, every inner node but the
    root is the child of exactly one node, every child's box is a box of
    the binary tree and lies inside its node's, and the walk's stack
    fits."""
    ts = _port_scene(name)
    wide = ts.wide_packed
    M = wide.shape[0]
    assert wide.dtype == torch.int32 and tuple(wide.shape) == (M, 7 * tbvh.WIDE)
    assert wide.is_contiguous() and wide.data_ptr() % 16 == 0
    boxes, words = _unpack_wide(ts)
    used = words != tbvh.WIDE_EMPTY
    assert (used.sum(dim=1) >= 2).all() and (boxes.permute(0, 2, 1)[~used] == 0).all()
    # used slots come first
    assert (used.to(torch.int8).diff(dim=1) <= 0).all()

    meta = ts.nodes_meta.to(torch.int64)
    leaf_rows = torch.nonzero(meta[:, 1] > 0).squeeze(1)
    by_word = {int(meta[i, 0] * 8 + meta[i, 1]): int(i) for i in leaf_rows}
    leaf = used & (words < 0)
    leaf_words = (~words[leaf]).tolist()
    assert sorted(leaf_words) == sorted(by_word)  # each binary leaf once
    lo, hi = boxes[:, 0:3].permute(0, 2, 1), boxes[:, 3:6].permute(0, 2, 1)  # (M,4,3)
    rows = torch.tensor([by_word[w] for w in leaf_words])
    assert torch.equal(lo[leaf], ts.nodes_min[rows]) and torch.equal(hi[leaf], ts.nodes_max[rows])

    inner = used & (words >= 0)
    assert sorted(words[inner].tolist()) == list(range(1, M))  # each node but the root once
    binary = {tuple(b.tolist()) for b in torch.cat([ts.nodes_min, ts.nodes_max], dim=1)[meta[:, 1] == 0]}
    assert all(tuple(b.tolist()) in binary for b in torch.cat([lo[inner], hi[inner]], dim=1))
    assert M <= (meta[:, 1] == 0).sum()

    # a node's own box: the root's is the binary root's, a child node's sits in its parent's slot
    own_lo = torch.empty((M, 3))
    own_hi = torch.empty((M, 3))
    own_lo[0], own_hi[0] = ts.nodes_min[0], ts.nodes_max[0]
    own_lo[words[inner].to(torch.int64)] = lo[inner]
    own_hi[words[inner].to(torch.int64)] = hi[inner]
    assert ((lo >= own_lo[:, None, :]) | ~used[..., None]).all()
    assert ((hi <= own_hi[:, None, :]) | ~used[..., None]).all()


def _wide_walk(ts, origin, direction, t_max, t_min=1e-3):
    """The walk of K2 over the wide records in plain torch, all rays in
    step: pop a stack entry; a node pushes the children whose box the ray
    hits, a leaf tests its triangles. The slab and triangle arithmetic is
    ``traverse``'s. Returns (visibility, the deepest stack)."""
    boxes, words = _unpack_wide(ts)
    lo, hi = boxes[:, 0:3].permute(0, 2, 1), boxes[:, 3:6].permute(0, 2, 1)  # (M,4,3)
    words = words.to(torch.int64)
    R, T = origin.shape[0], ts.tri_pos.shape[0]
    inv = tbvh._safe_inv(direction)
    stack = torch.zeros((R, tbvh.WIDE_STACK), dtype=torch.int64)
    sp = torch.zeros(R, dtype=torch.int64)
    blocked = torch.zeros(R, dtype=torch.bool)
    live = torch.nonzero(~(t_max <= t_min)).squeeze(1)
    sp[live] = 1  # the root
    deepest = 1
    while live.numel():
        sp[live] -= 1
        cur = stack[live, sp[live]]
        at_node = cur >= 0
        rays, nid = live[at_node], cur[at_node]
        if rays.numel():
            o, i = origin[rays][:, None, :], inv[rays][:, None, :]
            t0, t1 = (lo[nid] - o) * i, (hi[nid] - o) * i
            tnear = torch.clamp(torch.minimum(t0, t1).amax(dim=2), min=t_min)
            tfar = torch.minimum(torch.maximum(t0, t1).amin(dim=2), t_max[rays][:, None])
            hit = (tnear <= tfar) & (words[nid] != tbvh.WIDE_EMPTY)
            for slot in range(tbvh.WIDE):
                push = rays[hit[:, slot]]
                stack[push, sp[push]] = words[nid[hit[:, slot]], slot]
                sp[push] += 1
            deepest = max(deepest, int(sp.max()))
        rays, word = live[~at_node], ~cur[~at_node]
        if rays.numel():
            first, count = word >> 3, word & 7
            o, d = origin[rays], direction[rays]
            for k in range(tbvh.LEAF_SIZE):
                tri = ts.tri_pos[torch.clamp(first + k, 0, T - 1)]
                t, _, _, ok = tbvh._moller(o, d, tri[:, 0], tri[:, 1], tri[:, 2], t_min)
                blocked[rays] |= ok & (k < count) & (t < t_max[rays])
        live = live[~blocked[live] & (sp[live] > 0)]
    return torch.where(blocked, 0.0, 1.0), deepest


@pytest.mark.parametrize("name", ["shadows_test", "gi_test"])
def test_wide_walk_equals_plain_visibility(name):
    """Any-hit visibility does not depend on the order or the width of the
    walk: the stack walk over the 4-wide records answers every ray, live
    or dead, as the skip-link walk over the binary tree does."""
    ts = _port_scene(name)
    rs = np.random.RandomState(11)
    n = 4096
    lo, hi = ts.nodes_min[0].numpy(), ts.nodes_max[0].numpy()
    ext = hi - lo
    o = rs.uniform(lo - 0.2 * ext, hi + 0.2 * ext, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    cent = ts.tri_pos.numpy().mean(axis=1)
    k = n // 2
    d[:k] = cent[rs.randint(0, cent.shape[0], k)] + rs.normal(scale=0.05, size=(k, 3)) * ext - o[:k]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # rays from inside leaf boxes, axis-parallel rays, unbounded and dead rays
    leaves = (ts.nodes_meta[:, 1] > 0).numpy()
    centers = ((ts.nodes_min + ts.nodes_max) * 0.5).numpy()[leaves]
    o[k:k + 256] = centers[rs.randint(0, centers.shape[0], 256)]
    d[k + 256:k + 320] = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 64)]
    t_max = np.where(rs.uniform(size=n) < 0.5, 1e4, rs.uniform(0.05, 1.0, n) * ext.max())
    t_max[rs.uniform(size=n) < 0.1] = 0.0
    t_max[rs.uniform(size=n) < 0.05] = np.inf
    o, d, t_max = _t(o), _t(d), _t(t_max.astype(np.float32))
    ref = tbvh.visibility_plain(ts, o, d, t_max)
    got, deepest = _wide_walk(ts, o, d, t_max)
    assert torch.equal(got, ref)
    assert 0.05 < ref[t_max > 0].mean() < 0.95
    assert deepest <= tbvh.WIDE_STACK


def test_pack_wide_nodes_edge_trees():
    """A one-leaf tree becomes a root with that leaf as its only child; a
    tree too deep for the kernel's stack is refused."""
    lo, hi = torch.zeros((1, 3)), torch.ones((1, 3))
    one, src = tbvh.pack_wide_nodes(lo, hi, torch.tensor([[0, 3, 1]], dtype=torch.int32))
    assert tuple(one.shape) == (1, 7 * tbvh.WIDE)
    assert one[0, 24:].tolist() == [~3, tbvh.WIDE_EMPTY, tbvh.WIDE_EMPTY, tbvh.WIDE_EMPTY]
    assert src.tolist() == [[0, -1, -1, -1]]
    # a comb: every right child is a leaf, so a wide node keeps one inner
    # child and three leaves, and a walk can hold three entries a level.
    # Preorder: the spine inner_0..inner_{D-1}, its last left leaf, then
    # the right leaves from the deepest up
    D = 2 * tbvh.WIDE_STACK
    N = 2 * D + 1
    meta = np.zeros((N, 3), np.int32)
    meta[:D, 2] = [N] + [N - i for i in range(1, D)]  # inner_i skips to right leaf i-1
    meta[D:, 0] = np.arange(D + 1)
    meta[D:, 1] = 1
    meta[D:, 2] = np.arange(D + 1, N + 1)
    size = np.concatenate([np.arange(D, 0, -1), np.ones(D + 1)]).astype(np.float32)
    lo = np.zeros((N, 3), np.float32)
    hi = np.repeat(size[:, None], 3, axis=1)
    with pytest.raises(ValueError, match="stack entries"):
        tbvh.pack_wide_nodes(_t(lo), _t(hi), _t(meta))
