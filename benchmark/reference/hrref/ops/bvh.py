"""BVH build, the stackless skip-link walk, and the tracer interface of
the plain reference.

Kept apart from the port so that the benchmark's reference does not move
with the program. The tree is this file's own binned-SAH build in numpy
(``build_bvh``), not the program's native builder, so the reference
shares no acceleration structure with the program under test. The BVH
is stored in preorder with skip links:

    next = node+1        on AABB hit of an internal node
    next = skip[node]    on miss / after a leaf

The walk (``traverse``) is plain PyTorch. Its time goes to iterations
times launches, not to arithmetic, so each iteration tests a leaf's
triangles in one batch of tensor operations, keeps finished rays in its
arrays until half of them have finished, and hands the last few rays to
the brute-force tracer (``ops/brute.py``), which gives the same closest
hit (up to the choice among triangles at an equal t) in a few tiles
instead of the deepest ray's hundreds of iterations.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hrref.types import Hit, SceneArrays

LEAF_SIZE = 4
SAH_BINS = 16
# ray-triangle pairs left when the walk hands over to brute force, by
# device: a tile of brute force costs the card about as much as a few of
# the walk's iterations, and the CPU many more
BRUTE_PAIRS = {"cuda": 1 << 28, "cpu": 1 << 20}


# ---------------------------------------------------------------------------
# Build (host, numpy): binned SAH, one level of the tree at a time
# ---------------------------------------------------------------------------


def _half_area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def _split_level(open_a, open_b, order, tlo, thi, cen, bins):
    """One level of the build: every open node (a triangle range
    [a, b) of `order`) split where the binned surface-area heuristic is
    least, over the three axes' centroid bins; its triangles are
    reordered in place, the left child's first. Returns each node's left
    count and, for every triangle of the level in order, the range it
    lies in."""
    n = open_a.size
    L = open_b - open_a
    seg = np.repeat(np.arange(n), L)
    starts = np.concatenate([[0], np.cumsum(L)[:-1]])
    rank = np.arange(L.sum()) - starts[seg]
    tris = order[open_a[seg] + rank]
    c = cen[tris]
    cmin = np.minimum.reduceat(c, starts, axis=0)
    ext = np.maximum.reduceat(c, starts, axis=0) - cmin
    scale = np.where(ext > 0, bins / np.where(ext > 0, ext, 1.0), 0.0).astype(np.float32)
    b = np.clip(((c - cmin[seg]) * scale[seg]).astype(np.int64), 0, bins - 1)  # (m, 3)
    key = ((seg[:, None] * 3 + np.arange(3)) * bins + b).reshape(-1)
    blo = np.full((3, n * 3 * bins), np.inf, np.float32)
    bhi = np.full((3, n * 3 * bins), -np.inf, np.float32)
    tl, th = tlo[tris], thi[tris]
    for j in range(3):  # 1-D ufunc.at runs far faster than on rows
        np.minimum.at(blo[j], key, np.repeat(tl[:, j], 3))
        np.maximum.at(bhi[j], key, np.repeat(th[:, j], 3))
    blo = blo.T.reshape(n, 3, bins, 3)
    bhi = bhi.T.reshape(n, 3, bins, 3)
    cnt = np.bincount(key, minlength=n * 3 * bins).reshape(n, 3, bins)
    llo, lhi = np.minimum.accumulate(blo, axis=2), np.maximum.accumulate(bhi, axis=2)
    rlo = np.minimum.accumulate(blo[:, :, ::-1], axis=2)[:, :, ::-1]
    rhi = np.maximum.accumulate(bhi[:, :, ::-1], axis=2)[:, :, ::-1]
    lc = np.cumsum(cnt, axis=2)[:, :, :-1]
    rc = L[:, None, None] - lc
    cost = (_half_area(llo[:, :, :-1], lhi[:, :, :-1]) * lc
            + _half_area(rlo[:, :, 1:], rhi[:, :, 1:]) * rc)
    cost = np.where((lc > 0) & (rc > 0), cost, np.inf).reshape(n, -1)
    best = np.argmin(cost, axis=1)
    found = np.isfinite(cost[np.arange(n), best])
    axis, k = best // (bins - 1), best % (bins - 1)
    left = b[np.arange(b.shape[0]), axis[seg]] <= k[seg]
    # every centroid in one bin: halves by position
    left = np.where(found[seg], left, rank < (L // 2)[seg])
    n_left = np.bincount(seg, weights=left, minlength=n).astype(np.int64)
    before = np.cumsum(left) - left
    left_before = before - before[starts][seg]
    order[open_a[seg] + np.where(left, left_before, n_left[seg] + rank - left_before)] = tris
    return n_left, seg, starts


def build_bvh(tri_pos: np.ndarray, leaf_size: int = LEAF_SIZE, bins: int = SAH_BINS):
    """Binned-SAH BVH in preorder with skip links, split until a leaf
    holds at most `leaf_size` triangles.

    Returns (nodes_min (N,3) f32, nodes_max (N,3) f32,
             nodes_meta (N,3) i32 [first_tri, tri_count, skip_link],
             order (T,) i32 triangle permutation into leaf order).
    tri_count == 0 marks internal nodes."""
    tri_pos = np.asarray(tri_pos, np.float32)
    T = tri_pos.shape[0]
    tlo, thi = tri_pos.min(axis=1), tri_pos.max(axis=1)
    cen = (tlo + thi) * 0.5
    order = np.arange(T, dtype=np.int64)
    cap = 2 * T + 1
    first, end = np.zeros(cap, np.int64), np.zeros(cap, np.int64)
    left_child = np.full(cap, -1, np.int64)
    lo, hi = np.zeros((cap, 3), np.float32), np.zeros((cap, 3), np.float32)
    first[0], end[0], lo[0], hi[0] = 0, T, tlo.min(axis=0), thi.max(axis=0)
    levels = [np.array([0])]
    count = 1
    opened = levels[0][end[levels[0]] - first[levels[0]] > leaf_size]
    while opened.size:
        a, b = first[opened], end[opened]
        n_left, seg, starts = _split_level(a, b, order, tlo, thi, cen, bins)
        ids = count + np.arange(2 * opened.size)
        count += ids.size
        left_child[opened] = ids[0::2]
        first[ids] = np.stack([a, a + n_left], 1).reshape(-1)
        end[ids] = np.stack([a + n_left, b], 1).reshape(-1)
        # the children's ranges tile the level's triangles in order
        tris = order[a[seg] + np.arange(seg.size) - starts[seg]]
        cuts = np.stack([starts, starts + n_left], 1).reshape(-1)
        lo[ids] = np.minimum.reduceat(tlo[tris], cuts, axis=0)
        hi[ids] = np.maximum.reduceat(thi[tris], cuts, axis=0)
        levels.append(ids)
        opened = ids[end[ids] - first[ids] > leaf_size]
    N = count
    # preorder: subtree sizes bottom up, then indices top down
    size = np.ones(N, np.int64)
    for ids in levels[::-1]:
        p = ids[left_child[ids] >= 0]
        size[p] = 1 + size[left_child[p]] + size[left_child[p] + 1]
    pre = np.zeros(N, np.int64)
    for ids in levels:
        p = ids[left_child[ids] >= 0]
        pre[left_child[p]] = pre[p] + 1
        pre[left_child[p] + 1] = pre[p] + 1 + size[left_child[p]]
    leaf = left_child[:N] < 0
    nodes_min, nodes_max = np.empty((N, 3), np.float32), np.empty((N, 3), np.float32)
    nodes_min[pre], nodes_max[pre] = lo[:N], hi[:N]
    meta = np.zeros((N, 3), np.int64)
    meta[pre, 0] = np.where(leaf, first[:N], 0)
    meta[pre, 1] = np.where(leaf, end[:N] - first[:N], 0)
    meta[pre, 2] = pre + size
    return nodes_min, nodes_max, meta.astype(np.int32), order.astype(np.int32)


# ---------------------------------------------------------------------------
# Per-scene trace data
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceScene:
    """What the walk reads: the BVH with one node appended, where
    finished rays wait (its skip link leads to itself), each node's leaf triangles as (v0, v1 - v0, v2 - v0) rows
    padded to ``LEAF_SIZE`` with zero triangles, which nothing hits,
    their triangle ids, the triangles and the (T, 24) attribute table."""

    nodes_min: torch.Tensor  # (N+1,3) f32
    nodes_max: torch.Tensor  # (N+1,3) f32
    nodes_meta: torch.Tensor  # (N+1,3) i64 [first, count, skip]
    leaf_tris: torch.Tensor  # (N+1,LEAF_SIZE,3,3) f32
    leaf_ids: torch.Tensor  # (N+1,LEAF_SIZE) i64, -1 for padding
    tri_pos: torch.Tensor  # (T,3,3) f32
    attrs: torch.Tensor  # (T,24) f32


def attr_table(scene: SceneArrays) -> torch.Tensor:
    """(T, 24) per-triangle attribute rows in the layout of the JAX
    package's ``make_flash_scene`` (flashtrace.py:170-189): vertex normals,
    vertex uvs, material id, mesh id, unit geometric normal, tangent."""
    tp = scene.tri_pos
    T = tp.shape[0]
    e1 = tp[:, 1] - tp[:, 0]
    e2 = tp[:, 2] - tp[:, 0]
    n = torch.linalg.cross(e1, e2, dim=-1)
    geo_n = n / torch.clamp(torch.linalg.norm(n, dim=1, keepdim=True), min=1e-12)
    return torch.cat([
        scene.tri_normal.reshape(T, 9), scene.tri_uv.reshape(T, 6),
        scene.tri_mat.to(torch.float32)[:, None],
        scene.tri_mesh_id.to(torch.float32)[:, None],
        geo_n, scene.tri_tangent,
    ], dim=1).contiguous()


def make_trace_scene(scene: SceneArrays) -> TraceScene:
    if scene.bvh_nodes_min is None:
        raise ValueError("scene was built without a BVH (use_bvh=False)")
    dev = scene.tri_pos.device
    meta = scene.bvh_nodes_meta.to(torch.int64)
    N = meta.shape[0]
    meta = torch.cat([meta, torch.tensor([[0, 0, N]], device=dev)])
    ids = meta[:, :1] + torch.arange(LEAF_SIZE, device=dev)
    ids = torch.where(torch.arange(LEAF_SIZE, device=dev) < meta[:, 1:2], ids, -1)
    tp = scene.tri_pos
    rows = torch.stack([tp[:, 0], tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]], dim=1)
    leaf_tris = torch.where((ids >= 0)[:, :, None, None], rows[ids.clamp(min=0)], 0.0)
    wait = torch.zeros((1, 3), device=dev)
    return TraceScene(
        nodes_min=torch.cat([scene.bvh_nodes_min, wait]).contiguous(),
        nodes_max=torch.cat([scene.bvh_nodes_max, wait]).contiguous(),
        nodes_meta=meta.contiguous(), leaf_tris=leaf_tris.contiguous(),
        leaf_ids=ids.contiguous(), tri_pos=tp.contiguous(), attrs=attr_table(scene))


# ---------------------------------------------------------------------------
# Plain walk (PyTorch)
# ---------------------------------------------------------------------------


def _safe_inv(direction):
    """1/d with |d| < 1e-12 replaced by +-1e-12 (JAX bvh.py:199-200)."""
    tiny = torch.where(direction < 0, -1e-12, 1e-12).to(direction.dtype)
    return 1.0 / torch.where(torch.abs(direction) < 1e-12, tiny, direction)


def _dot(a, b):
    # written out in a fixed rounding order: (a0 b0 + a1 b1) + a2 b2
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


_YZX, _ZXY = [1, 2, 0], [2, 0, 1]


def _cross(a, b):
    return a[..., _YZX] * b[..., _ZXY] - a[..., _ZXY] * b[..., _YZX]


def _moller(o, d, v0, e1, e2, t_min):
    """Moller-Trumbore on broadcast (..., 3) operands, with
    ``brute._tests``'s arithmetic: every product and sum rounded alike,
    so that both give the same t, u and v."""
    pvec = _cross(d, e2)
    det = _dot(pvec, e1)
    det_ok = torch.abs(det) > 1e-9
    inv_det = torch.where(det_ok, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    ok = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return t, u, v, ok


def traverse(ts: TraceScene, origin, direction, t_max, t_min=1e-3,
             any_hit=False) -> Hit:
    """Stackless skip-link walk over (R,3) rays with per-ray t_max (R,):
    inclusive slab test clipped to [t_min, best t]; a leaf's triangles
    tested together, the first of equal minima in the leaf winning a
    strict ``t < best``; with any_hit a ray stops after the first leaf
    that yields a hit. Rays with t_max <= t_min hit nothing (visibility
    1). Once the rays still walking times the triangles come to no more
    than the device's ``BRUTE_PAIRS``, those rays are traced by brute force
    from their best t so far."""
    from hrref.ops import brute  # brute imports this module

    R = origin.shape[0]
    dev = origin.device
    done = ts.nodes_meta.shape[0] - 1  # the appended node
    hand_over = BRUTE_PAIRS.get(dev.type, 0) // ts.tri_pos.shape[0]
    out_t = t_max.to(origin.dtype).clone()
    out_id = torch.full((R,), -1, dtype=torch.int64, device=dev)
    out_u = torch.zeros(R, dtype=origin.dtype, device=dev)
    out_v = torch.zeros(R, dtype=origin.dtype, device=dev)

    ray = torch.nonzero(out_t > t_min).squeeze(1)
    o, d = origin[ray], direction[ray]
    inv = _safe_inv(d)
    bt, bid, bu, bv = out_t[ray], out_id[ray], out_u[ray], out_v[ray]
    node = torch.zeros_like(ray)
    walking = ray.numel()
    while walking:
        meta = ts.nodes_meta[node]
        t0 = (ts.nodes_min[node] - o) * inv
        t1 = (ts.nodes_max[node] - o) * inv
        tnear = torch.clamp(torch.minimum(t0, t1).amax(dim=1), min=t_min)
        tfar = torch.minimum(torch.maximum(t0, t1).amin(dim=1), bt)
        hit_box = tnear <= tfar
        is_leaf = meta[:, 1] > 0

        sel = torch.nonzero(hit_box & is_leaf).squeeze(1)
        if sel.numel():
            tri = ts.leaf_tris[node[sel]]  # (S, LEAF_SIZE, 3, 3)
            t, u, v, ok = _moller(o[sel, None], d[sel, None], tri[:, :, 0], tri[:, :, 1],
                                  tri[:, :, 2], t_min)
            cur = bt[sel]
            t = torch.where(ok & (t < cur[:, None]), t, torch.full_like(t, float("inf")))
            k = torch.argmin(t, dim=1, keepdim=True)  # the first of equal minima
            tk = t.gather(1, k).squeeze(1)
            better = tk < cur
            bt[sel] = torch.where(better, tk, cur)
            bid[sel] = torch.where(better, ts.leaf_ids[node[sel]].gather(1, k).squeeze(1),
                                   bid[sel])
            bu[sel] = torch.where(better, u.gather(1, k).squeeze(1), bu[sel])
            bv[sel] = torch.where(better, v.gather(1, k).squeeze(1), bv[sel])

        node = torch.where(hit_box & ~is_leaf, node + 1, meta[:, 2])
        if any_hit:
            node = torch.where(bid >= 0, done, node)
        node = torch.clamp(node, max=done)  # a waiting ray's node + 1 lies past the end
        left = node < done
        walking = int(left.sum())
        if walking <= hand_over or 2 * walking <= node.numel():
            out_t[ray], out_id[ray], out_u[ray], out_v[ray] = bt, bid, bu, bv
            keep = torch.nonzero(left).squeeze(1)
            ray, o, d, inv, node = ray[keep], o[keep], d[keep], inv[keep], node[keep]
            bt, bid, bu, bv = bt[keep], bid[keep], bu[keep], bv[keep]
            if 0 < walking <= hand_over:
                hit = brute.closest_hit(ts.tri_pos, o, d, bt, t_min)
                found = hit.valid
                out_t[ray] = torch.where(found, hit.t, bt)
                out_id[ray] = torch.where(found, hit.tri_id.to(torch.int64), bid)
                out_u[ray] = torch.where(found, hit.u, bu)
                out_v[ray] = torch.where(found, hit.v, bv)
                break
    return Hit(t=out_t, tri_id=out_id.to(torch.int32), u=out_u, v=out_v)


def closest_hit_attrs_plain(ts: TraceScene, origin, direction, t_max, t_min=1e-3):
    """Closest hit: (Hit, (R,24) attribute rows; zeros on a miss)."""
    hit = traverse(ts, origin, direction, t_max, t_min)
    rows = ts.attrs[torch.clamp(hit.tri_id, min=0).to(torch.int64)]
    attrs = torch.where(hit.valid[:, None], rows, torch.zeros_like(rows))
    return hit, attrs


def visibility_plain(ts: TraceScene, origin, direction, t_max, t_min=1e-3):
    """Any hit: (R,) 1.0 visible / 0.0 blocked."""
    hit = traverse(ts, origin, direction, t_max, t_min, any_hit=True)
    return torch.where(hit.valid, 0.0, 1.0).to(origin.dtype)


# ---------------------------------------------------------------------------
# Tracer interface
# ---------------------------------------------------------------------------


def _pick_block(H, W):
    """Largest pixel-block size dividing both dims (16x16 = 256 rays)."""
    for b in (16, 8, 4, 2):
        if H % b == 0 and W % b == 0:
            return b
    return 1


def _block_linearize(x, H, W, b):
    rest = x.shape[2:]
    x = x.reshape(H // b, b, W // b, b, *rest).transpose(1, 2)
    return x.reshape(H * W, *rest)


def _block_delinearize(x, H, W, b):
    rest = x.shape[1:]
    x = x.reshape(H // b, W // b, b, b, *rest).transpose(1, 2)
    return x.reshape(H, W, *rest)


def _linearize_req(origin, direction, t_max):
    """One trace request -> (flat contiguous (R,3)/(R,) operands,
    delinearize meta). 2-D image batches are reordered into coherent pixel
    blocks."""
    shape = tuple(origin.shape[:-1])
    tm_full = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=origin.dtype, device=origin.device), shape)
    b = _pick_block(*shape) if len(shape) == 2 else 1
    if b > 1:
        H, W = shape
        o = _block_linearize(origin, H, W, b)
        d = _block_linearize(direction, H, W, b)
        tm = _block_linearize(tm_full, H, W, b)
    else:
        o, d, tm = origin.reshape(-1, 3), direction.reshape(-1, 3), tm_full.reshape(-1)
    return (o.contiguous(), d.contiguous(), tm.contiguous()), (shape, b)


def _delinearize(arr, shape, b):
    if b > 1:
        return _block_delinearize(arr, shape[0], shape[1], b)
    return arr.reshape(shape + tuple(arr.shape[1:]))


def _map(fn, out, *more):
    """Apply fn to every tensor of a trace result (tensor, Hit, Surface
    or tuple of those); with `more` results of the same structure, fn
    takes the matching tensor of each."""
    if isinstance(out, torch.Tensor):
        return fn(out, *more)
    if isinstance(out, tuple):
        return tuple(_map(fn, *parts) for parts in zip(out, *more))
    return type(out)(**{f.name: fn(getattr(out, f.name), *(getattr(m, f.name) for m in more))
                        for f in dataclasses.fields(out)})


def _concat_trace_split(fn, reqs):
    """Concatenate (origin, dir, t_max) requests into ONE flat trace launch
    and split/delinearize the outputs back per request (each request is
    block-linearized on its own)."""
    lin = [_linearize_req(*r) for r in reqs]
    sizes = [l[0][0].shape[0] for l in lin]
    o = torch.cat([l[0][0] for l in lin], dim=0)
    d = torch.cat([l[0][1] for l in lin], dim=0)
    tm = torch.cat([l[0][2] for l in lin], dim=0)
    out = fn(o, d, tm)
    results = []
    off = 0
    for n, (_, (shape, b)) in zip(sizes, lin):
        results.append(_map(lambda a: _delinearize(a[off:off + n], shape, b), out))
        off += n
    return results


def _make_flat(fn):
    """Adapt a flat-(R,3) tracer to (..., 3) batches, with ``.many``."""

    def wrapped(origin, direction, t_max):
        (o, d, tm), (shape, b) = _linearize_req(origin, direction, t_max)
        return _map(lambda a: _delinearize(a, shape, b), fn(o, d, tm))

    wrapped.many = lambda reqs: _concat_trace_split(fn, reqs)
    return wrapped


def make_tracers(scene: SceneArrays, ts=None):
    """(closest_hit_fn, visibility_fn) bound to a scene by the plain walk:
    closest_hit_fn(origin, dir, t_max) -> Hit and
    visibility_fn(origin, dir, t_max) -> 1.0 visible / 0.0 blocked, for
    (..., 3) rays, each with ``.many``."""
    ts = ts if ts is not None else make_trace_scene(scene)
    return (_make_flat(lambda o, d, tm: closest_hit_attrs_plain(ts, o, d, tm)[0]),
            _make_flat(lambda o, d, tm: visibility_plain(ts, o, d, tm)))


def make_surface_tracer(scene: SceneArrays, ts=None):
    """closest_surface(origin, dir, t_max) -> (Hit, Surface): the walk's
    attribute rows made into the Surface by ``surface_from_attrs``."""
    from hrref.scene.fetch import surface_from_attrs

    ts = ts if ts is not None else make_trace_scene(scene)

    def flat(o, d, tm):
        hit, attrs = closest_hit_attrs_plain(ts, o, d, tm)
        return hit, surface_from_attrs(scene, o, d, hit, attrs)

    return _make_flat(flat)
