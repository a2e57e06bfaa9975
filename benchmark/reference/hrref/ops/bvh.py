"""BVH build, the stackless skip-link walk, and the tracer interface of
the plain reference.

A frozen copy of the port's plain path (``ops/bvh.py``), kept apart so
that the benchmark's reference does not move with the program. Only the
plain PyTorch walk is here; the tree is this file's own Morton
median-split build (``build_bvh``), not the program's binned-SAH tree, so
the reference shares no acceleration structure with the program under
test. The BVH is stored in preorder with skip links:

    next = node+1        on AABB hit of an internal node
    next = skip[node]    on miss / after a leaf
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hrref.types import Hit, SceneArrays

LEAF_SIZE = 4


# ---------------------------------------------------------------------------
# Build (host, numpy): Morton median split
# ---------------------------------------------------------------------------

def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd bit (for 30-bit Morton codes)."""
    v = v.astype(np.uint64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(xyz01: np.ndarray) -> np.ndarray:
    """xyz in [0,1]^3 -> 30-bit Morton codes. (N,3) -> (N,)"""
    q = np.clip(xyz01 * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def build_bvh(tri_pos: np.ndarray, leaf_size: int = LEAF_SIZE):
    """Morton-ordered median-split BVH in preorder with skip links.

    Returns (nodes_min (N,3) f32, nodes_max (N,3) f32,
             nodes_meta (N,3) i32 [first_tri, tri_count, skip_link],
             order (T,) i32 triangle permutation into leaf order).
    tri_count == 0 marks internal nodes."""
    tri_pos = np.asarray(tri_pos, np.float32)
    T = tri_pos.shape[0]
    centroids = tri_pos.mean(axis=1)
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-8)
    order = np.argsort(morton3d((centroids - lo) / extent), kind="stable").astype(np.int32)
    tri_lo = tri_pos.min(axis=1)[order]
    tri_hi = tri_pos.max(axis=1)[order]

    nodes_min, nodes_max, nodes_meta = [], [], []
    stack = [(0, T)]
    while stack:  # push right before left => preorder
        a, b = stack.pop()
        nodes_min.append(tri_lo[a:b].min(axis=0))
        nodes_max.append(tri_hi[a:b].max(axis=0))
        if b - a <= leaf_size:
            nodes_meta.append([a, b - a, 0])
        else:
            nodes_meta.append([a, 0, b])  # range end, replaced below
            mid = (a + b) // 2
            stack.append((mid, b))
            stack.append((a, mid))

    N = len(nodes_meta)
    meta = np.asarray(nodes_meta, np.int64)
    starts = meta[:, 0].copy()
    ends = np.where(meta[:, 1] > 0, meta[:, 0] + meta[:, 1], meta[:, 2])
    # skip[i] = next preorder node whose range starts at/after i's end
    skip = np.full(N, N, np.int64)
    pending = []
    for i in range(N):
        while pending and starts[i] >= ends[pending[-1]]:
            skip[pending.pop()] = i
        pending.append(i)
    internal = meta[:, 1] == 0
    meta[internal, 0] = 0
    meta[:, 2] = skip
    return (np.asarray(nodes_min, np.float32), np.asarray(nodes_max, np.float32),
            meta.astype(np.int32), order)


# ---------------------------------------------------------------------------
# Per-scene trace data
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceScene:
    """What the plain walk reads: the BVH, the leaf-ordered triangles and
    the (T, 24) attribute table."""

    nodes_min: torch.Tensor  # (N,3) f32
    nodes_max: torch.Tensor  # (N,3) f32
    nodes_meta: torch.Tensor  # (N,3) i32
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
    return TraceScene(
        nodes_min=scene.bvh_nodes_min.contiguous(), nodes_max=scene.bvh_nodes_max.contiguous(),
        nodes_meta=scene.bvh_nodes_meta.to(torch.int32).contiguous(),
        tri_pos=scene.tri_pos.contiguous(), attrs=attr_table(scene))


# ---------------------------------------------------------------------------
# Plain walk (PyTorch)
# ---------------------------------------------------------------------------


def _safe_inv(direction):
    """1/d with |d| < 1e-12 replaced by +-1e-12 (JAX bvh.py:199-200)."""
    tiny = torch.where(direction < 0, -1e-12, 1e-12).to(direction.dtype)
    return 1.0 / torch.where(torch.abs(direction) < 1e-12, tiny, direction)


def _dot(a, b):
    # written out in a fixed rounding order
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _moller(o, d, v0, v1, v2, t_min):
    """Moller-Trumbore for one triangle per ray (all (R,3))."""
    e1 = v1 - v0
    e2 = v2 - v0
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
    """Stackless skip-link walk over (R,3) rays with per-ray t_max (R,).
    Semantics of the JAX ``traverse``: inclusive slab test clipped to
    [t_min, best t]; leaf lanes tested in order with a strict ``t < best``
    so the first of equal minima wins; with any_hit a ray stops after the
    first leaf that yields a hit. Rays with t_max <= t_min hit nothing
    (visibility 1)."""
    R = origin.shape[0]
    dev = origin.device
    N = ts.nodes_min.shape[0]
    T = ts.tri_pos.shape[0]
    inv_dir = _safe_inv(direction)
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    best_t = t_max.to(origin.dtype).clone()
    best_id = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(R, dtype=origin.dtype, device=dev)
    best_v = torch.zeros(R, dtype=origin.dtype, device=dev)
    meta_all = ts.nodes_meta.to(torch.int64)

    live = torch.arange(R, device=dev)  # rays whose pointer is still < N
    while live.numel():
        nid = node[live]
        o, d, inv = origin[live], direction[live], inv_dir[live]
        bt = best_t[live]
        meta = meta_all[nid]
        first, count, skip = meta[:, 0], meta[:, 1], meta[:, 2]
        t0 = (ts.nodes_min[nid] - o) * inv
        t1 = (ts.nodes_max[nid] - o) * inv
        tnear = torch.clamp(torch.minimum(t0, t1).amax(dim=1), min=t_min)
        tfar = torch.minimum(torch.maximum(t0, t1).amin(dim=1), bt)
        hit_box = tnear <= tfar
        is_leaf = count > 0

        sel = torch.nonzero(hit_box & is_leaf).squeeze(1)
        if sel.numel():
            rays = live[sel]
            o_s, d_s, first_s, count_s = o[sel], d[sel], first[sel], count[sel]
            cur_t, cur_id = bt[sel], best_id[rays]
            cur_u, cur_v = best_u[rays], best_v[rays]
            for k in range(LEAF_SIZE):
                idx = torch.clamp(first_s + k, 0, T - 1)
                tri = ts.tri_pos[idx]
                t, u, v, ok = _moller(o_s, d_s, tri[:, 0], tri[:, 1], tri[:, 2], t_min)
                ok = ok & (k < count_s) & (t < cur_t)
                cur_t = torch.where(ok, t, cur_t)
                cur_id = torch.where(ok, idx, cur_id)
                cur_u = torch.where(ok, u, cur_u)
                cur_v = torch.where(ok, v, cur_v)
            best_t[rays], best_id[rays] = cur_t, cur_id
            best_u[rays], best_v[rays] = cur_u, cur_v

        nxt = torch.where(hit_box & ~is_leaf, nid + 1, skip)
        if any_hit:
            nxt = torch.where(best_id[live] >= 0, N, nxt)
        node[live] = nxt
        live = live[nxt < N]
    return Hit(t=best_t, tri_id=best_id.to(torch.int32), u=best_u, v=best_v)


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
