"""BVH build, the stackless skip-link walk, and the tracer interface.

Port of ``hybrid_rendering_tpu/ops/bvh.py``. The BVH is stored in preorder
with skip links, so a walk needs one node pointer per ray and no stack:

    next = node+1        on AABB hit of an internal node
    next = skip[node]    on miss / after a leaf

Two versions of each trace live here:
  - the plain PyTorch walk ``traverse`` (a port of the JAX ``traverse``,
    vectorized over the rays still walking), used for CPU tensors and as
    the reference the kernels are checked against;
  - the CUDA kernels K1 (``closest_hit_attrs``: closest hit + the hit
    triangle's attribute row) and K2 (``visibility``: any-hit), in
    csrc/trace.cu, used for every CUDA tensor. K1 walks the skip-link
    tree; K2, whose answer does not depend on the order of the walk, walks
    the same tree collapsed to 4 children a node (``pack_wide_nodes``).

``refit_trace_scene`` keeps the tree's topology and recomputes, on the
scene's device, every box and packed record K1/K2 read after the soup
moved (dynamic scenes; ``refit_accel`` picks the refit of each method).

``make_tracers`` / ``make_surface_tracer`` bind them (or, by the JAX
package's method names, the dense kernels K6/K6′ of ops/flashtrace.py or
the brute oracle of ops/intersect.py) to a scene with the JAX package's
interface, including ``.many`` (several requests in one launch) and the
16x16 pixel-block ray order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hybrid_rendering_torch.ops import flashtrace, intersect, kernels
from hybrid_rendering_torch.types import Hit, SceneArrays

LEAF_SIZE = 4
WIDE = 4  # children of a node of the collapsed tree K2 walks
WIDE_STACK = 64  # entries of K2's per-ray stack (csrc/trace.cu STACK)
WIDE_EMPTY = -(1 << 31)  # child word of an unused slot
ATTR = 24  # attribute row: n0 n1 n2 (9) uv0..2 (6) mat mesh geo_n (5) tangent (4)


# ---------------------------------------------------------------------------
# Build (host, numpy) — the Python Morton median-split fallback builder
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
class RefitPlan:
    """What a refit reads besides the moved triangles, built once with the
    tree: each leaf's triangles, the inner nodes level by level (deepest
    first) with their two children, and the binary node behind each slot
    of K2's 4-wide nodes."""

    leaf_nodes: torch.Tensor  # (L,) int64
    leaf_tris: torch.Tensor  # (L, K) int64 triangle of a slot (the leaf's first if unused)
    leaf_used: torch.Tensor  # (L, K, 1) bool: slot k < the leaf's count
    levels: list  # [(nodes, left, right)] int64 tensors, deepest level first
    wide_src: torch.Tensor  # (M, WIDE) int64 binary node of a slot (0 if unused)
    wide_used: torch.Tensor  # (M, WIDE, 1) bool


@dataclasses.dataclass
class TraceScene:
    """What K1/K2 and the plain walk read: the BVH, the leaf-ordered
    triangles and the (T, 24) attribute table; and, for the kernels, the
    same nodes and triangles as 16-byte records (``pack_nodes``,
    ``pack_tris``) and, for K2, the nodes collapsed to 4 children
    (``pack_wide_nodes``)."""

    nodes_min: torch.Tensor  # (N,3) f32
    nodes_max: torch.Tensor  # (N,3) f32
    nodes_meta: torch.Tensor  # (N,3) i32
    tri_pos: torch.Tensor  # (T,3,3) f32
    attrs: torch.Tensor  # (T,24) f32
    nodes_packed: torch.Tensor  # (N,8) i32: two 16-byte records a node
    tris_packed: torch.Tensor  # (T,12) f32: three 16-byte records a triangle
    wide_packed: torch.Tensor  # (M,28) i32: seven 16-byte records a 4-wide node (K2)
    plan: RefitPlan  # the tree's topology, for refit_trace_scene


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


def pack_nodes(nodes_min, nodes_max, nodes_meta) -> torch.Tensor:
    """(N, 8) int32, two 16-byte records a node: the bits of min.xyz and
    first_tri * 8 + tri_count, then the bits of max.xyz and the skip link.
    Kept as integers so that no float operation touches the packed words."""
    meta = nodes_meta.to(torch.int64)
    if meta.numel() and (int(meta[:, 1].max()) > 7 or int(meta[:, 0].max()) >= 1 << 28):
        raise ValueError("pack_nodes: a leaf holds more than 7 triangles or starts past 2^28")
    word = (meta[:, 0] * 8 + meta[:, 1]).to(torch.int32)
    return torch.cat([nodes_min.contiguous().view(torch.int32), word[:, None],
                      nodes_max.contiguous().view(torch.int32),
                      nodes_meta[:, 2:3].to(torch.int32)], dim=1).contiguous()


def pack_tris(tri_pos) -> torch.Tensor:
    """(T, 12) float32, three 16-byte records a triangle: v0, e1 = v1 - v0
    and e2 = v2 - v0 (the fp32 subtractions of ``_moller``, done once),
    each padded with a zero."""
    v0 = tri_pos[:, 0]
    pad = torch.zeros_like(v0[:, :1])
    return torch.cat([v0, pad, tri_pos[:, 1] - v0, pad, tri_pos[:, 2] - v0, pad],
                     dim=1).contiguous()


def pack_wide_nodes(nodes_min, nodes_max, nodes_meta):
    """The binary BVH collapsed to up to WIDE children a node, for K2:
    (M, 28) int32, seven 16-byte records a node: the bits of the children's
    min.x, min.y, min.z, max.x, max.y, max.z (one record each, a lane a
    child) and the child words. A child word is the index of an inner
    child's node (>= 0), ``~(first_tri * 8 + tri_count)`` for a leaf, or
    WIDE_EMPTY for an unused slot (its box is zeros and is never entered).

    A node's children are its two binary children, the inner child of
    largest surface area replaced by its own two children until WIDE
    are reached or all are leaves. Every child keeps the box of its binary
    node, and every leaf of the binary tree is the child of exactly one
    node, so any-hit visibility (which tests a leaf's triangles iff the
    leaf's box and all boxes above it are hit, and a box lies inside its
    parent's) is the same function on either tree. Node 0 is the root,
    nodes are in depth-first order. Raises if a walk could need more than
    WIDE_STACK stack entries. Returns (packed, sources): sources (M, WIDE)
    int64 on the CPU is the binary node whose box fills each slot, -1 for
    an unused slot, so that a refit regathers the boxes without this host
    loop."""
    lo = nodes_min.detach().cpu().numpy()
    hi = nodes_max.detach().cpu().numpy()
    meta = nodes_meta.detach().cpu().numpy().astype(np.int64)
    N = meta.shape[0]
    if N == 0:
        return (torch.zeros((0, 7 * WIDE), dtype=torch.int32, device=nodes_min.device),
                torch.zeros((0, WIDE), dtype=torch.int64))
    if meta[:, 1].max() > 7 or meta[:, 0].max() >= 1 << 28:
        raise ValueError("pack_wide_nodes: a leaf holds more than 7 triangles or starts past 2^28")
    ext = np.maximum(hi - lo, 0.0).astype(np.float64)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    is_leaf = meta[:, 1] > 0

    def children(i):
        return [i + 1, int(meta[i + 1, 2])]

    groups = []  # a node's children, as binary node indices
    index_of = {}  # binary inner node -> its wide node
    pending = [0]
    if is_leaf[0]:  # a one-leaf tree: a root whose only child is the leaf
        groups.append([0])
        pending = []
    while pending:  # depth first: a node's subtrees follow it
        i = pending.pop()
        index_of[i] = len(groups)
        kids = children(i)
        while len(kids) < WIDE:
            inner = [k for k in kids if not is_leaf[k]]
            if not inner:
                break
            big = max(inner, key=lambda k: area[k])
            at = kids.index(big)
            kids[at:at + 1] = children(big)
        groups.append(kids)
        pending.extend(k for k in reversed(kids) if not is_leaf[k])

    M = len(groups)
    boxes = np.zeros((M, 6, WIDE), np.float32)
    words = np.full((M, WIDE), WIDE_EMPTY, np.int64)
    sources = np.full((M, WIDE), -1, np.int64)
    need = np.zeros(M, np.int64)  # stack entries a walk below this node can hold
    for w in range(M - 1, -1, -1):  # children come after their parent
        below = 1  # a leaf child is tested from the stack too
        for slot, k in enumerate(groups[w]):
            boxes[w, 0:3, slot] = lo[k]
            boxes[w, 3:6, slot] = hi[k]
            sources[w, slot] = k
            if is_leaf[k]:
                words[w, slot] = ~(meta[k, 0] * 8 + meta[k, 1])
            else:
                words[w, slot] = index_of[k]
                below = max(below, need[index_of[k]])
        # all but one of the hit children wait on the stack below it
        need[w] = len(groups[w]) - 1 + below
    if need[0] > WIDE_STACK:
        raise ValueError(f"pack_wide_nodes: a walk may need {need[0]} stack entries, "
                         f"more than {WIDE_STACK}")
    packed = np.concatenate([boxes.reshape(M, 6 * WIDE).view(np.int32),
                             words.astype(np.int32)], axis=1)
    return (torch.from_numpy(np.ascontiguousarray(packed)).to(nodes_min.device),
            torch.from_numpy(sources))


def refit_plan(nodes_meta, wide_sources, device) -> RefitPlan:
    """The refit's index tables for a tree (host numpy, once): leaves and
    their triangle slots; inner nodes grouped by depth, children i + 1
    and meta[i + 1, 2]; the wide slots' binary nodes."""
    meta = nodes_meta.detach().cpu().numpy().astype(np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    inner = meta[:, 1] == 0
    leaves = np.nonzero(~inner)[0]
    count = meta[leaves, 1]
    K = int(count.max()) if leaves.size else 1
    first = meta[leaves, 0][:, None]
    slots = np.arange(K)
    used = slots[None, :] < count[:, None]
    tris = np.where(used, first + slots, first)  # an unused slot reads the first
    levels = []
    frontier = np.zeros(min(meta.shape[0], 1), np.int64)  # the root
    while (nodes := frontier[inner[frontier]]).size:
        left = nodes + 1
        right = meta[left, 2]
        levels.append((t(nodes), t(left), t(right)))
        frontier = np.concatenate([left, right])
    src = wide_sources.cpu().numpy()
    return RefitPlan(leaf_nodes=t(leaves), leaf_tris=t(tris), leaf_used=t(used[..., None]),
                     levels=levels[::-1], wide_src=t(np.maximum(src, 0)),
                     wide_used=t((src >= 0)[..., None]))


def make_trace_scene(scene: SceneArrays) -> TraceScene:
    if scene.bvh_nodes_min is None:
        raise ValueError("scene was built without a BVH (use_bvh=False)")
    nodes_min = scene.bvh_nodes_min.contiguous()
    nodes_max = scene.bvh_nodes_max.contiguous()
    nodes_meta = scene.bvh_nodes_meta.to(torch.int32).contiguous()
    tri_pos = scene.tri_pos.contiguous()
    wide_packed, sources = pack_wide_nodes(nodes_min, nodes_max, nodes_meta)
    return TraceScene(
        nodes_min=nodes_min, nodes_max=nodes_max, nodes_meta=nodes_meta,
        tri_pos=tri_pos, attrs=attr_table(scene),
        nodes_packed=pack_nodes(nodes_min, nodes_max, nodes_meta),
        tris_packed=pack_tris(tri_pos), wide_packed=wide_packed,
        plan=refit_plan(nodes_meta, sources, tri_pos.device),
    )


def refit_trace_scene(ts: TraceScene, scene: SceneArrays) -> TraceScene:
    """`ts`'s tree over the moved soup of `scene` (same triangle order):
    the binary boxes bottom-up, leaves from their triangles and each inner
    node the union of its two children, level by level; then
    ``nodes_packed``, ``tris_packed``, the attribute table and K2's
    ``wide_packed`` boxes regathered through the plan. Plain PyTorch ops
    on the scene's device, no host loop and no read-back. Closest hit and
    any-hit do not depend on the tree, so the result is exact however
    loose the moved tree gets; only the walk's speed does."""
    plan = ts.plan
    tri_pos = scene.tri_pos.contiguous()
    # a box as [lo, -hi]: one minimum joins both halves
    tri_box = torch.cat([tri_pos.amin(dim=1), -tri_pos.amax(dim=1)], dim=1)
    leaf = torch.where(plan.leaf_used, tri_box[plan.leaf_tris], torch.inf).amin(dim=1)
    box = torch.empty((ts.nodes_min.shape[0], 6), dtype=tri_pos.dtype, device=tri_pos.device)
    box[plan.leaf_nodes] = leaf
    for nodes, left, right in plan.levels:
        box[nodes] = torch.minimum(box[left], box[right])
    nodes_min = box[:, :3].contiguous()
    nodes_max = (-box[:, 3:]).contiguous()
    M = ts.wide_packed.shape[0]
    wide = torch.where(plan.wide_used, torch.cat([nodes_min, nodes_max], dim=1)[plan.wide_src],
                       0.0)  # (M, WIDE, 6)
    wide_boxes = wide.transpose(1, 2).reshape(M, 6 * WIDE).contiguous()
    return dataclasses.replace(
        ts, nodes_min=nodes_min, nodes_max=nodes_max, tri_pos=tri_pos, attrs=attr_table(scene),
        nodes_packed=torch.cat([nodes_min.view(torch.int32), ts.nodes_packed[:, 3:4],
                                nodes_max.view(torch.int32), ts.nodes_packed[:, 7:8]],
                               dim=1).contiguous(),
        tris_packed=pack_tris(tri_pos),
        wide_packed=torch.cat([wide_boxes.view(torch.int32), ts.wide_packed[:, 6 * WIDE:]],
                              dim=1).contiguous())


# ---------------------------------------------------------------------------
# Plain walk (PyTorch) — the reference for K1/K2
# ---------------------------------------------------------------------------


def _safe_inv(direction):
    """1/d with |d| < 1e-12 replaced by +-1e-12 (JAX bvh.py:199-200)."""
    tiny = torch.where(direction < 0, -1e-12, 1e-12).to(direction.dtype)
    return 1.0 / torch.where(torch.abs(direction) < 1e-12, tiny, direction)


def _dot(a, b):
    # written out so the kernel can follow the same rounding order
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
             any_hit=False, stats=None) -> Hit:
    """Stackless skip-link walk over (R,3) rays with per-ray t_max (R,).
    Semantics of the JAX ``traverse``: inclusive slab test clipped to
    [t_min, best t]; leaf lanes tested in order with a strict ``t < best``
    so the first of equal minima wins; with any_hit a ray stops after the
    first leaf that yields a hit. Rays with t_max <= t_min hit nothing
    (visibility 1). `stats` is for chip_smoke.py's bound only: with a
    dict, adds the walk's node visits ("nodes") and ray-triangle tests
    ("tris") to it, the work K1/K2 do on these rays."""
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
        if stats is not None:
            stats["nodes"] = stats.get("nodes", 0) + live.numel()
            stats["tris"] = stats.get("tris", 0) + int(
                torch.clamp(count[sel], max=LEAF_SIZE).sum())
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


def closest_hit_attrs_plain(ts: TraceScene, origin, direction, t_max, t_min=1e-3,
                            stats=None):
    """Plain K1: (Hit, (R,24) attribute rows; zeros on a miss). `stats`:
    see ``traverse``."""
    hit = traverse(ts, origin, direction, t_max, t_min, stats=stats)
    rows = ts.attrs[torch.clamp(hit.tri_id, min=0).to(torch.int64)]
    attrs = torch.where(hit.valid[:, None], rows, torch.zeros_like(rows))
    return hit, attrs


def visibility_plain(ts: TraceScene, origin, direction, t_max, t_min=1e-3, stats=None):
    """Plain K2: (R,) 1.0 visible / 0.0 blocked. `stats`: see
    ``traverse``."""
    hit = traverse(ts, origin, direction, t_max, t_min, any_hit=True, stats=stats)
    return torch.where(hit.valid, 0.0, 1.0).to(origin.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (K1, K2)
# ---------------------------------------------------------------------------


def _check_rays(ts: TraceScene, origin, direction, t_max):
    """(R, launch device): the rays' device, which every operand must share."""
    R, dev = origin.shape[0], origin.device
    kernels.require(origin, "origin", torch.float32, (R, 3), dev)
    kernels.require(direction, "direction", torch.float32, (R, 3), dev)
    kernels.require(t_max, "t_max", torch.float32, (R,), dev)
    kernels.require(ts.nodes_packed, "nodes_packed", torch.int32,
                    (ts.nodes_min.shape[0], 8), dev)
    kernels.require(ts.tris_packed, "tris_packed", torch.float32,
                    (ts.tri_pos.shape[0], 12), dev)
    return R, dev


def closest_hit_attrs(ts: TraceScene, origin, direction, t_max, t_min=1e-3):
    """K1: closest hit with t in (t_min, t_max) plus the hit triangle's
    attribute row. origin/direction (R,3), t_max (R,). Returns
    (Hit with (R,) fields, (R,24) attrs). CPU tensors take the plain walk;
    CUDA tensors launch csrc/trace.cu."""
    if kernels.on_cpu(origin):
        return closest_hit_attrs_plain(ts, origin, direction, t_max, t_min)
    R, dev = _check_rays(ts, origin, direction, t_max)
    kernels.require(ts.attrs, "attrs", torch.float32, (ts.tri_pos.shape[0], ATTR), dev)
    t, u, v = torch.empty((3, R), dtype=torch.float32, device=dev).unbind(0)
    tri_id = torch.empty(R, dtype=torch.int32, device=dev)
    attrs = torch.empty((R, ATTR), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = kernels.lib().hr_trace_closest(
            ts.nodes_packed.data_ptr(), ts.nodes_packed.shape[0], ts.tris_packed.data_ptr(),
            ts.attrs.data_ptr(), ts.tris_packed.shape[0], origin.data_ptr(),
            direction.data_ptr(), t_max.data_ptr(), R, t_min,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), tri_id.data_ptr(), attrs.data_ptr(),
            kernels.stream_ptr(dev))
    kernels.check(err, "hr_trace_closest")
    closest_hit_attrs.launches += 1
    return Hit(t=t, tri_id=tri_id, u=u, v=v), attrs


def visibility(ts: TraceScene, origin, direction, t_max, t_min=1e-3):
    """K2: any-hit visibility, (R,) 1.0 = unoccluded. A ray with
    t_max <= t_min is visible (the bvh rule). CPU tensors take the plain
    walk; CUDA tensors launch csrc/trace.cu, which walks ``wide_packed``
    and answers every ray as the plain walk does."""
    if kernels.on_cpu(origin):
        return visibility_plain(ts, origin, direction, t_max, t_min)
    R, dev = _check_rays(ts, origin, direction, t_max)
    kernels.require(ts.wide_packed, "wide_packed", torch.int32,
                    (ts.wide_packed.shape[0], 7 * WIDE), dev)
    vis = torch.empty(R, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = kernels.lib().hr_trace_visibility(
            ts.wide_packed.data_ptr(), ts.wide_packed.shape[0], ts.tris_packed.data_ptr(),
            ts.tris_packed.shape[0], origin.data_ptr(), direction.data_ptr(),
            t_max.data_ptr(), R, t_min, vis.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "hr_trace_visibility")
    visibility.launches += 1
    return vis


closest_hit_attrs.launches = 0
visibility.launches = 0


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


METHODS = ("auto", "bvh", "flash", "flash_dense", "brute")


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown tracer method {method!r}; expected one of {METHODS}")


def make_accel(scene: SceneArrays, method: str = "auto"):
    """What the tracers of `method` read: a FlashScene with the attribute
    table for "flash_dense", None for "brute", the TraceScene otherwise.
    Build it once and pass it to both tracer factories."""
    _check_method(method)
    if method == "flash_dense":
        return flashtrace.make_flash_scene(scene.tri_pos, attr_table(scene))
    if method == "brute":
        return None
    return make_trace_scene(scene)


def refit_accel(accel, scene: SceneArrays, method: str = "auto"):
    """``make_accel(scene, method)`` for a scene whose soup moved (same
    triangles, same order) from the one `accel` was built for: a
    TraceScene is refitted (``refit_trace_scene``), anything else made
    anew from the moved soup."""
    if isinstance(accel, TraceScene):
        return refit_trace_scene(accel, scene)
    return make_accel(scene, method)


def make_tracers(scene: SceneArrays, ts=None, method: str = "auto"):
    """Returns (closest_hit_fn, visibility_fn) bound to a scene:
    closest_hit_fn(origin, dir, t_max) -> Hit and
    visibility_fn(origin, dir, t_max) -> 1.0 visible / 0.0 blocked, for
    (..., 3) rays. `ts` is ``make_accel(scene, method)``, built here when
    None.

    method (the JAX package's names):
      "auto", "bvh", "flash" — the skip-link walk: K1/K2 on the card, the
                plain walk on the CPU ("flash", the TPU's sparse tracer,
                computes the same function);
      "flash_dense" — every ray against every triangle: K6/K6′ on the
                card, their plain versions on the CPU. Masked rays
                (t_max <= t_min) are blocked, not visible;
      "brute" — the plain oracle of ops/intersect.py."""
    _check_method(method)
    ts = ts if ts is not None else make_accel(scene, method)
    if method == "flash_dense":
        return (_make_flat(lambda o, d, tm: flashtrace.flash_closest_hit(ts, o, d, tm)),
                _make_flat(lambda o, d, tm: flashtrace.flash_visibility(ts, o, d, tm)))
    if method == "brute":
        return (_make_flat(lambda o, d, tm: intersect.closest_hit_brute(scene.tri_pos, o, d, tm)),
                _make_flat(lambda o, d, tm: intersect.occluded_brute(scene.tri_pos, o, d, tm)))
    return (_make_flat(lambda o, d, tm: closest_hit_attrs(ts, o, d, tm)[0]),
            _make_flat(lambda o, d, tm: visibility(ts, o, d, tm)))


def make_surface_tracer(scene: SceneArrays, ts=None, method: str = "auto"):
    """Returns closest_surface(origin, dir, t_max) -> (Hit, Surface); `ts`
    as in ``make_tracers``. With the walk (K1) and "flash_dense" (K6) the
    kernel's attribute rows become the Surface through
    ``surface_from_attrs`` (no per-ray gathers from the scene arrays);
    "brute" gathers with ``fetch_surface`` as the JAX package's oracle path
    does."""
    from hybrid_rendering_torch.scene.fetch import fetch_surface, surface_from_attrs

    _check_method(method)
    ts = ts if ts is not None else make_accel(scene, method)
    if method == "flash_dense":
        def flat(o, d, tm):
            hit, attrs = flashtrace.flash_closest_hit_attrs(ts, o, d, tm)
            return hit, surface_from_attrs(scene, o, d, hit, attrs)
    elif method == "brute":
        def flat(o, d, tm):
            hit = intersect.closest_hit_brute(scene.tri_pos, o, d, tm)
            return hit, fetch_surface(scene, o, d, hit)
    else:
        def flat(o, d, tm):
            hit, attrs = closest_hit_attrs(ts, o, d, tm)
            return hit, surface_from_attrs(scene, o, d, hit, attrs)

    return _make_flat(flat)
