"""Dense FlashTrace: every ray against every triangle through the affine
Möller-Trumbore product — kernels K6 (closest hit, with or without the
winner's attribute row) and K6′ (any-hit visibility).

Port of the dense v1 half of ``hybrid_rendering_tpu/ops/pallas/
flashtrace.py`` (``make_flash_scene`` :113-215, ``_features`` :218,
``_closest_kernel`` :247, ``_anyhit_kernel`` :317). With the ray origin o
and the triangle's v0 recentred on the scene's center, the four
Möller-Trumbore scalars of a ray (o, d) and a triangle (v0, e1, e2),
n = e1 x e2, are affine in the ray's feature vector f = [o, d, o x d, 1]:

    det   = -d . n
    t_num =  o . n - v0 . n
    u_num =  (o x d) . e2 - d . (e2 x v0)
    v_num = -(o x d) . e1 - d . (v0 x e1)

so ``make_flash_scene`` stores, per triangle, the coefficient of each
feature in each scalar; only 19 of the 40 are non-zero (``NONZERO``), and
``coef`` holds those, scalar by scalar, 20 floats a triangle, with zero
rows after the last triangle up to a whole tile of the kernels' scans. A
pair is accepted where |det| > 1e-9 and, with inv_det = 1/det and t, u,
v = num * inv_det, u >= 0, v >= 0, u + v <= 1, t_min < t < t_max.

Two versions of each trace live here:
  - the plain PyTorch version, which sums each scalar's feature terms left
    to right as explicit products and adds (the zero coefficients are
    skipped: adding a zero product changes no rounded partial sum), in
    chunks of rays so that no (rays x triangles) intermediate exceeds
    ~1 GB; used for CPU tensors and as the reference the kernels are held
    to;
  - the CUDA kernels in csrc/flashtrace.cu, used for every CUDA tensor,
    which follow the plain version's operation order and so match it bit
    for bit. Both first reject most pairs by tests without the reciprocal
    that provably never reject a pair the exact test accepts (the source
    derives their slack; tests/test_torch_k6_design.py and
    tests/test_torch_k6p_design.py model them), then run the exact test on
    the rest.

Closest hit keeps the lowest triangle index among equal minima and a
miss keeps t = t_max, u = v = 0, tri_id -1 and an all-zero attribute row.
A ray with t_max <= t_min is **blocked** for K6′ (flashtrace.py:323), where
K2's bvh rule says visible; callers gate such rays out.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from hybrid_rendering_torch.ops import kernels
from hybrid_rendering_torch.types import Hit

FEAT = 10  # [o - center (3), d (3), (o - center) x d (3), 1]
ATTR = 24  # attribute row width (ops/bvh.py attr_table)
# the features with a non-zero coefficient in det, t_num, u_num, v_num
NONZERO = ((3, 4, 5), (0, 1, 2, 9), (3, 4, 5, 6, 7, 8), (3, 4, 5, 6, 7, 8))
COEF = 20  # the 19 non-zero coefficients of a triangle, padded to 20
CHUNK_PAIRS = 1 << 28  # (ray, triangle) pairs per plain-version chunk
TILE = 128  # triangles a tile of K6's and K6′'s scans (csrc/flashtrace.cu)
# the pre-tests of K6 and K6′: relative slack, and the t_min range their
# proof covers
SLACK_LO = float(np.float32(1.0 - 2.0 ** -20))
PRE_T_MIN = (2.0 ** -90, 2.0 ** 20)
# the launch of K6 and K6′, chosen by timings on an H100 (PERF.md): two
# rays a thread from WIDE_BATCH rays up, else one; the most parts the
# triangles split into (only where the rays' blocks fill less than the card)
WIDE_BATCH = 1 << 20
MAX_PARTS = 8


def rays_per_thread(num_rays):
    """K6's and K6′'s rays a thread for a launch of `num_rays` rays."""
    return 2 if num_rays >= WIDE_BATCH else 1


@dataclasses.dataclass
class FlashScene:
    """What K6/K6′ and their plain versions read."""

    # (T', 20) f32: each triangle's non-zero coefficients of det/t/u/v and
    # a zero pad; then zero rows up to whole tiles (pad_tiles), which the
    # plain versions do not read
    coef: torch.Tensor
    center: torch.Tensor  # (3,) recentring offset
    attrs: Optional[torch.Tensor]  # (T, 24) f32 attribute rows, or None
    num_tris: int
    det_bound: float  # the largest |det| coefficients' sum, rounded up (det_bound)


def _cross(a, b):
    """jnp.cross's component order, written out."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def make_flash_scene(tri_pos: torch.Tensor, attrs: Optional[torch.Tensor] = None) -> FlashScene:
    """Coefficient columns of a (T, 3, 3) triangle soup recentred on the
    middle of its bounds (flashtrace.py:130-155). `attrs` is the (T, 24)
    attribute table (``bvh.attr_table``), needed by
    ``flash_closest_hit_attrs`` only."""
    tri_pos = tri_pos.to(torch.float32)
    T = tri_pos.shape[0]
    flat = tri_pos.reshape(-1, 3)
    center = (flat.amin(dim=0) + flat.amax(dim=0)) * 0.5
    v0 = tri_pos[:, 0] - center
    e1 = tri_pos[:, 1] - tri_pos[:, 0]
    e2 = tri_pos[:, 2] - tri_pos[:, 0]
    n = _cross(e1, e2)
    zeros = torch.zeros_like(n)
    zcol = torch.zeros_like(n[:, :1])
    v0n = (v0[:, 0] * n[:, 0] + v0[:, 1] * n[:, 1] + v0[:, 2] * n[:, 2])[:, None]
    det_col = torch.cat([zeros, -n, zeros, zcol], dim=1)
    t_col = torch.cat([n, zeros, zeros, -v0n], dim=1)
    u_col = torch.cat([zeros, -_cross(e2, v0), e2, zcol], dim=1)
    v_col = torch.cat([zeros, -_cross(v0, e1), -e1, zcol], dim=1)
    cols = (det_col, t_col, u_col, v_col)
    coef = torch.cat([cols[q][:, list(ks)] for q, ks in enumerate(NONZERO)]
                     + [zcol], dim=1).contiguous()
    if attrs is not None:
        attrs = attrs.to(torch.float32).contiguous()
        if tuple(attrs.shape) != (T, ATTR):
            raise ValueError(f"attrs: expected shape {(T, ATTR)}, got {tuple(attrs.shape)}")
    return FlashScene(coef=pad_tiles(coef), center=center, attrs=attrs, num_tris=T,
                      det_bound=det_bound(coef))


def det_bound(coef) -> float:
    """The largest |c_0| + |c_1| + |c_2| of det's coefficients over the
    triangles, as a float32 no smaller than the exact sum: K6 bounds a
    ray's |det| by it (|d_x| + |d_y| + |d_z| times it) and takes its
    pre-tests only below 2^100. One host read, when the scene is built."""
    if coef.shape[0] == 0:
        return 0.0
    exact = float(coef[:, :3].double().abs().sum(dim=1).max())
    bound = np.float32(exact)
    return float(bound if bound >= exact else np.nextafter(bound, np.float32(np.inf)))


def pad_tiles(coef):
    """(T, 20) coefficients padded with all-zero rows to a whole number of
    kernel tiles (at least one): a zero row's det is 0, which fails
    |det| > 1e-9 for every ray, so the padding never changes a result."""
    pad = -coef.shape[0] % TILE if coef.shape[0] else TILE
    return torch.cat([coef, coef.new_zeros((pad, coef.shape[1]))]).contiguous()


def features(origin, direction, center):
    """(R, 10) ray features [o - center, d, (o - center) x d, 1]
    (flashtrace.py:218-223, without the padding to 16 lanes)."""
    o = origin - center
    return torch.cat([o, direction, _cross(o, direction), torch.ones_like(o[:, :1])],
                     dim=1).contiguous()


# ---------------------------------------------------------------------------
# Plain versions (PyTorch) — the reference for K6/K6′
# ---------------------------------------------------------------------------


def _affine(feats, coef_t, q):
    """Scalar q of every (ray, triangle) pair: its non-zero feature terms
    summed left to right. (Rc, 10) x (20, T) -> (Rc, T)."""
    ks = NONZERO[q]
    off = sum(len(k) for k in NONZERO[:q])
    acc = feats[:, ks[0], None] * coef_t[off][None, :]
    for i, k in enumerate(ks[1:], start=1):
        acc = acc + feats[:, k, None] * coef_t[off + i][None, :]
    return acc


def pair_tests(fs: FlashScene, feats, t_max, t_min=1e-3):
    """Yields, for each chunk of rays, (slice, det_ok, t, u, v, ok): every
    pair's |det| > 1e-9 test, t, u, v and acceptance, each (Rc, T)."""
    R = feats.shape[0]
    coef_t = fs.coef[:fs.num_tris].T.contiguous()
    step = max(1, CHUNK_PAIRS // max(fs.num_tris, 1))
    for s in range(0, R, step):
        sl = slice(s, min(s + step, R))
        f = feats[sl]
        det = _affine(f, coef_t, 0)
        det_ok = torch.abs(det) > 1e-9
        inv_det = torch.where(det_ok, 1.0 / det, torch.zeros_like(det))
        del det
        t = _affine(f, coef_t, 1) * inv_det
        u = _affine(f, coef_t, 2) * inv_det
        v = _affine(f, coef_t, 3) * inv_det
        del inv_det
        ok = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
              & (t < t_max[sl, None]))
        yield sl, det_ok, t, u, v, ok


def _closest_plain(fs: FlashScene, origin, direction, t_max, t_min, with_attrs):
    R = origin.shape[0]
    feats = features(origin, direction, fs.center)
    t_max = t_max.to(torch.float32)
    best_t = t_max.clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_id = torch.full((R,), -1, dtype=torch.int32, device=origin.device)
    for sl, _, t, u, v, ok in pair_tests(fs, feats, t_max, t_min):
        # the first of equal minima: the lowest triangle index wins a tie
        k = torch.argmin(torch.where(ok, t, torch.full_like(t, float("inf"))), dim=1)
        rows = torch.arange(k.shape[0], device=k.device)
        hit = ok[rows, k]
        best_t[sl] = torch.where(hit, t[rows, k], best_t[sl])
        best_u[sl] = torch.where(hit, u[rows, k], best_u[sl])
        best_v[sl] = torch.where(hit, v[rows, k], best_v[sl])
        best_id[sl] = torch.where(hit, k.to(torch.int32), best_id[sl])
    hit = Hit(t=best_t, tri_id=best_id, u=best_u, v=best_v)
    if not with_attrs:
        return hit
    rows = fs.attrs[torch.clamp(best_id, min=0).to(torch.int64)]
    return hit, torch.where(hit.valid[:, None], rows, torch.zeros_like(rows))


def flash_closest_hit_plain(fs: FlashScene, origin, direction, t_max, t_min=1e-3) -> Hit:
    """Plain K6: closest hit with t in (t_min, t_max). (R,3), (R,3), (R,)."""
    return _closest_plain(fs, origin, direction, t_max, t_min, with_attrs=False)


def flash_closest_hit_attrs_plain(fs: FlashScene, origin, direction, t_max, t_min=1e-3):
    """Plain K6 with the winner's attribute row: (Hit, (R,24))."""
    return _closest_plain(fs, origin, direction, t_max, t_min, with_attrs=True)


def flash_visibility_plain(fs: FlashScene, origin, direction, t_max, t_min=1e-3):
    """Plain K6′: (R,) 1.0 unoccluded, 0.0 blocked; t_max <= t_min is
    blocked."""
    feats = features(origin, direction, fs.center)
    t_max = t_max.to(torch.float32)
    vis = t_max > t_min
    for sl, _, _, _, _, ok in pair_tests(fs, feats, t_max, t_min):
        vis[sl] &= ~ok.any(dim=1)
    return vis.to(origin.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (K6, K6′)
# ---------------------------------------------------------------------------


def _check(fs: FlashScene, origin, direction, t_max):
    """(R, launch device): the rays' device, which every operand must share."""
    R, dev = origin.shape[0], origin.device
    kernels.require(origin, "origin", torch.float32, (R, 3), dev)
    kernels.require(direction, "direction", torch.float32, (R, 3), dev)
    kernels.require(t_max, "t_max", torch.float32, (R,), dev)
    rows = fs.coef.shape[0]
    kernels.require(fs.coef, "coef", torch.float32, (rows, COEF), dev)
    if rows % TILE or rows < max(fs.num_tris, 1):
        raise ValueError(f"coef: {rows} rows do not pad {fs.num_tris} triangles to whole "
                         f"tiles of {TILE}")
    return R, dev


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index, rays_per_thread, any_hit=False):
    """K6's (or, with `any_hit`, K6′'s) scan blocks card `device_index`
    holds at once (the occupancy query runs in that card's context)."""
    name = "hr_flash_visibility_blocks_per_sm" if any_hit else "hr_flash_closest_blocks_per_sm"
    with torch.cuda.device(device_index):
        per_sm = getattr(kernels.lib(), name)(rays_per_thread)
    if per_sm < 1:
        raise RuntimeError(f"{name}({rays_per_thread}): {per_sm}")
    return per_sm * torch.cuda.get_device_properties(device_index).multi_processor_count


def split_parts(num_rays, rays_per_thread, num_tiles, resident, max_parts=MAX_PARTS):
    """Parts K6 splits the triangles into: 1 where the rays' blocks fill the
    card, else as many as bring the blocks up to `resident` (at most
    `max_parts` and the tiles). K6′ applies the same rule on the card to
    its live rays (csrc/flashtrace.cu k6p_parts)."""
    groups = -(-num_rays // (128 * rays_per_thread))
    if groups >= resident:
        return 1
    return max(1, min(max_parts, -(-resident // max(groups, 1)), num_tiles))


def _pre_bounds(t_min):
    """(klo, pre) of the kernels' pre-tests for `t_min`: klo = RN(t_min (1 -
    2^-20)), and pre = 1 where their proof holds (PRE_T_MIN)."""
    t_min32 = np.float32(t_min)
    return float(t_min32 * np.float32(SLACK_LO)), int(PRE_T_MIN[0] <= t_min32 <= PRE_T_MIN[1])


def _launch_closest(fs: FlashScene, origin, direction, t_max, t_min, with_attrs, plan=None):
    """K6's launch. `plan` = (rays a thread, parts of the split) overrides
    the wrapper's choice (``rays_per_thread``, ``split_parts``) only to
    hold every launch path to the plain version on small batches.
    t_min must be >= 0: the merge key orders t > 0 only, and the
    pre-tests' bounds scale the running best."""
    if not t_min >= 0:
        raise ValueError(f"flash_closest_hit on the GPU: t_min must be >= 0, got {t_min}")
    R, dev = _check(fs, origin, direction, t_max)
    feats = features(origin, direction, fs.center)
    num_tiles = fs.coef.shape[0] // TILE
    if plan is None:
        rpt = rays_per_thread(R)
        parts = split_parts(R, rpt, num_tiles, _resident_blocks(dev.index, rpt))
    else:
        rpt, parts = plan[0], min(plan[1], num_tiles)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    tri_id = torch.empty(R, dtype=torch.int32, device=dev)
    ray_list = torch.empty(R, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    keys = torch.empty(R, dtype=torch.int64, device=dev)
    attrs = attr_ptr = out_ptr = None
    if with_attrs:
        if fs.attrs is None:
            raise ValueError("flash_closest_hit_attrs: the FlashScene has no attribute table")
        kernels.require(fs.attrs, "attrs", torch.float32, (fs.num_tris, ATTR), dev)
        attrs = torch.empty((R, ATTR), dtype=torch.float32, device=dev)
        attr_ptr, out_ptr = fs.attrs.data_ptr(), attrs.data_ptr()
    klo, pre = _pre_bounds(t_min)
    with torch.cuda.device(dev):
        err = kernels.lib().hr_flash_closest(
            fs.coef.data_ptr(), num_tiles, attr_ptr, feats.data_ptr(), t_max.data_ptr(), R,
            t_min, klo, pre, fs.det_bound, rpt, parts, ray_list.data_ptr(), count.data_ptr(),
            keys.data_ptr(), t.data_ptr(), u.data_ptr(),
            v.data_ptr(), tri_id.data_ptr(), out_ptr, kernels.stream_ptr(dev))
    kernels.check(err, "hr_flash_closest")
    return Hit(t=t, tri_id=tri_id, u=u, v=v), attrs


def flash_closest_hit(fs: FlashScene, origin, direction, t_max, t_min=1e-3) -> Hit:
    """K6: closest hit with t in (t_min, t_max), every ray against every
    triangle. origin/direction (R,3), t_max (R,). CPU tensors take the
    plain version; CUDA tensors launch csrc/flashtrace.cu (t_min >= 0)."""
    if kernels.on_cpu(origin):
        return flash_closest_hit_plain(fs, origin, direction, t_max, t_min)
    hit, _ = _launch_closest(fs, origin, direction, t_max, t_min, with_attrs=False)
    flash_closest_hit.launches += 1
    return hit


def flash_closest_hit_attrs(fs: FlashScene, origin, direction, t_max, t_min=1e-3):
    """K6 with the winner's attribute row: (Hit, (R,24) rows; zeros on a
    miss)."""
    if kernels.on_cpu(origin):
        return flash_closest_hit_attrs_plain(fs, origin, direction, t_max, t_min)
    out = _launch_closest(fs, origin, direction, t_max, t_min, with_attrs=True)
    flash_closest_hit_attrs.launches += 1
    return out


def _launch_visibility(fs: FlashScene, origin, direction, t_max, t_min, plan=None):
    """K6′'s launch. `plan` = (rays a thread, parts of the split) overrides
    the wrapper's choice (``rays_per_thread``; up to MAX_PARTS parts chosen
    on the card from the live count) only to hold every launch path to the
    plain version on small batches. Any t_min is taken. The scan forms each
    live ray's features from origin, direction and the scene's center."""
    R, dev = _check(fs, origin, direction, t_max)
    kernels.require(fs.center, "center", torch.float32, (3,), dev)
    num_tiles = fs.coef.shape[0] // TILE
    if plan is None:
        rpt = rays_per_thread(R)
        max_parts, resident = MAX_PARTS, _resident_blocks(dev.index, rpt, any_hit=True)
    else:
        # a resident count above any block count: exactly plan[1] parts
        rpt, max_parts, resident = plan[0], plan[1], 1 << 30
    vis = torch.empty(R, dtype=torch.float32, device=dev)
    ray_list = torch.empty(R, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    klo, pre = _pre_bounds(t_min)
    with torch.cuda.device(dev):
        err = kernels.lib().hr_flash_visibility(
            fs.coef.data_ptr(), num_tiles, origin.data_ptr(), direction.data_ptr(),
            fs.center.data_ptr(), t_max.data_ptr(), R, t_min, klo, pre,
            fs.det_bound, rpt, max_parts, resident, ray_list.data_ptr(), count.data_ptr(),
            vis.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "hr_flash_visibility")
    return vis


def flash_visibility(fs: FlashScene, origin, direction, t_max, t_min=1e-3):
    """K6′: any-hit visibility, (R,) 1.0 = unoccluded; a ray with
    t_max <= t_min is blocked (the flash rule). CPU tensors take the plain
    version; CUDA tensors launch csrc/flashtrace.cu (any t_min)."""
    if kernels.on_cpu(origin):
        return flash_visibility_plain(fs, origin, direction, t_max, t_min)
    vis = _launch_visibility(fs, origin, direction, t_max, t_min)
    flash_visibility.launches += 1
    return vis


flash_closest_hit.launches = 0
flash_closest_hit_attrs.launches = 0
flash_visibility.launches = 0
