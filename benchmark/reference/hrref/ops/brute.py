"""Brute-force ray-triangle tests: every live ray against every triangle,
in tiles, with the plain walk's arithmetic (``bvh._moller``: products
summed left to right). The path tracer's reference traces a sample of
pixels this way, so that it needs no tree at all."""
from __future__ import annotations

import torch

from hrref.ops.bvh import attr_table
from hrref.types import Hit, SceneArrays

PAIRS = 1 << 24  # ray-triangle pairs a tile tests at once


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _tests(o, d, tri, t_min):
    """(t, u, v, ok), each (R, K): rays (R,3) against triangles (K,3,3)."""
    v0, v1, v2 = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
    o, d = o[:, None], d[:, None]
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


def _live(origin, direction, t_max, t_min):
    R = origin.shape[0]
    tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=origin.dtype, device=origin.device),
                            (R,))
    live = torch.nonzero(tm > t_min).squeeze(1)
    return tm, live


def closest_hit(tri_pos, origin, direction, t_max, t_min=1e-3) -> Hit:
    """The closest hit with t in (t_min, t_max) of each (R,3) ray; the
    first triangle of equal minima wins."""
    R = origin.shape[0]
    tm, live = _live(origin, direction, t_max, t_min)
    best_t = tm.clone()
    best_id = torch.full((R,), -1, dtype=torch.int64, device=origin.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    if live.numel():
        o, d = origin[live], direction[live]
        bt, bid = best_t[live], best_id[live]
        bu, bv = best_u[live], best_v[live]
        rows = torch.arange(live.numel(), device=origin.device)
        tile = max(1, PAIRS // live.numel())
        for start in range(0, tri_pos.shape[0], tile):
            t, u, v, ok = _tests(o, d, tri_pos[start:start + tile], t_min)
            t = torch.where(ok & (t < bt[:, None]), t, torch.full_like(t, float("inf")))
            k = torch.argmin(t, dim=1)
            tk = t[rows, k]
            better = torch.isfinite(tk)
            bid = torch.where(better, start + k, bid)
            bu = torch.where(better, u[rows, k], bu)
            bv = torch.where(better, v[rows, k], bv)
            bt = torch.where(better, tk, bt)
        best_t[live], best_id[live], best_u[live], best_v[live] = bt, bid, bu, bv
    return Hit(t=best_t, tri_id=best_id.to(torch.int32), u=best_u, v=best_v)


def visibility(tri_pos, origin, direction, t_max, t_min=1e-3):
    """(R,) 1.0 where no triangle lies in (t_min, t_max), else 0.0."""
    R = origin.shape[0]
    tm, live = _live(origin, direction, t_max, t_min)
    blocked = torch.zeros((R,), dtype=torch.bool, device=origin.device)
    if live.numel():
        o, d, tl = origin[live], direction[live], tm[live]
        b = torch.zeros((live.numel(),), dtype=torch.bool, device=origin.device)
        tile = max(1, PAIRS // live.numel())
        for start in range(0, tri_pos.shape[0], tile):
            t, _, _, ok = _tests(o, d, tri_pos[start:start + tile], t_min)
            b |= torch.any(ok & (t < tl[:, None]), dim=1)
        blocked[live] = b
    return torch.where(blocked, 0.0, 1.0).to(origin.dtype)


def make_tracers(scene: SceneArrays):
    """(closest_surface_fn, visibility_fn) over flat (R,3) rays, by brute
    force; the surface from the hit triangle's attribute row, as the
    walk's surface tracer makes it."""
    from hrref.scene.fetch import surface_from_attrs

    attrs = attr_table(scene)
    tri_pos = scene.tri_pos

    def closest_surface(o, d, tm):
        hit = closest_hit(tri_pos, o, d, tm)
        rows = attrs[torch.clamp(hit.tri_id, min=0).to(torch.int64)]
        rows = torch.where(hit.valid[:, None], rows, torch.zeros_like(rows))
        return hit, surface_from_attrs(scene, o, d, hit, rows)

    def vis(o, d, tm):
        return visibility(tri_pos, o, d, tm)

    return closest_surface, vis
