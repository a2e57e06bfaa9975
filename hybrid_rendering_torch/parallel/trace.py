"""Ray distribution over the mesh: each shard traces its slice of a batch
on its own device.

Port of ``hybrid_rendering_tpu/parallel/trace.py``. Rays are
embarrassingly parallel and the scene and its acceleration structure are
replicated, so a tracer call splits over the ray axis of its batch. An
image-shaped (H, W, 3) batch splits by contiguous row blocks (the row
layout of ``parallel.sharding.frame_shardings``), and each block goes
through the tracer whole, so the tracer blocks its own (H/n, W) pixels. A
flat batch, or an image whose H does not divide by n, is flattened and
padded to a multiple of n by repeating its last ray; the padding is
traced on the last shard and sliced away.

JAX runs the shards in parallel under ``shard_map``. Here shard i runs on
``mesh.devices[i]`` in the order of the mesh, on that device's current
stream: each tracer call is n launches and the concatenation of their
results on the caller's device. Where the mesh repeats a device (one card)
nothing is copied.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from hybrid_rendering_torch.ops import bvh
from hybrid_rendering_torch.parallel.mesh import TILE_AXIS, Mesh, to_device


def _is_array(t_max) -> bool:
    """An array t_max (per-ray limits) shards with the rays; a scalar one
    (a Python number or a 0-d tensor) goes to every shard."""
    return t_max.ndim > 0 if isinstance(t_max, torch.Tensor) else np.ndim(t_max) > 0


def shard_ray_fn(mesh: Mesh, fn):
    """Wrap a tracer ``fn(origin, direction, t_max) -> tensor, Hit, Surface
    or a tuple of those`` (every output leading with the batch's ray axes)
    so that shard i traces its slice of the batch on ``mesh.devices[i]``.
    `fn` is one tracer for every shard, or a sequence of one tracer a shard,
    each bound to its device's copy of the scene
    (``shard_renderer_tracers``). The wrapper has ``.many``, as the port's
    tracers have: the requests are linearized and concatenated as one flat
    batch, which is sharded, and the result is split per request."""
    n = mesh.shape[TILE_AXIS]
    fns = tuple(fn) if isinstance(fn, (list, tuple)) else (fn,) * n
    if len(fns) != n:
        raise ValueError(f"shard_ray_fn: {len(fns)} tracers for {n} shards")

    def run(o, d, tm, tm_arr, home):
        """Trace n equal leading blocks, block i on device i; the results
        concatenated on `home`."""
        size = o.shape[0] // n
        outs = []
        for i, (dev, f) in enumerate(zip(mesh.devices, fns)):
            sl = slice(i * size, (i + 1) * size)
            outs.append(f(o[sl].to(dev, non_blocking=True), d[sl].to(dev, non_blocking=True),
                          (tm[sl] if tm_arr else tm).to(dev, non_blocking=True)))
        return bvh._map(lambda *parts: torch.cat([p.to(home, non_blocking=True)
                                                  for p in parts]), *outs)

    def wrapped(origin, direction, t_max):
        shape = tuple(origin.shape[:-1])
        tm, tm_arr = t_max, _is_array(t_max)
        if tm_arr:
            tm = torch.broadcast_to(
                torch.as_tensor(t_max, dtype=origin.dtype, device=origin.device), shape)
        elif not isinstance(t_max, torch.Tensor):
            # a number becomes one 0-d tensor filled on the batch's device:
            # each shard's tracer would otherwise copy it from the host, a
            # blocking copy a shard where the unsharded call makes one
            tm = torch.full((), float(t_max), dtype=origin.dtype, device=origin.device)
        if len(shape) == 2 and shape[0] % n == 0:
            return run(origin, direction, tm, tm_arr, origin.device)
        o, d = origin.reshape(-1, 3), direction.reshape(-1, 3)
        tm = tm.reshape(-1) if tm_arr else tm
        N = o.shape[0]
        pad = (-N) % n
        if pad:
            # the last ray repeated: traced again on the last shard, sliced
            # away below (never a NaN-producing ray)
            o = torch.cat([o, o[-1:].expand(pad, 3)])
            d = torch.cat([d, d[-1:].expand(pad, 3)])
            if tm_arr:
                tm = torch.cat([tm, tm[-1:].expand(pad)])
        out = run(o, d, tm, tm_arr, origin.device)
        return bvh._map(lambda a: a[:N].reshape(shape + tuple(a.shape[1:])), out)

    wrapped.many = lambda reqs: bvh._concat_trace_split(wrapped, reqs)
    return wrapped


def replicate(mesh: Mesh, scene, accel, base=None) -> dict:
    """``{device: (scene, accel)}`` for every distinct device of the mesh
    other than the scene's own: copies of `scene` and of `accel`
    (``bvh.make_accel(scene, method)``), one a device. The scene's own
    device needs none: its shards trace with the caller's tracers. With
    `base` = (scene0, accel0, replicas0), where `scene` and `accel` are a
    refit of scene0 and accel0, a copy reuses replicas0's copy of every
    tensor the refit kept and copies the others from the scene's device
    without waiting for the host (``non_blocking``)."""
    home = scene.device
    out = {}
    for dev in dict.fromkeys(mesh.devices):
        if dev == home:
            continue
        if base is None:
            out[dev] = (to_device(scene, dev), to_device(accel, dev))
        else:
            scene0, accel0, replicas0 = base
            out[dev] = (_refresh(scene, scene0, replicas0[dev][0], dev),
                        _refresh(accel, accel0, replicas0[dev][1], dev))
    return out


def _refresh(new, old, old_copy, device):
    """`new` on `device`, where `old_copy` is `old` on `device`: what `new`
    shares with `old` comes from `old_copy`, the rest is copied."""
    if new is old:
        return old_copy
    if type(new) is not type(old):
        return to_device(new, device, non_blocking=True)
    if dataclasses.is_dataclass(new):
        out = copy.copy(old_copy)
        for f in dataclasses.fields(new):
            object.__setattr__(out, f.name, _refresh(getattr(new, f.name), getattr(old, f.name),
                                                     getattr(old_copy, f.name), device))
        return out
    if isinstance(new, (list, tuple)) and len(new) == len(old):
        return type(new)(_refresh(a, b, c, device) for a, b, c in zip(new, old, old_copy))
    return to_device(new, device, non_blocking=True)


def shard_renderer_tracers(mesh: Mesh, closest, vis, surface, replicas=None,
                           method: str = "auto"):
    """Shard the three HybridRenderer tracers over the mesh. A shard on a
    device of `replicas` (``replicate``) traces with tracers of `method`
    bound to that device's copy of the scene; every other shard calls the
    given tracers (the mesh's devices that are theirs)."""
    own = (closest, vis, surface)
    made = {}
    for dev, (scene, accel) in (replicas or {}).items():
        c, v = bvh.make_tracers(scene, accel, method)
        made[dev] = (c, v, bvh.make_surface_tracer(scene, accel, method))
    per_shard = [made.get(dev, own) for dev in mesh.devices]
    return tuple(shard_ray_fn(mesh, [t[k] for t in per_shard]) for k in range(3))
