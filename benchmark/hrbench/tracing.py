"""The traced run's record: one torch.profiler session over a few steady
frames after the timed window, with the benchmark's own ranges around the
passes the renderer calls, ray counts at the tracers' entry points, the
inputs of the stencil and sampler calls, and PyTorch's sync debug mode
counting the frame's host waits.

Every hook is installed from the benchmark's files by wrapping module
attributes and the renderer's tracer attributes for the traced frames
only, and taken off after them. The record stays in memory; a reader in
``benchmark/metrics`` turns it into one per-layer metric."""
from __future__ import annotations

import collections
import functools
import re
import time
import warnings
from typing import Dict, List, Tuple

import torch

from hrbench import roofline, stats

SYNC_WARNING = "called a synchronizing CUDA operation"

# device kernels by name: K1 and K2 (csrc/trace.cu), K3 and K4
# (csrc/stencil.cu), K5 (csrc/ddgi_sample.cu)
TRACE_KERNELS = re.compile(r"(?<![\w])(closest_kernel|anyhit_kernel)\b")
FILTER_KERNELS = re.compile(r"(?<![\w])(atrous_tile_kernel|blur_tile_kernel|ddgi_sample_kernel)\b")

class _CountingTracer:
    """A tracer of the renderer with its rays counted and a range around
    each call; ``.many`` counts every request."""

    def __init__(self, fn, kind, hooks):
        self.fn, self.kind, self.hooks = fn, kind, hooks

    def __call__(self, origin, direction, t_max):
        self.hooks.rays.append((self.kind, origin.numel() // 3))
        with torch.profiler.record_function(f"hr::trace.{self.kind}"):
            return self.fn(origin, direction, t_max)

    def many(self, reqs):
        self.hooks.rays.append((self.kind, sum(r[0].numel() // 3 for r in reqs)))
        with torch.profiler.record_function(f"hr::trace.{self.kind}"):
            return self.fn.many(reqs)


class Hooks:
    """Wrappers installed for the traced frames of one run."""

    def __init__(self, renderer, passes):
        self.renderer = renderer
        self.passes = passes  # (module of hybrid_rendering_torch.models, function)
        self.host_s: Dict[str, float] = collections.defaultdict(float)
        self.rays: List[Tuple[str, int]] = []
        self.k3: list = []  # (channels, pixels, mask, iterations, radius)
        self.k4: list = []  # (pixels, mask, radius)
        self.k5: list = []  # (points, atlas floats)
        self.waits = 0
        self._saved: list = []

    def _timed(self, name, fn):
        host_s = self.host_s

        @functools.wraps(fn)
        def run(*args, **kw):
            with torch.profiler.record_function(f"hr::{name}"):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    host_s[name] += time.perf_counter() - t0
        return run

    def _patch(self, obj, attr, new):
        self._saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    def install(self):
        import importlib

        from hybrid_rendering_torch.ops import ddgi_sample, stencil

        for mod_name, fn_name in self.passes:
            mod = importlib.import_module(f"hybrid_rendering_torch.models.{mod_name}")
            self._patch(mod, fn_name, self._timed(fn_name, getattr(mod, fn_name)))
        r = self.renderer
        self._patch(r, "closest_surface_fn", _CountingTracer(r.closest_surface_fn, "closest", self))
        self._patch(r, "visibility_fn", _CountingTracer(r.visibility_fn, "visibility", self))

        atrous, blur, sampler = stencil.atrous_chain, stencil.bilateral_blur, \
            ddgi_sample.sample_irradiance

        @functools.wraps(atrous)
        def atrous_rec(color, variance, normal, depth, mask, *, steps, radius=1, **kw):
            C = 1 if color.dim() == 2 else color.shape[-1]
            self.k3.append((C, depth.numel(), mask, len(steps), int(radius)))
            return atrous(color, variance, normal, depth, mask, steps=steps, radius=radius, **kw)

        @functools.wraps(blur)
        def blur_rec(img, normal, depth, mask, *, radius=4, **kw):
            self.k4.append((img.numel(), mask, int(radius)))
            return blur(img, normal, depth, mask, radius=radius, **kw)

        @functools.wraps(sampler)
        def sampler_rec(grid, state, cfg, p, n, wo, scalars=None):
            self.k5.append((p.numel() // 3, state.irradiance.numel() + state.depth.numel()))
            return sampler(grid, state, cfg, p, n, wo, scalars)

        self._patch(stencil, "atrous_chain", atrous_rec)
        self._patch(stencil, "bilateral_blur", blur_rec)
        self._patch(ddgi_sample, "sample_irradiance", sampler_rec)

    def remove(self):
        while self._saved:
            obj, attr, old = self._saved.pop()
            setattr(obj, attr, old)

    def counting_waits(self, fn):
        """fn() under PyTorch's sync debug mode; its host waits are added
        to ``waits``."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                self.waits += sum(SYNC_WARNING in str(w.message) for w in caught)

    def bounds(self, triangles: int) -> Dict[str, float]:
        """Σ of the least times of the traced frames' K1/K2 calls and of
        their K3/K4/K5 calls (read once the window has closed)."""
        trace = sum(roofline.trace_bound(kind, n, triangles) for kind, n in self.rays)
        filt = sum(roofline.atrous_bound(C, px, int(m.sum()), it, rad)
                   for C, px, m, it, rad in self.k3)
        filt += sum(roofline.blur_bound(px, int(m.sum()), rad) for px, m, rad in self.k4)
        filt += sum(roofline.sampler_bound(n, a) for n, a in self.k5)
        return {"trace": trace, "filter": filt}


def _events(prof):
    """(device ops, host ranges) of a finished session as (name, start ns,
    end ns): every operation on the card, and the benchmark's ``hr::``
    ranges on the host."""
    dev, ranges = [], []
    kineto = getattr(prof.profiler, "kineto_results", None)
    if kineto is not None:
        rows = []
        for e in kineto.events():
            if hasattr(e, "start_ns"):
                a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            else:
                a, b = e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000
            rows.append((e.name(), e.device_type(), a, b))
    else:  # the slower FunctionEvent list
        rows = [(e.name, e.device_type, e.time_range.start * 1000, e.time_range.end * 1000)
                for e in prof.events()]
    for name, kind, a, b in rows:
        ours = name.startswith("hr::")
        if kind == torch.autograd.DeviceType.CUDA:
            if not ours:  # the profiler mirrors the host ranges on the device's timeline
                dev.append((name, a, b))
        elif ours:
            ranges.append((name[4:], a, b))
    return dev, ranges


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def record(prof, hooks: Hooks, frames: int, triangles: int) -> dict:
    """The traced frames as plain numbers, and the breakdown."""
    dev, ranges = _events(prof)
    frame_spans = [(a, b) for n, a, b in ranges if n == "frame"]
    lo = min(a for a, _ in frame_spans)
    hi = max([b for _, b in frame_spans] + [b for _, a, b in dev if a >= lo])
    dev = [(n, a, b) for n, a, b in dev if b > lo]
    busy_ns, gaps = stats.busy_and_gaps(((a, b) for _, a, b in dev), lo, hi)
    kernels = [(n, a, b) for n, a, b in dev if is_kernel(n)]

    by_op: Dict[str, float] = collections.defaultdict(float)
    for n, a, b in dev:
        by_op[n] += (b - a) / 1e9
    by_kernel = {n: t for n, t in by_op.items() if is_kernel(n)}
    # idle time named by the innermost benchmark range open on the host:
    # each gap is cut where a range opens or closes
    inner = sorted(((b - a, n, a, b) for n, a, b in ranges if n != "frame"))
    cuts = sorted({t for _, _, a, b in inner for t in (a, b)} | {t for s in frame_spans for t in s})
    idle_by: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        edges = [a] + [t for t in cuts if a < t < b] + [b]
        for x, y in zip(edges, edges[1:]):
            name = next((n for _, n, ra, rb in inner if ra <= x < rb), None)
            if name is None:
                name = "frame loop" if any(ra <= x < rb for ra, rb in frame_spans) else \
                    "between frames"
            idle_by[name] += (y - x) / 1e9

    bounds = hooks.bounds(triangles)
    return {
        "frames": frames,
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": len(kernels),
        "waits": hooks.waits,
        "rays": sum(n for _, n in hooks.rays),
        "host_s": dict(hooks.host_s),
        "kernel_s": {
            "trace": sum(t for n, t in by_kernel.items() if TRACE_KERNELS.search(n)),
            "filter": sum(t for n, t in by_kernel.items() if FILTER_KERNELS.search(n)),
        },
        "bound_s": bounds,
        "breakdown": {
            "device_ops": [[n[:160], t] for n, t in
                           sorted(by_op.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, t] for n, t in
                          sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]],
        },
    }
