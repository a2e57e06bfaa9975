"""Tracing and timing — the DW_SCOPED_SAMPLE replacement (SURVEY §5), the
port of ``hybrid_rendering_tpu/utils/profiler.py``.

The reference nests RAII GPU-timestamp scopes per pass and shows them in an
ImGui panel (dw::profiler::ui, main.cpp:681-682). Here the program's one
tracing system is spans, and counters attributed to spans:

  - ``span(name)``: a named range at a layer boundary of the frame. Off, the
    default, it is one flag check that returns a shared no-op context: no
    profiler range, no clock read, no allocation. On, while ``enable()``
    holds or while a torch.profiler session records, it opens
    ``torch.profiler.record_function("hr::" + path)``, so that the span sits
    on the session's clock beside the device rows, and it records per span
    path (parent/child, ``render_frame/reflections/ray_trace``) its calls,
    its inclusive host seconds and its self host seconds (inclusive less
    its children's), on a span stack per thread;
  - ``tracer_call(kind, batch)``: the leaf span ``closest`` or ``visibility``
    of one tracer call, with the call's rays added to the ``rays`` counter
    at its path; a call inside a call of the same kind (a sharded tracer
    calling its shards' tracers) is not counted again;
  - ``collect()`` returns the record and clears it; ``table(record)`` is its
    text form, the profiler panel's;
  - ``FrameTimer``: host-side hierarchical wall timings, each region fenced
    by ``torch.cuda.synchronize()`` on a CUDA device (nothing to fence on
    the CPU), printed as the text equivalent of the profiler panel. It opens
    no profiler session: a session slows every later frame of the process.

The record stays in memory until ``collect()``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List

import torch
import torch.autograd.profiler as _session  # its _is_profiler_enabled: a session records

_enabled = False
_local = threading.local()  # .stack: the open spans of the thread
_lock = threading.Lock()
_spans: Dict[str, List[float]] = {}  # path -> [calls, host seconds, self host seconds]
_counters: Dict[str, Dict[str, int]] = {}  # counter -> path -> total


def enable() -> None:
    """Spans on, with or without a torch.profiler session."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Spans off, except while a torch.profiler session records."""
    global _enabled
    _enabled = False


def collect() -> dict:
    """The record since the last ``collect()``, and clears it:
    ``{"spans": {path: {"calls", "host_s", "self_s"}}, "counters": {name:
    {path: total}}}``."""
    with _lock:
        spans = {p: {"calls": int(c), "host_s": t, "self_s": s}
                 for p, (c, t, s) in _spans.items()}
        counters = {k: dict(v) for k, v in _counters.items()}
        _spans.clear()
        _counters.clear()
    return {"spans": spans, "counters": counters}


_OFF = contextlib.nullcontext()  # the span of every call while tracing is off


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "rays", "path", "row", "child_s", "t0", "range")

    def __init__(self, name: str, rays: int = 0):
        self.name, self.rays = name, rays

    def __enter__(self):
        stack = _stack()
        self.path = f"{stack[-1].path}/{self.name}" if stack else self.name
        # a path's row is made when it first opens, so the record lists
        # parents before children, in the order they first ran
        with _lock:
            self.row = _spans.setdefault(self.path, [0, 0.0, 0.0])
            if self.rays:
                rays = _counters.setdefault("rays", {})
                rays[self.path] = rays.get(self.path, 0) + self.rays
        self.child_s = 0.0
        self.range = torch.profiler.record_function("hr::" + self.path)
        self.range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = _stack()
        stack.pop()
        self.range.__exit__(*exc)
        if stack:
            stack[-1].child_s += dt
        with _lock:
            self.row[0] += 1
            self.row[1] += dt
            self.row[2] += dt - self.child_s
        return False


def span(name: str):
    """The span `name` around a `with` block; a shared no-op when off."""
    if not (_enabled or _session._is_profiler_enabled):
        return _OFF
    return _Span(name)


def tracer_call(kind, batch):
    """The leaf span of one tracer call of `kind` (``"closest"`` or
    ``"visibility"``; None for a tracer of no known kind, which opens none),
    counting its rays: `batch` is the call's origins (..., 3), or the
    requests ((origin, direction, t_max), ...) of a ``.many`` call. Inside
    a call of the same kind it opens nothing and counts nothing, so a ray is
    counted once whatever the path."""
    if not (_enabled or _session._is_profiler_enabled) or kind is None:
        return _OFF
    stack = _stack()
    if stack and stack[-1].name == kind:
        return _OFF
    if isinstance(batch, torch.Tensor):
        rays = batch.numel() // 3
    else:
        rays = sum(r[0].numel() // 3 for r in batch)
    return _Span(kind, rays)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` at the path of the innermost open span
    (``""`` outside every span); nothing while tracing is off."""
    if not (_enabled or _session._is_profiler_enabled):
        return
    stack = _stack()
    path = stack[-1].path if stack else ""
    with _lock:
        totals = _counters.setdefault(name, {})
        totals[path] = totals.get(path, 0) + n


def table(record: dict, frames: int = 1) -> str:
    """The record of ``collect()`` as text, a frame over `frames`: calls,
    host ms, self ms and each counter (``rays`` first) by span path, in
    tree order."""
    counters = record["counters"]
    names = ["rays"] + sorted(c for c in counters if c != "rays")
    widths = [max(10, len(c)) for c in names]
    lines = [f"spans (host wall a frame over {frames} frame(s); self = less the children's):",
             f"  {'span':<40s} {'calls':>6s} {'ms':>9s} {'self ms':>9s}"
             + "".join(f" {c:>{w}s}" for c, w in zip(names, widths))]
    for path, row in record["spans"].items():
        name = "  " * path.count("/") + path.rsplit("/", 1)[-1]
        line = (f"  {name:<40s} {row['calls'] / frames:6.4g} "
                f"{row['host_s'] * 1e3 / frames:9.3f} {row['self_s'] * 1e3 / frames:9.3f}")
        for c, w in zip(names, widths):
            v = counters.get(c, {}).get(path)
            line += f" {'':>{w}s}" if v is None else f" {v / frames:{w}.0f}"
        lines.append(line.rstrip())
    return "\n".join(lines)


class FrameTimer:
    """Host-side per-pass wall timings. On a CUDA `device` every region
    ends in ``torch.cuda.synchronize``, so the time includes the device
    work queued inside it; use it for coarse per-pass numbers."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._stack: List[str] = []

    @contextlib.contextmanager
    def time(self, name: str):
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[path] += time.perf_counter() - t0
            self.counts[path] += 1
            self._stack.pop()

    def report(self) -> str:
        lines = ["frame profiler (host wall, device-fenced):"]
        for path in sorted(self.totals):
            depth = path.count("/")
            name = path.split("/")[-1]
            avg = self.totals[path] / max(self.counts[path], 1)
            lines.append(
                f"  {'  ' * depth}{name:<24s} {avg * 1e3:8.2f} ms "
                f"(x{self.counts[path]})"
            )
        return "\n".join(lines)
