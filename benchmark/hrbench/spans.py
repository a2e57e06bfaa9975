"""The program's own spans and counters in a traced run: the record's
``program`` key, which the readers of the span metrics share.

The program (``hybrid_rendering_torch/utils/profiler.py``) opens its spans
while a torch.profiler session records, each an ``hr::<span path>`` range
on the session's clock (``render_frame/reflections/ray_trace``), and keeps
per span path its calls, host seconds and counters until its
``collect()``. The first reader that asks joins the two, once a run:

  - ``spans``: the program's spans, by span path;
  - ``counters``: every counter of the program (``rays``, ``shaded``,
    ``sky_fn_points``, ...), by name and then by span path;
  - ``waits``: each synchronizing CUDA runtime call of the session
    (``SYNC_CALLS``), counted with the host ms it blocked, put down to the
    innermost program span open when it began (``""`` outside them all);
    None where the session holds no CUDA runtime rows at all;
  - ``idle_s``: the card's idle time over the traced frames (the window the
    harness's ``tracing.record`` measures), put down the same way, every
    span path listed.

The harness hands a reader the record alone; the session is the runner's
``prof``, found on the reader's call stack. A program without these spans
(no ``collect``, or nothing collected) gives ``program`` = None, and every
reader of it nothing."""
from __future__ import annotations

import bisect
import collections
import importlib
import sys
from typing import Dict, List, Optional, Tuple

import torch

from hrbench import stats

SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
OUTSIDE = ""  # the path of time in no program span


def program(record: dict) -> Optional[dict]:
    """The record's ``program`` key, made on the first call of a run."""
    if "program" not in record:
        record["program"] = _build(_session())
    return record["program"]


def _session():
    """The torch.profiler session of the calling run, or None."""
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, torch.profiler.profile):
                return v
        f = f.f_back
    return None


def _build(prof) -> Optional[dict]:
    if prof is None:
        return None
    mod = importlib.import_module("hybrid_rendering_torch.utils.profiler")
    if not hasattr(mod, "collect"):
        return None
    own = mod.collect()
    if not own["spans"]:
        return None
    return dict(spans=own["spans"], counters=own["counters"],
                **join(_rows(prof), set(own["spans"])))


def _rows(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on the card, start ns, end ns) of every row of a finished
    session."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def innermost(spans: List[Tuple[int, int, str]]) -> Tuple[List[int], List[str]]:
    """Where each span is the innermost open one: (edges, paths), path i
    holding from edges[i] to edges[i + 1] and the last to the end
    (``OUTSIDE`` where none is open). `spans` are (start, end, path) that
    nest, as the spans of one thread do."""
    spans = [s for s in spans if s[1] > s[0]]
    # at one instant spans end before others start, and outer ones open first
    events = sorted([(b, 0, 0, i) for i, (_, b, _) in enumerate(spans)]
                    + [(a, 1, a - b, i) for i, (a, b, _) in enumerate(spans)])
    edges: List[int] = []
    paths: List[str] = []
    stack: List[int] = []
    for t, opens, _, i in events:
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        path = spans[stack[-1]][2] if stack else OUTSIDE
        if edges and edges[-1] == t:
            paths[-1] = path
        elif not paths or paths[-1] != path:
            edges.append(t)
            paths.append(path)
    return edges, paths


def path_at(edges: List[int], paths: List[str], t: int) -> str:
    """The innermost span open at `t`, by ``innermost``'s stretches."""
    i = bisect.bisect_right(edges, t) - 1
    return paths[i] if i >= 0 else OUTSIDE


def join(rows, span_paths) -> dict:
    """Waits and device idle time by program span path, from a session's
    rows (name, on the card, start ns, end ns). The program's spans are
    the host rows ``hr::<path>`` with a path of `span_paths`; the window
    runs from the first of the harness's ``hr::frame`` ranges to the last
    of them or of the device rows after it."""
    dev, frames, spans, syncs, runtime = [], [], [], [], 0
    for name, on_card, a, b in rows:
        if on_card:
            if not name.startswith("hr::"):  # the mirrored host ranges are not work
                dev.append((a, b))
        elif name.startswith("hr::"):
            if name == "hr::frame":
                frames.append((a, b))
            elif name[4:] in span_paths:
                spans.append((a, b, name[4:]))
        elif name.startswith("cuda"):
            runtime += 1
            if name in SYNC_CALLS:
                syncs.append((a, b))
    edges, paths = innermost(spans)

    waits: Optional[Dict[str, Dict[str, float]]] = None
    if runtime:
        waits = {}
        for a, b in syncs:
            w = waits.setdefault(path_at(edges, paths, a), {"count": 0, "ms": 0.0})
            w["count"] += 1
            w["ms"] += (b - a) / 1e6

    idle: Dict[str, float] = collections.defaultdict(float)
    if frames:
        lo = min(a for a, _ in frames)
        hi = max([b for _, b in frames] + [b for a, b in dev if a >= lo])
        _, gaps = stats.busy_and_gaps((s for s in dev if s[1] > lo), lo, hi)
        for a, b in gaps:
            i = bisect.bisect_right(edges, a) - 1  # the stretch `a` lies in; -1 before all
            x = a
            while x < b:
                y = min(b, edges[i + 1]) if i + 1 < len(edges) else b
                idle[paths[i] if i >= 0 else OUTSIDE] += (y - x) / 1e9
                x, i = y, i + 1
    return {"waits": waits, "idle_s": dict(idle)}
