"""One run of one cell: set-up, the measured window, the traced frames
(``--trace 1``), the check against the reference, and the result line."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from hrbench import cells, compare, program, stats, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "hybrid_rendering_tpu")
TRACED_FRAMES = 8  # frames under the profiler, after the timed window


def forbidden_modules():
    """Modules of the JAX stack or the JAX package in this process, by
    whole top-level name."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Clock:
    """A completion stamp after each frame: a CUDA event on the card; the
    host clock after the frame on the CPU (tests only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stamps: list = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        else:
            self.stamps.append(time.perf_counter())

    def wait(self, n: int):
        """Block until frame stamp n has completed."""
        if self.cuda and 0 <= n < len(self.stamps):
            self.stamps[n].synchronize()

    def intervals_ms(self):
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.stamps, self.stamps[1:])]
        return [x * 1e3 for x in stats.intervals(self.stamps)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        t0: Optional[float] = None, root: str = cells.ROOT, control=False) -> dict:
    """Runs the cell once and returns its result. `root` holds the
    ``BENCHMARK.json`` and data files the cell is read from; with
    `control` the check puts the control in the program's place."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = cells.load(workload, root)
    cfg, mix = cell.config, cell.mix
    kind = cells.frames(mix["frames"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ---- set-up: build, warm every shape the traffic uses -------------
    # its phases are timed apart (``setup_phases`` in the result): the
    # imports, the kernels' and native builder's load (with their build
    # in a checkout's first run), the scene, tree and renderer, the warm
    # frames
    phases = {"imports_s": time.perf_counter() - t0}
    phases["build_s"] = program.load_native() if cuda else 0.0
    t = time.perf_counter()
    schedule = traffic.Schedule(mix, cfg["camera_path"], seed, kind)
    prog = program.build(cfg, device)
    _sync(device)
    phases["scene_s"] = time.perf_counter() - t
    t = time.perf_counter()
    frames = kind.Frames(prog, mix)
    kept = {}
    for i in range(schedule.warm):
        eye, target, restart = schedule.frame(i)
        out = frames.step(i, eye, target, restart, i in schedule.checked)
        if out is not None:
            kept[i] = out
    _sync(device)
    phases["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0

    # ---- the window ----------------------------------------------------
    # it runs `seconds`, and on until every checked frame has run; then,
    # with `trace`, TRACED_FRAMES more frames under the profiler, so that
    # the timed frames are those of an untraced run
    clock = Clock(device)
    hooks = prof = None
    W = schedule.warm
    must_run = max([k - W + 1 for k in schedule.checked] + [0])
    timed = traced_end = None  # window frames when the timed part and the traced frames end
    clock.mark()
    t_start = time.perf_counter()
    try:
        i = W
        while True:
            n = i - W
            clock.wait(n + 1 - schedule.in_flight)  # frame n - in_flight has completed
            if n == timed:
                from hrbench import tracing

                hooks = tracing.Hooks(prog.renderer, kind.PASSES)
                hooks.install()
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.start()
            eye, target, restart = schedule.frame(i)
            keep = i in schedule.checked
            if traced_end is not None:
                with torch.profiler.record_function("hr::frame"):
                    out = hooks.counting_waits(lambda: frames.step(i, eye, target, restart, keep))
            else:
                out = frames.step(i, eye, target, restart, keep)
            clock.mark()
            if out is not None:
                kept[i] = out
            i += 1
            if traced_end is not None and n == traced_end - 1:
                _sync(device)
                prof.stop()
                hooks.remove()
                break
            if timed is None and time.perf_counter() - t_start >= seconds and n + 1 >= must_run:
                _sync(device)  # the window closes when all it sent has run
                wall_s = time.perf_counter() - t_start
                timed = n + 1
                if not trace:
                    break
                traced_end = timed + TRACED_FRAMES
    finally:
        if prof is not None and hooks is not None and hooks._saved:
            prof.stop()  # a frame raised inside the session
            hooks.remove()
    n_frames = i - W
    frame_ms = clock.intervals_ms()[:timed]
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the JAX stack is loaded in this process: {found}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    metrics = {}
    record = None
    if trace:
        from hrbench import tracing

        record = tracing.record(prof, hooks, TRACED_FRAMES, prog.renderer.scene.num_triangles)
        record["frame_intervals_ms"] = frame_ms
        for m in cell.per_layer:
            v = cells.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"frame_ms": wall_s * 1e3 / timed,
               "frame_ms_p95": stats.percentile(frame_ms, 95) if len(frame_ms) > 1 else None,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # ---- the check, once the program's state is freed ------------------
    del frames, out
    renderer_triangles = prog.renderer.scene.num_triangles
    del prog
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = kind.Reference(cfg, schedule, device)
    readings = [ref.check(schedule, k, kept[k], control=control) for k in sorted(kept)]
    print(f"reference: {len(readings)} frame(s) checked in {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    numbers = compare.worst(readings)
    limits = cell.limits
    checks = {name: (numbers.get(name, 1.0), limits[name]) for name in limits}
    failed = sum(any(rd.get(n, 1.0) > lim for n, lim in limits.items()) for rd in readings)
    correct = (failed == 0 and len(readings) == len(schedule.checked)
               and all(v <= lim for v, lim in checks.values()))

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n_frames, "failed": int(failed),
              "metrics": metrics, "device": dev}
    if record is not None:
        dev["busy_s"] = record["busy_s"]
        dev["window_s"] = record["window_s"]
        result["breakdown"] = record["breakdown"]
        result["trace_record"] = {k: v for k, v in record.items() if k != "breakdown"}
    result["setup_phases"] = phases
    result["checked_frames"] = sorted(kept)
    result["frame_intervals_ms"] = frame_ms
    result["triangles"] = renderer_triangles
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    return result


def write_summary(workload: str, seed: int, record: dict, kind: str) -> str:
    """A run's frame intervals (and the traced run's record) beside the
    checkout's benchmark, a few kB."""
    out_dir = os.path.join(cells.BENCH_DIR, "out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{workload}.{seed}.{kind}.json")
    with open(path, "w") as f:
        json.dump(record, f)
    return path
