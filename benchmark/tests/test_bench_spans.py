"""The readers of the program's own spans (``hrbench/spans.py`` and the
``span_*`` and ``wait_ms_per_frame`` metrics): waits and idle time put
down to the innermost program span on made-up session rows, each reader
on a made-up record and nothing without the program's record, every
program counter carried into the record, and a traced run of each small
cell on the CPU through the unchanged harness."""
import pytest
import torch

from hrbench import cells, runner, spans
from test_bench_correct import SEED, SMALL, few_threads, kind_of, small_root  # noqa: F401
from test_bench_harness import _Event, _fake_prof

MS = 1_000_000  # ns


def _rows():
    """Two frames of made-up rows: (name, on the card, start ns, end ns)."""
    rows = []
    for f in (0, 20):
        at = f * MS
        rows += [
            ("hr::frame", False, at, at + 12 * MS),
            ("hr::camera", False, at, at + 1 * MS),
            ("hr::render_frame", False, at + 1 * MS, at + 12 * MS),
            ("hr::reflections_pass", False, at + 2 * MS, at + 9 * MS),  # the harness's own
            ("hr::render_frame/reflections", False, at + 2 * MS, at + 9 * MS),
            ("hr::render_frame/reflections/ray_trace", False, at + 3 * MS, at + 6 * MS),
            ("hr::render_frame/reflections", True, at + 2 * MS, at + 9 * MS),  # mirrored
            ("kernel_a", True, at + 4 * MS, at + 5 * MS),
            ("kernel_b", True, at + 7 * MS, at + 8 * MS),
            ("kernel_c", True, at + 10 * MS, at + 13 * MS),
            ("cudaLaunchKernel", False, at + 4 * MS, at + 4 * MS + 10_000),
            ("cudaStreamSynchronize", False, at + 5 * MS, at + 5 * MS + 500_000),
            ("cudaMemcpy", False, at + 0 * MS, at + 250_000),
            ("cudaEventSynchronize", False, at + 14 * MS, at + 19 * MS),  # between frames
        ]
    return rows


PATHS = {"camera", "render_frame", "render_frame/reflections", "render_frame/reflections/ray_trace"}


def test_waits_and_idle_by_innermost_program_span():
    got = spans.join(_rows(), PATHS)
    # a frame: camera 0-1 idle; render_frame 1-2 and 9-10 idle, 10-12 busy;
    # reflections 2-3, 6-7 and 8-9 idle; ray_trace 3-4 and 5-6 idle; the
    # window ends with the second frame's last kernel at 33 ms
    idle = {k: round(v * 1e3, 6) for k, v in got["idle_s"].items()}
    assert idle == {"camera": 2.0, "render_frame": 4.0, "render_frame/reflections": 6.0,
                    "render_frame/reflections/ray_trace": 4.0, spans.OUTSIDE: 7.0}
    assert got["waits"] == {
        "camera": {"count": 2, "ms": pytest.approx(0.5)},
        "render_frame/reflections/ray_trace": {"count": 2, "ms": pytest.approx(1.0)},
        spans.OUTSIDE: {"count": 2, "ms": pytest.approx(10.0)}}


def test_no_runtime_rows_no_waits():
    rows = [r for r in _rows() if not r[0].startswith("cuda")]
    assert spans.join(rows, PATHS)["waits"] is None


def test_innermost_stretches():
    edges, paths = spans.innermost([(0, 10, "a"), (2, 4, "a/b"), (4, 6, "a/c"), (6, 6, "a/d"),
                                    (12, 14, "e")])
    assert list(zip(edges, paths)) == [(0, "a"), (2, "a/b"), (4, "a/c"), (6, "a"),
                                       (10, spans.OUTSIDE), (12, "e"), (14, spans.OUTSIDE)]
    assert spans.path_at(edges, paths, 5) == "a/c"
    assert spans.path_at(edges, paths, -1) == spans.OUTSIDE


def _record(program="default"):
    rec = {"frames": 4}
    if program == "default":
        program = {
            "spans": {"render_frame": {"calls": 4, "host_s": 0.2, "self_s": 0.01},
                      "render_frame/reflections": {"calls": 4, "host_s": 0.08, "self_s": 0.0},
                      "render_frame/ddgi.update": {"calls": 4, "host_s": 0.04, "self_s": 0.0},
                      "render_frame/ddgi.sample": {"calls": 4, "host_s": 0.008, "self_s": 0.0}},
            "counters": {"rays": {"render_frame/gbuffer/closest": 4000,
                                  "render_frame/ao/visibility": 400}},
            "waits": {"render_frame": {"count": 8, "ms": 6.0}, "": {"count": 4, "ms": 100.0}},
            "idle_s": {"render_frame": 0.1}}
    if program is not None:
        rec["program"] = program
    return rec


@pytest.mark.parametrize("name, value", [
    ("span_ms.reflections", 20.0), ("span_ms.ddgi", 12.0), ("span_rays_per_frame", 1100.0),
    ("wait_ms_per_frame", 1.5)])
def test_span_readers(name, value):
    assert cells.reader(name)(_record()) == pytest.approx(value)


@pytest.mark.parametrize("name", ["span_ms.reflections", "span_ms.ddgi", "span_rays_per_frame",
                                  "wait_ms_per_frame"])
def test_span_readers_return_nothing_without_the_program(name):
    assert cells.reader(name)(_record(program=None)) is None  # no session to read here
    assert cells.reader(name)({"frames": 4, "program": None}) is None
    no_waits = _record()
    no_waits["program"].update(waits=None, spans={}, counters={})
    assert cells.reader(name)(no_waits) is None


def test_every_program_counter_reaches_the_record():
    """``shaded`` (points K7 shaded, counted on the card only) and
    ``sky_fn_points`` arrive in the record's ``counters`` by name and span
    path, beside ``rays``, which the span readers read there."""
    from hybrid_rendering_torch.utils import profiler

    profiler.collect()
    profiler.enable()
    try:
        with profiler.span("trace_sample"):
            with profiler.span("pt.direct"):
                profiler.count("shaded", 12)
                profiler.count("sky_fn_points", 5)
                profiler.count("rays", 24)
    finally:
        profiler.disable()
    dev = {True: torch.autograd.DeviceType.CUDA, False: torch.autograd.DeviceType.CPU}
    got = spans._build(_fake_prof([_Event(n, dev[card], a, b) for n, card, a, b in _rows()]))
    path = "trace_sample/pt.direct"
    assert got["counters"] == {"shaded": {path: 12}, "sky_fn_points": {path: 5},
                               "rays": {path: 24}}
    assert cells.reader("span_rays_per_frame")({"frames": 4, "program": got}) == 6.0


@pytest.mark.parametrize("workload", SMALL)
def test_a_traced_run_reads_the_program_spans(small_root, workload, monkeypatch):  # noqa: F811
    """The harness's traced section as it is, on the CPU (where PyTorch has
    no sync debug mode to set): the program's rays equal the benchmark's
    own count, its pass spans hold the benchmark's pass ranges, and there
    are no runtime rows to read waits from."""
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    res = runner.run(workload, SEED, 0.5, True, device="cpu", root=small_root)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["span_rays_per_frame"] == m["rays_per_frame"]
    assert "wait_ms_per_frame" not in m
    prog = res["trace_record"]["program"]
    roots = {p for p in prog["spans"] if "/" not in p}
    hybrid = kind_of(workload) == "hybrid"
    assert roots == ({"camera", "render_frame"} if hybrid else {"trace_sample", "accumulate"})
    # the plain path calls the sky for its sky samples; K7 alone counts `shaded`
    assert sum(prog["counters"]["sky_fn_points"].values()) > 0
    if hybrid:
        assert m["pass_ms.reflections"] <= m["span_ms.reflections"]
        assert m["pass_ms.ddgi"] <= m["span_ms.ddgi"]
    assert sum(prog["idle_s"].values()) > 0
