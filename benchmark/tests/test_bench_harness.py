"""The harness's own arithmetic and wiring, on the CPU."""
import dataclasses
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from hrbench import cells, compare, program, roofline, stats, tracing, traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_parts_are_found_by_name(workload):
    cell = cells.load(workload)
    assert cell.config["camera_path"]
    # every cell has its tail per layer; end to end only where it is listed
    # under its bound
    e2e = {m["name"] for m in cell.end_to_end}
    per_layer = {m["name"] for m in cell.per_layer}
    assert e2e - {"frame_ms_p95"} == {"frame_ms", "setup_s"}
    assert "frame_interval_p95_ms" in per_layer
    listed = {m["name"]: m.get("workloads") for m in bench()["end_to_end"]}
    assert ("frame_ms_p95" in e2e) == (workload in (listed["frame_ms_p95"] or []))
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))
    kind = cells.frames(cell.mix["frames"])
    for part in ("time_of", "Frames", "Reference", "PASSES", "GROUPS"):
        assert hasattr(kind, part)
    assert set(cell.limits) == set(kind.GROUPS)


def test_every_metric_has_a_reader_and_every_config_its_file():
    b = bench()
    cell_names = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"] + b["end_to_end"]:
        assert set(m.get("workloads", [])) <= cell_names, m["name"]
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        cells.load("no-such-cell")
    with pytest.raises(KeyError):
        cells.frames("no-such-kind")


def _mix(kind):
    with open(os.path.join(BENCH, "traffic", f"{kind}.json")) as f:
        return json.load(f)


def _path():
    return cells.load("shadows_test-1080p.fly").config["camera_path"]


def _schedule(mix, seed):
    m = _mix(mix)
    return traffic.Schedule(m, _path(), seed, cells.frames(m["frames"]))


def test_fly_frames_repeat_for_a_seed_and_differ_between_seeds():
    a, b, c = _schedule("fly", 2**31 + 5), _schedule("fly", 2**31 + 5), _schedule("fly", 2**31 + 6)
    fa = [a.frame(i) for i in range(60)]
    assert fa == [b.frame(i) for i in range(60)]
    assert fa != [c.frame(i) for i in range(60)]
    assert not any(restart for _, _, restart in fa)
    # a fixed 1/30 s of path time a frame, looping over the 16 s path
    assert a.time_of(31)[0] == pytest.approx((a.time_of(1)[0] + 1.0) % 16.0)
    assert a.time_of(480)[0] == pytest.approx(a.time_of(0)[0])


@pytest.mark.parametrize("mix", ["fly", "pathtrace"])
def test_checked_frames_are_the_start_and_one_seeded_frame_in_each_range(mix):
    m = _mix(mix)
    ranges = m["check_frames"]["window_picks"]
    seen = set()
    for seed in range(2**31, 2**31 + 40):
        s = _schedule(mix, seed)
        assert s.checked == _schedule(mix, seed).checked
        assert s.checked[0] == 0 and len(s.checked) == 1 + len(ranges)
        for k, (lo, hi) in zip(s.checked[1:], ranges):
            assert s.warm + lo <= k < s.warm + hi
        seen.add(tuple(s.checked))
    assert len(seen) > 30


def test_the_spline_passes_through_its_keyframes():
    kf = traffic.keyframes(_path())
    for k in kf:
        eye, target = traffic.sample_path(kf, k.time)
        assert eye == pytest.approx(k.eye) and target == pytest.approx(k.target)


def test_pathtrace_holds_each_view_and_restarts_at_the_next():
    s = _schedule("pathtrace", 7)
    per, views = s.mix["samples_per_view"], s.mix["viewpoints"]
    frames = [s.frame(i) for i in range(3 * per)]
    assert [r for _, _, r in frames] == ([True] + [False] * (per - 1)) * 3
    assert frames[0][:2] == frames[per - 1][:2] != frames[per][:2]
    # the views are spaced evenly over the loop
    assert (s.time_of(per)[0] - s.time_of(0)[0]) % s.duration == pytest.approx(s.duration / views)


@dataclasses.dataclass
class _RefPlanes:
    a: torch.Tensor
    b: torch.Tensor
    n: int = 0


@dataclasses.dataclass
class _ProgPlanes:  # another class, fields in another order, one more
    extra: torch.Tensor
    b: torch.Tensor
    a: torch.Tensor
    n: int = 3


def test_planes_are_compared_and_read_by_the_reference_field_names():
    ref = _RefPlanes(a=torch.zeros(4), b=torch.ones(4))
    got = _ProgPlanes(extra=torch.full((9,), 7.0), b=torch.ones(4), a=torch.zeros(4))
    assert compare.off_share(got, ref) == 0.0
    got.a = torch.tensor([0.0, 0.0, 1.0, 0.0])
    assert compare.off_share(got, ref) == pytest.approx(1 / 8)
    # a plane the program lacks is off throughout
    assert compare.off_share(types.SimpleNamespace(b=torch.ones(4)), ref) == pytest.approx(0.5)
    mapped = compare.as_reference(ref, got)
    assert type(mapped) is _RefPlanes and mapped.n == 3
    assert torch.equal(mapped.a, got.a) and mapped.a is not got.a  # a copy
    with pytest.raises(AttributeError):
        compare.as_reference(ref, types.SimpleNamespace(a=got.a))


def test_a_snapshot_keeps_what_later_changes_in_place():
    x = _ProgPlanes(extra=torch.ones(2), b=torch.ones(3), a=torch.zeros(3))
    snap = program.snapshot(x)
    x.a.add_(1.0)
    x.extra.zero_()
    assert torch.equal(snap.a, torch.zeros(3)) and torch.equal(snap.extra, torch.ones(2))
    assert type(snap) is _ProgPlanes and snap.n == 3


def test_percentile_and_intervals():
    gaps = stats.intervals([0.0, 10.0, 20.0, 30.0, 70.0])
    assert gaps == [10.0, 10.0, 10.0, 40.0]
    assert stats.percentile(list(range(1, 102)), 95) == pytest.approx(96.0)
    assert stats.percentile([10.0, 10.0, 10.0, 40.0], 95) == pytest.approx(35.5)
    with pytest.raises(ValueError):
        stats.percentile([1.0], 95)


def test_union_busy_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert stats.union(spans) == [(0, 3), (5, 6), (9, 12)]
    busy, gaps = stats.busy_and_gaps(spans, 1, 10)
    assert busy == pytest.approx(2 + 1 + 1)
    assert gaps == [(3, 5), (6, 9)]
    busy, gaps = stats.busy_and_gaps([], 0, 4)
    assert busy == 0 and gaps == [(0, 4)]


def test_roofline_counts_on_small_shapes():
    hbm, fp = roofline.HBM_BYTES_PER_S, roofline.FP32_OPS_PER_S
    assert roofline.trace_bound("closest", 10, 3) == pytest.approx((10 * 144 + 3 * 36) / hbm)
    assert roofline.trace_bound("visibility", 10, 3) == pytest.approx((10 * 36 + 3 * 36) / hbm)
    # 4 iterations on 6 of 8 pixels, C = 3: bound by the operations
    ops = 4 * 6 * (9 * 37 + 20)
    assert roofline.atrous_bound(3, 8, 6, 4, 1) == pytest.approx(
        max((8 * 33 + 8 * 28) / hbm, ops / fp))
    assert roofline.blur_bound(8, 2, 4) == pytest.approx(max(8 * 25 / hbm, 10 * 164 / fp))
    assert roofline.sampler_bound(5, 100) == pytest.approx(max((5 * 48 + 400) / hbm,
                                                               5 * 1560 / fp))


class _Event:
    def __init__(self, name, dev, a_ns, b_ns):
        self._n, self._d, self._a, self._b = name, dev, a_ns, b_ns

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a


def _fake_prof(events):
    kineto = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=kineto))


def test_record_of_made_up_events():
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ms = 1_000_000
    events = [
        _Event("hr::frame", cpu, 0, 10 * ms), _Event("hr::frame", cpu, 10 * ms, 20 * ms),
        _Event("hr::reflections_pass", cpu, 2 * ms, 8 * ms),
        _Event("aten::add", cpu, 2 * ms, 3 * ms),
        _Event("void (anonymous namespace)::closest_kernel(float4 const*)", gpu, 1 * ms, 2 * ms),
        _Event("k6_closest_kernel", gpu, 12 * ms, 13 * ms),
        _Event("void atrous_tile_kernel<1>(AtrousLaunch)", gpu, 3 * ms, 4 * ms),
        _Event("Memcpy HtoD (Pageable -> Device)", gpu, 4 * ms, 5 * ms),
        _Event("elementwise_kernel", gpu, 14 * ms, 21 * ms),
    ]
    hooks = types.SimpleNamespace(waits=6, rays=[("closest", 100), ("visibility", 50)],
                                  host_s={"reflections_pass": 0.012},
                                  bounds=lambda T: {"trace": 1e-4, "filter": 2e-4})
    rec = tracing.record(_fake_prof(events), hooks, 2, 10)
    assert rec["window_s"] == pytest.approx(0.021)
    assert rec["busy_s"] == pytest.approx(0.011)
    assert rec["kernels"] == 4  # the memcpy is an operation, not a kernel
    assert rec["kernel_s"]["trace"] == pytest.approx(0.001)  # K6 is not K1
    assert rec["kernel_s"]["filter"] == pytest.approx(0.001)
    idle = dict(rec["breakdown"]["idle_gaps"])
    assert idle["reflections_pass"] == pytest.approx(0.004)  # 2-3 ms and 5-8 ms
    assert idle["frame loop"] == pytest.approx(0.001 + 0.004 + 0.001)  # 0-1, 8-12, 13-14
    names = [n for n, _ in rec["breakdown"]["device_ops"]]
    assert names[0] == "elementwise_kernel"


def _record(**kw):
    rec = {"frames": 4, "window_s": 0.2, "busy_s": 0.05, "kernels": 400, "waits": 8,
           "rays": 4000, "host_s": {"reflections_pass": 0.04, "ddgi_update": 0.02,
                                    "sample_probe_grid_screen": 0.004},
           "kernel_s": {"trace": 0.002, "filter": 0.004},
           "bound_s": {"trace": 0.0005, "filter": 0.001},
           "frame_intervals_ms": [float(x) for x in range(1, 102)]}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("name, value", [
    ("launches_per_frame", 100.0), ("host_waits_per_frame", 2.0), ("device_idle_pct", 75.0),
    ("pass_ms.reflections", 10.0), ("pass_ms.ddgi", 6.0), ("rays_per_frame", 1000.0),
    ("trace_kernel_ms", 0.5), ("trace_roofline", 25.0), ("filter_roofline", 25.0),
    ("frame_interval_p95_ms", 96.0)])
def test_metric_readers(name, value):
    assert cells.reader(name)(_record()) == pytest.approx(value)


@pytest.mark.parametrize("name", ["pass_ms.reflections", "pass_ms.ddgi", "trace_kernel_ms",
                                  "trace_roofline", "filter_roofline", "rays_per_frame",
                                  "frame_interval_p95_ms"])
def test_metric_readers_return_nothing_where_nothing_ran(name):
    rec = _record(host_s={}, kernel_s={"trace": 0.0, "filter": 0.0},
                  bound_s={"trace": 0.0, "filter": 0.0}, rays=0, frame_intervals_ms=[1.0])
    assert cells.reader(name)(rec) is None


def test_the_command_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "shadows_test-1080p.fly", "--seed", str(2**31 + 3), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_command_fails_where_only_the_benchmark_is(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("out"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "shadows_test-1080p.fly", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
