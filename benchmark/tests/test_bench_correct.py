"""``correct`` at a size a CPU test can hold: a sound run is correct, and
the control and each fault a cell can have make it false.

The runs go through the unchanged harness (``runner.run``) with the look
for a card skipped, on a root of their own that holds a small copy of
each cell of ``BENCHMARK.json``: what the copy changes in the cell's
configuration and mix is data, ``benchmark/small/<cell>.json``
(``{"config": {...}, "mix": {...}}``: a small image, few probes, few warm
frames, early checked frames), its limits are as committed. Every cell
with a small file is run; a cell without one fails
``test_every_cell_has_a_small_copy`` alone. What a fault or a check does
is chosen by the cell's frame kind (``benchmark/frames/<kind>.py``), not
by its name. The faults are planted in the program underneath:
  - a step that returns its state unchanged;
  - half of a batch left out, the mean taken over the rest: every
    visibility request answers its second half with the first half's mean;
  - an answer altered where it is produced: the tone map's frame scaled
    by 1 + 2^-8.
The exchange between chips is not a fault these one-card cells can have.
The card test runs the first cell on the card at its own size."""
import dataclasses
import json
import os
import shutil

import pytest
import torch

from hrbench import cells, program, runner

SMALL_DIR = os.path.join(cells.BENCH_DIR, "small")
SEED = 2**31 + 11


def _bench() -> dict:
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


WORKLOADS = [w["name"] for w in _bench()["workloads"]]
SMALL = [w for w in WORKLOADS if os.path.exists(os.path.join(SMALL_DIR, f"{w}.json"))]


def kind_of(workload: str) -> str:
    """The frame kind a cell's mix names."""
    return cells.load(workload).mix["frames"]


def small_copy(workload: str) -> dict:
    """What a cell's small copy changes: ``{"config": {...}, "mix": {...}}``."""
    with open(os.path.join(SMALL_DIR, f"{workload}.json")) as f:
        return json.load(f)


def _over(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = dict(base.get(k, {}), **v) if isinstance(v, dict) and k != "check_frames" else v
    return out


def test_every_cell_has_a_small_copy():
    missing = sorted(set(WORKLOADS) - set(SMALL))
    assert not missing, f"no benchmark/small/<cell>.json for {missing}"


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout's data at a small size: a ``BENCHMARK.json`` whose cells
    each read a configuration and a mix of their own (cells that share a
    configuration or a mix may shrink it differently), those files, and
    the cells' limits as committed."""
    root = tmp_path_factory.mktemp("small")
    data = root / cells.BENCH_NAME
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir(parents=True)
    bench = _bench()
    configs = {c["name"]: c for c in bench["configs"]}
    small_configs, small_workloads = [], []
    for w in bench["workloads"]:
        if w["name"] not in SMALL:
            continue
        cell = cells.load(w["name"])
        over = small_copy(w["name"])
        path = f"{cells.BENCH_NAME}/configs/{w['name']}.json"
        (root / path).write_text(json.dumps(_over(cell.config, over.get("config", {}))))
        (data / "traffic" / f"{w['name']}.json").write_text(
            json.dumps(_over(cell.mix, over.get("mix", {}))))
        shutil.copy(os.path.join(cells.BENCH_DIR, "limits", f"{w['name']}.json"),
                    data / "limits")
        small_configs.append(dict(configs[w["config"]], name=w["name"], file=path))
        small_workloads.append(dict(w, config=w["name"], traffic=w["name"]))
    bench.update(configs=small_configs, workloads=small_workloads)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_run(root, workload, control=False, seconds=0.5):
    return runner.run(workload, SEED, seconds, False, device="cpu", root=root, control=control)


@pytest.mark.parametrize("workload", SMALL)
def test_a_sound_run_is_correct_and_its_line_has_the_keys(small_root, workload):
    res = small_run(small_root, workload)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in cells.load(workload).end_to_end} or \
        res["attempted"] < 2  # a tail needs two intervals
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    # the start and every seeded pick were checked
    n_picks = len(cells.load(workload, small_root).mix["check_frames"]["window_picks"])
    assert len(res["checked_frames"]) == 1 + n_picks and res["checked_frames"][0] == 0


def _static_buffers(monkeypatch):
    """The render state kept in the same tensors from frame to frame and
    updated in place, as a frame captured in a CUDA graph keeps it."""
    from hybrid_rendering_torch.models.renderer import HybridRenderer

    orig = HybridRenderer.render_frame
    buffers = {}

    def into(x, path):
        for f in dataclasses.fields(x):
            v, key = getattr(x, f.name), f"{path}.{f.name}"
            if isinstance(v, torch.Tensor):
                if key in buffers:
                    buffers[key].copy_(v)
                else:
                    buffers[key] = v.clone()
                object.__setattr__(x, f.name, buffers[key])
            elif dataclasses.is_dataclass(v):
                into(v, key)

    def static(self, state, camera, light):
        outputs, state = orig(self, state, camera, light)
        into(state, "")
        return outputs, state

    monkeypatch.setattr(HybridRenderer, "render_frame", static)


HYBRID = [w for w in SMALL if kind_of(w) == "hybrid"]


@pytest.mark.parametrize("workload", HYBRID)
def test_a_state_updated_in_place_is_still_correct(small_root, monkeypatch, workload):
    _static_buffers(monkeypatch)
    res = small_run(small_root, workload)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("workload", SMALL)
def test_the_control_is_not_correct(small_root, workload):
    res = small_run(small_root, workload, control=True)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _state_unchanged(monkeypatch, workload):
    if kind_of(workload) == "hybrid":
        from hybrid_rendering_torch.models.renderer import HybridRenderer

        orig = HybridRenderer.render_frame

        def frozen(self, state, camera, light):
            keep = dataclasses.replace(state)
            outputs, state = orig(self, state, camera, light)
            for f in dataclasses.fields(keep):
                setattr(state, f.name, getattr(keep, f.name))
            return outputs, state

        monkeypatch.setattr(HybridRenderer, "render_frame", frozen)
    else:
        from hybrid_rendering_torch.models import path_tracer

        monkeypatch.setattr(path_tracer, "accumulate", lambda state, sample: state)


class _HalfBatch:
    """A visibility tracer that traces the first half of each request and
    answers the rest with its mean."""

    def __init__(self, fn):
        self.fn = fn

    def _half(self, vis):
        flat = vis.reshape(-1)
        h = flat.numel() // 2
        out = flat.clone()
        out[h:] = flat[:h].mean() if h else flat.mean()
        return out.reshape(vis.shape)

    def __call__(self, o, d, tm):
        return self._half(self.fn(o, d, tm))

    def many(self, reqs):
        return [self._half(v) for v in self.fn.many(reqs)]


def _half_batch(monkeypatch, workload):
    orig = program.build

    def build(*a, **kw):
        prog = orig(*a, **kw)
        prog.renderer.visibility_fn = _HalfBatch(prog.renderer.visibility_fn)
        return prog

    monkeypatch.setattr(program, "build", build)


def _answer_altered(monkeypatch, workload):
    from hybrid_rendering_torch.models import tonemap

    orig = tonemap.tonemap
    monkeypatch.setattr(tonemap, "tonemap", lambda x, cfg=None: orig(x, cfg) * (1.0 + 2.0**-8)
                        if cfg is not None else orig(x) * (1.0 + 2.0**-8))


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", SMALL)
def test_a_broken_timed_path_is_not_correct(small_root, monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch, workload)
    res = small_run(small_root, workload)
    assert res["correct"] is False, res["checks"]


@pytest.mark.card
def test_the_first_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = runner.run(WORKLOADS[0], SEED, 3.0, False, device="cuda")
    assert res["correct"] is True, res["checks"]
    res = runner.run(WORKLOADS[0], SEED + 1, 3.0, False, device="cuda", control=True)
    assert res["correct"] is False, res["checks"]
