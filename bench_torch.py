#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port, with bench.py's contract.

    python3 bench_torch.py               (on the GPU; exits non-zero without one)
    python3 bench_torch.py --device cpu  (the plain PyTorch path on the CPU)

Prints the headline JSON line the moment the north-star metric is
measured, then (budget permitting) the same line again with each detail
section added as it lands; a watchdog thread re-prints the best line and
exits 0 at BENCH_BUDGET_S (default 480) even if a section hangs.

North-star metric: the full hybrid frame (shadows + AO + reflections +
DDGI + TAA + tonemap) on shadows_test at 1920x1080 (BENCH_RES=WxH to
change it), ms/frame over 20 frames threading the render state, after one
warm-up frame, host clock ending in ``torch.cuda.synchronize()``.
vs_baseline = 33 / ms (>1 means faster than the 33 ms target).

Detail sections, in bench.py's order, each guarded by the budget:
  - fidelity: pooled relative RMSE vs the 96-spp path-traced GT on gi_test
    at 256x256 after 32 hybrid frames (gate 0.05), the GT read from
    data/golden/gt_gi_test_256_96.png
  - golden: drift of that hybrid frame from data/golden/gi_test_256.png
    (reported with an ``ok`` flag at 2%)
  - passes_ms: the nine passes timed one by one (utils/passbench.py),
    host + device, under a 120 s section cap
  - hero_ms: the same frame on sponza_scan (249,765 triangles), 5 frames

A section that fails records ``<section>_error`` and the run goes on.
Nothing is written under data/: where a golden or GT file is missing (or
BENCH_GT_REFRESH is set) the rendered image goes to chiprun_out/golden/.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import traceback

_ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PATH = os.path.join(_ROOT, "data", "golden", "gi_test_256.png")
GT_PATH = os.path.join(_ROOT, "data", "golden", "gt_gi_test_256_96.png")
OUT_DIR = os.path.join(_ROOT, "chiprun_out", "golden")

BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "480"))
HEADLINE_FRAMES = 20  # timed frames of the headline (bench.py _time_frames)
HERO_FRAMES = 5

_t0 = time.perf_counter()
_print_lock = threading.Lock()
_result: dict = {}  # headline fields + detail, shared with the watchdog


def _elapsed() -> float:
    return time.perf_counter() - _t0


def _budget_left(reserve_s: float = 30.0) -> bool:
    """True if at least reserve_s of wall budget remains."""
    return _elapsed() < (BUDGET_S - reserve_s)


def _emit(result: dict) -> None:
    with _print_lock:
        print(json.dumps(result), flush=True)


def _watchdog() -> None:
    """Hard exit at BUDGET_S: re-print the best result so far and leave
    rc=0, so that a hang inside a section cannot consume the caller's
    whole time limit."""
    deadline = BUDGET_S - _elapsed()
    if deadline > 0:
        time.sleep(deadline)
    if _result.get("value") is not None:
        _result.setdefault("detail", {})["watchdog"] = "budget exhausted"
        _emit(_result)
    os._exit(0)


def _error(e: BaseException) -> str:
    traceback.print_exc(file=sys.stderr)
    return f"{type(e).__name__}: {e}"[:200]


def _build(scene_name, W, H, *, device, taa=True, debug=False, tracer_method="auto",
           animator=None, mesh=None):
    """The renderer as bench.py _build makes it: shadows FULL, AO HALF,
    reflections HALF, DDGI at the scene preset's rays and scale, TAA on
    unless `taa` is False. `tracer_method`, `animator` and `mesh` go to
    HybridRenderer."""
    from hybrid_rendering_torch.config import (
        AOConfig, DDGIConfig, RayTraceScale, ReflectionsConfig, RendererConfig,
        ShadowsConfig, TAAConfig)
    from hybrid_rendering_torch.models.renderer import HybridRenderer
    from hybrid_rendering_torch.ops.sh import make_env_fallbacks
    from hybrid_rendering_torch.ops.sky import ProceduralSky
    from hybrid_rendering_torch.scene.presets import apply_preset

    base = RendererConfig(
        width=W, height=H, debug_outputs=debug,
        shadows=ShadowsConfig(scale=RayTraceScale.FULL),
        ao=AOConfig(scale=RayTraceScale.HALF),
        reflections=ReflectionsConfig(scale=RayTraceScale.HALF),
        ddgi=DDGIConfig(),  # rays/scale from the scene preset
        taa=TAAConfig(enabled=taa),
    )
    scene, light, camkw, cfg, _ = apply_preset(scene_name, base)
    sky = ProceduralSky.create(light.direction.numpy()).to(device)
    irr_fn, pref_fn = make_env_fallbacks(sky.radiance, device=device)
    r = HybridRenderer(scene, cfg, sky.radiance, irr_fn, pref_fn, device=device,
                       tracer_method=tracer_method, animator=animator, mesh=mesh)
    return r, light.to(device), camkw


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_frames(r, light, camkw, iters, keep_state=False):
    """One warm-up frame, then `iters` frames threading the render state,
    host clock ending in a synchronize. Returns (ms/frame, warm-up s,
    last outputs[, state, camera, light])."""
    state = r.create_state()
    cam = r.make_camera(camkw["eye"], camkw["target"], 0)
    t0 = time.perf_counter()
    outputs, state = r.render_frame(state, cam, light)
    _sync(r.device)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        outputs, state = r.render_frame(state, cam, light)
    _sync(r.device)
    ms = (time.perf_counter() - t0) / iters * 1e3
    if keep_state:
        # the live state after the run (warm temporal history) for the
        # per-pass harness
        return ms, compile_s, outputs, state, cam, light
    return ms, compile_s, outputs


def _device_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _write_out(name, img) -> str:
    """Write an image that bench.py would have written under data/golden/
    into chiprun_out/golden/ instead; returns its path."""
    from hybrid_rendering_torch.utils import image as img_utils

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    img_utils.write_png(path, img)
    return path


def _parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; no card is an error) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device; pass --device cpu to run the plain path on the CPU",
              file=sys.stderr)
        return 1
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    threading.Thread(target=_watchdog, daemon=True).start()

    res = os.environ.get("BENCH_RES", "1920x1080")
    W, H = (int(v) for v in res.split("x"))
    detail = {"resolution": f"{W}x{H}", "target_ms": 33.0,
              "device": _device_name(device), "budget_s": BUDGET_S}

    # --- north-star metric: full pipeline on shadows_test ---
    r, light, camkw = _build("shadows_test", W, H, device=device)
    ms, compile_s, _, live_state, live_cam, live_light = _time_frames(
        r, light, camkw, iters=HEADLINE_FRAMES, keep_state=True)
    detail.update(
        passes="gbuffer+shadows(F)+ao(H)+ddgi(128rpp,Q)+reflections(H)"
               "+deferred+taa+tonemap",
        probes=r.probe_grid.num_probes,
        triangles=int(r.scene.num_triangles),
        compile_s=round(compile_s, 1),
        scene="shadows_test (pillars)",
    )
    _result.update({
        "metric": "hybrid_pipeline_1080p",
        "value": round(ms, 3),
        "unit": "ms/frame",
        "vs_baseline": round(33.0 / ms, 3),
        "detail": detail,
    })
    _emit(_result)  # evidence is on the wire before any optional section

    # --- fidelity vs GT on gi_test ---
    ldr = None
    try:
        if not _budget_left(90.0):
            raise TimeoutError(f"budget ({_elapsed():.0f}s elapsed)")
        from hybrid_rendering_torch.utils import image as img_utils
        from hybrid_rendering_torch.utils.oracle import fidelity_report

        rg, lg, cg = _build("gi_test", 256, 256, device=device, taa=False, debug=True)
        cam = rg.make_camera(cg["eye"], cg["target"], 0)
        # the committed 96-spp oracle render makes this section cheap;
        # without it (or with BENCH_GT_REFRESH) the GT is rendered here
        gt_cached = None
        if os.path.exists(GT_PATH) and not os.environ.get("BENCH_GT_REFRESH"):
            gt_cached = img_utils.read_png(GT_PATH)[..., :3]
        rep = fidelity_report(rg, cam, lg, hybrid_frames=32, gt_spp=96, gt_ldr=gt_cached)
        if gt_cached is None:
            detail["gt_written"] = _write_out(os.path.basename(GT_PATH), rep["gt_ldr"])
        detail["fidelity"] = {
            "pooled_relative_rmse": round(rep["pooled_relative_rmse"], 4),
            "relative_rmse": round(rep["relative_rmse"], 4),
            "gate": 0.05,
        }
        ldr = rep["hybrid_ldr"]
        del rg
    except Exception as e:  # noqa: BLE001 — keep the JSON line alive
        detail["fidelity_error"] = _error(e)

    # --- golden-image drift check ---
    try:
        from hybrid_rendering_torch.utils import image as img_utils

        if ldr is not None:
            if os.path.exists(GOLDEN_PATH):
                golden = img_utils.read_png(GOLDEN_PATH)[..., :3]
                drift = img_utils.relative_rmse(ldr, golden)
                detail["golden"] = {"relative_rmse": round(drift, 4),
                                    "ok": bool(drift <= 0.02)}
                if drift > 0.02:
                    print(f"GOLDEN DRIFT {drift:.4f} > 0.02 vs {GOLDEN_PATH}", file=sys.stderr)
            else:
                detail["golden"] = {"created": _write_out(os.path.basename(GOLDEN_PATH), ldr)}
    except Exception as e:  # noqa: BLE001
        detail["golden_error"] = _error(e)
    _emit(_result)  # checkpoint: fidelity + golden on the wire

    # --- per-pass breakdown on the live renderer, 120 s section cap ---
    try:
        from hybrid_rendering_torch.utils.passbench import time_passes

        section_t0 = _elapsed()
        detail["passes_ms"] = time_passes(
            r, live_state, live_cam, live_light, iters=10,
            budget_left=lambda: (_budget_left(90.0) and _elapsed() - section_t0 < 120.0))
        _emit(_result)  # checkpoint
    except Exception as e:  # noqa: BLE001
        detail["passes_ms_error"] = _error(e)
    del r, live_state
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # --- hero scene at reference scale: sponza_scan, ~250k unique
    # scan-like triangles ---
    try:
        if not _budget_left(60.0):
            raise TimeoutError(f"budget ({_elapsed():.0f}s elapsed)")
        rh, lh, ch = _build("sponza_scan", W, H, device=device)
        hero_ms, _, _ = _time_frames(rh, lh, ch, iters=HERO_FRAMES)
        detail["hero_ms"] = round(hero_ms, 2)
        detail["hero_triangles"] = int(rh.scene.num_triangles)
        detail["hero_scene"] = "sponza_scan (unique scan-like topology)"
        del rh
    except Exception as e:  # noqa: BLE001 — keep the JSON line alive
        detail["hero_error"] = _error(e)

    detail["bench_wall_s"] = round(_elapsed(), 1)
    _emit(_result)  # final line: same headline + the full detail
    return 0


if __name__ == "__main__":
    sys.exit(main())
