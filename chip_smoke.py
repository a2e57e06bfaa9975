#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   (K1-K6′ checks, edge cases and
                                            times; no result line)
    python3 chip_smoke.py --dense-only     (the same for K6/K6′ alone)
    python3 chip_smoke.py --apps-only      (apps_phase alone: render_torch.py
                                            and viewer_torch.py; no result
                                            line)
    python3 chip_smoke.py --scenes-only    (textured_phase and dynamic_phase
                                            alone; no result line)
    python3 chip_smoke.py --parallel-only  (parallel_phase alone: the
                                            multi-device path on meshes that
                                            repeat the card; no result line)
    python3 chip_smoke.py --shade-only     (shade_phase alone: K7's checks,
                                            edge cases, times and the
                                            frames' waits; no result line)
    python3 chip_smoke.py --temporal-only  (temporal_phase alone: K8's
                                            checks, edge cases and times;
                                            no result line)
    python3 chip_smoke.py --profiler-effect  (K4 counted by short
                                            torch.profiler sessions before
                                            and after profiled runs; the
                                            bench frame timed in fresh
                                            processes with and without a
                                            profiled run first; no result
                                            line)

Builds the port's CUDA kernels (K1 closest hit + attributes, K2 any-hit,
K3 à-trous chain, K4 bilateral blur, K5 DDGI irradiance sampler, K6 dense
closest hit + attributes, K6′ dense any-hit) from
``hybrid_rendering_torch/csrc`` and checks each against its plain PyTorch
version on the card, at the inputs the bench frame (shadows_test at
1920x1080, DDGI and reflections on, as bench.py _build makes it) gives it
at frame 0 and after one camera move: primary, probe and reflection rays
(K1); shadow + AO, probe sun and sky, and reflection-hit shadow rays (K2);
the shadow plane (K3, C=1), the reflections' temporal plane (K3, C=3) and
the HDR frame (K3, C=3); the AO plane (K4); the probe bounce, the screen
sample and the reflections' merged DDGI evaluation (K5); and, recorded
from the frame with ``tracer_method="flash_dense"``, the same ray sites
for K6 and K6′, with K6 also held against K1. K3, K1/K2, K4, K5 and K6 are
also held against their plain versions on edge cases (images smaller than
a tile or its halo, every option of the chain; ray batches that are all
dead, all blocked or all escaping, of 1, 31, 33 and 129 rays, from inside a
leaf's box, with t_max = inf; all-false and all-true masks, planes one
pixel wide, radii 1 and 8; points outside the probe grid on every side, on
a cage face, with zero normals, without the visibility test, in a 2 x 2 x 2
grid, at NaN and inf positions; K6 in each launch plan on batches of
1 to 129 rays, all missing, masked, behind the scene, with 300 and 1
triangles, and its refusal of a negative t_min; K6′ in each launch plan on
batches of 1 to 129 rays, all unoccluded, all blocked, masked, with t_max
= inf, t_min = 0 and negative t_min, with 300 and 1 triangles, and with
the only blocker in the last tile), and the blue-noise
sampler's grid (both modes) on the card against the CPU. Then it renders
the bench frame (built by ``bench_torch._build``, timed by
``bench_torch._time_frames``) through ``HybridRenderer`` with every kernel
counting its launches, renders the frame with DDGI and reflections off and
the dense frame, holds a small moving-camera run on the card against the
plain path on the CPU; renders a textured glTF scene written here
(``textured_phase``: all four glTF maps, 1080p with K1-K5 counted, with
and without its atlas in alternating runs, K1's rows against the plain
walk, the surface fetch timed with and without the maps, 256x144 card
against CPU, the maps changing the frame); renders the hero scene (sponza_scan, 249,765
triangles) at 1920x1080: the BVH's build time and size, 1 + 4 frames with
launch counters (K1-K5 launched, K6/K6′ not), and K1-K5 held against
their plain versions on its own wavefronts and timed there; animates
shadows_test's hero (``dynamic_phase``: 1080p with K1-K5 counted, the
refit's ms a frame, no synchronizing call in the frame's posing, K1/K2
on the refitted tree against their plain versions and against brute force on 65,536 rays of the moved soup, the
motion plane of a static camera, 256x144 card against CPU, the refit of
the hero scene's tree, and the frame through ``"flash_dense"`` with K6/K6′
counted); runs the bench's fidelity section (gi_test at 256x256: 32 hybrid frames against a
96-spp path-traced GT) through both tracers; then the K6/K6′ checks; then
the multi-device path (``parallel_phase``, meshes that repeat the card):
K1/K2 and K6/K6′ sharded over 2 and 3 shards at every 1080p ray site, bit
for bit against the unsharded calls and timed beside them; the bench frame
with its tracers sharded over 2 shards bit for bit against the unsharded
frame over 1 + 3 frames (launches a frame, ms/frame and synchronizing calls
of both); the sharded GT step against the unsharded GT at 256x256; and
``entry_torch.dryrun_multichip(8)``; then
the apps (``apps_phase``): ``render_torch.py`` at 1920x1080, animated and
env-lit with --profile and a checkpoint, alone on the card; then, in
subprocesses beside the env-lit frame at 256x144 on the card against the
CPU over three DemoPlayer frames (K1-K5 counted), the same run resumed
from the checkpoint, ``render_torch.py`` at 1920x1080 lit by the Hosek sky
and in GT mode at 480x270 (each run exiting 0 with a non-constant PNG),
and ``viewer_torch.py``'s /stats and first frame; then, alone again, each
pass timed lit by the image environment and by the Hosek sky in
alternating windows, and the Hosek fit's time on the host.
Every frame is timed before the first torch.profiler session of the
process, which slows the frames after it. Then K7 (``shade_phase``, in a
process of its own, ``--shade-only``): at the
direct light of DDGI's probe hits, of the reflection hits and of each
path-traced bounce, of the bench frame and of the hero, K7a's rays and
attenuation bit for bit against its plain stage and K7b's radiance
against its plain stage (the ProceduralSky evaluated in the kernel, and
given), the whole call against the plain path and without a
synchronizing call, K7a and K7b timed beside their byte bounds with the
kernels a call puts on the card; its edge cases (point and spot lights,
hard shadows, Preetham and constant skies, masks, 1 to 4,099 points); and
the synchronizing calls of a hybrid frame and a path-traced sample by
repo line. Then K8 (``temporal_phase``, in a process of its own,
``--temporal-only``): the three denoisers' temporal_accumulation calls of
a frame of the bench scene and of the hero, each output bit for bit
against the plain stage, one launch a call, one kernel on the card and no
synchronizing call, K8 timed beside its byte bound; and its edge cases
(the frames of tests/test_torch_temporal.py at five sizes, the camera
still, at the cap's threshold and moving). Then it times the bench frame
pass by pass and under torch.profiler (K4 must put one kernel on the card
a call there). Last, ``bench_torch.py`` runs in a subprocess
with a 300 s budget,
its lines echoed; the run fails unless every section of it completes.

Prints the card's name and power limit, which code built the BVH, the registers and
shared memory of K1-K6′, the time of an empty kernel launched the same
way (the floor under every kernel time), each kernel's time (CUDA events around calls
launched one by one into an idle card; for K1-K5 also around calls queued
behind a short spin of the card, so that no wait for the host is in it)
beside its plain version's and its bound (the least time the H100 could take for the same
work: the bytes it must move at 3.35 TB/s or its fp32 operations at 67
TFLOP/s, whichever is longer), ms/frame of the three
frames, per-pass times, the device's busy share and launches per frame
(and the dense frame's device kernel time),
both fidelity reports, the hero's frame, kernel times and plain walk,
bench_torch.py's lines, one JSON line with the kernel table (the bench
frame's sites), and, last,
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and the last line is not printed. Exits non-zero at once
where no CUDA device is available.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from collections import Counter
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

import bench_torch  # the bench's renderer and frame loop

SCENE = "shadows_test"
W, H = 1920, 1080  # the bench frame (bench.py _build)
SMALL_W, SMALL_H = 256, 144
TIMED_FRAMES = 8
TIMED_FRAMES_OFF = 4  # the DDGI/reflections-off frame, timed beside it
EYE_STEP = 0.2  # one camera move: the eye slides along x

# kernel vs plain version on the card (the plain version is the same
# arithmetic as PyTorch ops; the kernels compile with -fmad=false, so they
# round op for op like it)
K1_MIN_AGREE = 0.9999
K1_TOL = 1e-5
K2_MIN_AGREE = 1.0  # any-hit does not depend on the order of the walk: every live ray
STENCIL_TOL = 1e-5  # K4: rounds like its plain version
# K3 folds its three edge-stopping weights into one approximate exp2 and is
# built with FMA contraction: each output within 1e-4 of the plain
# version's, colour relative to the plane's maximum where that exceeds 1
# (the HDR frame)
K3_TOL = 1e-4
K5_TOL = 1e-5
# K7 against its plain stages on the card: its rays and att bit for bit
# (a failure whatever the difference), its radiance within K7_TOL
K7_TOL = 1e-5
# card (kernels) vs CPU (plain) over three moving-camera frames: a ray that
# grazes an edge can hit the other triangle when positions differ by an ulp
# (1% of pixels beyond 1e-3 for the shaded planes), and TAA picks each
# pixel's motion from the neighbour of least depth, so ulp-level depth ties
# flip the pick (tests/test_torch_slice.py measures 3% beyond 1e-3 against
# the JAX package on the CPU)
SHADED_TOL = (1e-3, 0.01)
LDR_TOL = (1e-3, 0.05)
LDR_MAX = 0.1
LDR_MEAN = 1e-3
# K6 against its plain version: bit for bit (-fmad=false, the exact test
# decides every pair): every tri_id equal, and t, u, v and the attribute
# row equal bit for bit
K6_MIN_AGREE = 1.0
# K6′ against its plain version: bit for bit (-fmad=false, the exact test
# decides every pair): every live ray equal, every masked ray blocked
K6P_MIN_AGREE = 1.0
# K6 against K1 on the primary rays: the affine product loses precision
# for rays that graze or start near large walls, so a few hits flip
K6_K1_MIN_AGREE = 0.999
T_MIN = 1e-3  # the tracers' t_min
# kernels whose registers, spills and shared memory are printed from nvcc's log
PTXAS_KERNELS = ("closest_kernel", "anyhit", "atrous_tile", "blur_tile", "ddgi_sample_kernel",
                 "k6_", "k6p_", "shade_", "temporal_kernel")
# the launch plans of K6 and K6′ held to the plain version on their edge
# cases beside the wrapper's own choice: (rays a thread, parts of the split)
K6_EDGE_PLANS = ((1, 1), (2, 1), (1, 8), (2, 8))

# bounds: published H100 SXM peaks (NVIDIA's data sheet; dense fp32
# outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per unit of work, counted from the kernels' sources
# (a transcendental, division or square root counts as one operation, so
# the bound stays a lower bound)
BOX_OPS = 25  # BVH slab test: 6 sub, 6 mul, 12 min/max, 1 compare
TRI_OPS = 59  # Möller-Trumbore: 2 cross, 4 dots, edges, division, tests
# K6/K6′ a (ray, triangle) pair, by how far the pair gets
# (csrc/flashtrace.cu): every tested pair its det and the |det| test; a
# pair with |det| > 1e-9 also the reciprocal, t and t_min < t < best; a
# pair whose t passes also u, v and their three tests
DET_OPS = 6  # 3 mul + 2 add, 1 compare
T_OPS = 11  # reciprocal, 4 mul + 3 add, x inv_det, 2 compares
UV_OPS = 28  # u, v: 6 mul + 5 add, x inv_det each; u + v, 3 compares
K3_TAP_OPS = {1: 27, 3: 37}  # normal/depth/luma weights + accumulation
K3_PIXEL_OPS = 20  # variance blur, phi, final divisions
K4_TAP_OPS = 18
K5_POINT_OPS = 1560  # 8 cage corners x ~189 + cell and bias set-up

# the bench's fidelity section (bench.py:241-252)
FID_SCENE, FID_SIZE, FID_FRAMES, FID_SPP = "gi_test", 256, 32, 96
GT_GT_MAX_POOLED_RMSE = 0.01  # same RNG streams: only flipped hits differ
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_GT = os.path.join(ROOT, "data", "golden", "gt_gi_test_256_96.png")

# the bench's hero scene (bench.py:300-316), at the bench resolution
HERO_SCENE, HERO_TRIANGLES = "sponza_scan", 249_765
HERO_FRAMES = 4
# bench_torch.py in a subprocess: its budget, and the nine passes of
# passes_ms (utils/passbench.py)
BENCH_BUDGET_S = 300
# apps_phase: render_torch.py and viewer_torch.py in subprocesses, each with
# a time limit; the environment map of the env-lit runs; the frames of the
# animated 1080p run and of the env-lit card-vs-CPU run
APPS_TIMEOUT_S = 240
APPS_ENV = "arches"
APPS_FRAMES = 8
APPS_SMALL_FRAMES = 3
APPS_GT = ("480", "270", "4")  # --width, --height, --spp of the GT run
# the passes lit by APPS_ENV and by the Hosek sky: the order of the
# windows (each sky first as often as second), the frames of a window and
# the calls of a reading of one pass called alone
SKY_ORDER = (APPS_ENV, "hosek", "hosek", APPS_ENV, APPS_ENV, "hosek")
SKY_FRAMES = 3
SKY_REPS = 10
APPS_OUT = os.path.join(ROOT, "chiprun_out", "apps")
# textured_phase's camera; dynamic_phase's moving instance (shadows_test's
# hero), its centre, and the rays held against brute force on the moved soup
TEXTURED_CAMERA = dict(eye=(6.5, 4.0, 7.5), target=(0.0, 0.8, 0.0))
HERO_INSTANCE, HERO_CENTER = 13, (0.0, 1.8, 0.0)
DYNAMIC_SAMPLE = 65_536
# parallel_phase: the meshes of repeated cards its tracer sites are sharded
# over, the shards of its bench frame and GT step, the frames after the
# first of its bench-frame comparison, the size of its GT step and the
# shards of its dryrun
PARALLEL_SHARDS = (2, 3)
PARALLEL_FRAME_SHARDS = 2
PARALLEL_FRAMES = 3
PARALLEL_GT, PARALLEL_GT_SHARDS = 256, (2, 4)
PARALLEL_DRYRUN = 8
# the frames of profile_phase's per-pass run and of each of its
# torch.profiler sessions
PROFILE_FRAMES = 3
PASSES = ("gbuffer", "shadows", "ao", "ddgi_update", "ddgi_sample", "reflections",
          "deferred", "taa", "tonemap")


def lap(name, since):
    """Print the seconds spent in phase `name`, begun at `since`; returns
    the time now, where the next phase begins."""
    now = time.perf_counter()
    print(f"[phase] {name}: {now - since:.1f} s")
    return now


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps, queued=False):
    """Mean time of `fn` between two CUDA events over `reps` calls after
    one warm-up call. The host launches into an idle card, so a call that
    is shorter than its own enqueue reads the wrapper's host time, which
    varies with the host. With `queued` the card first spins ~10 ms, the
    calls queue up behind it, and the time holds no wait for the host: the
    kernels' own time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synchronizing_calls(fn):
    """Calls fn() with PyTorch's CUDA sync debug mode set to warn; returns,
    for each call in it that made the host wait for the card (a blocking
    copy, a read of a device value), "file:line" of the innermost line of
    this repo on the stack, and the warning's own line where that lies
    outside the repo."""
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return  # the mode's own notice that it is a prototype
        ours = [f for f in traceback.extract_stack()[:-1]
                if os.path.abspath(f.filename).startswith(ROOT + os.sep)]
        site = f"{os.path.relpath(ours[-1].filename, ROOT)}:{ours[-1].lineno}" if ours else "?"
        if not os.path.abspath(filename).startswith(ROOT + os.sep):
            site += f" (in {os.path.basename(filename)}:{lineno})"
        sites.append(site)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move `nbytes` and do `ops` fp32 operations."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = ops / FP32_OPS_PER_S * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops, "operations")


def bits_equal(a, b):
    """Equal bit for bit (NaN included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def share_equal(a, b):
    """Share of equal elements, counted in integers."""
    return (a == b).sum().item() / max(a.numel(), 1)


def wall_ms(fn):
    """One call of a plain version, host clock around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def without_gi(r):
    """`r` (a renderer of bench_torch._build) built anew with DDGI and
    reflections off: PR 1's slice, timed beside the bench frame."""
    from hybrid_rendering_torch.models.renderer import HybridRenderer

    cfg = r.config.replace(ddgi=dataclasses.replace(r.config.ddgi, enabled=False),
                           reflections=dataclasses.replace(r.config.reflections, enabled=False))
    return HybridRenderer(r.scene, cfg, r.sky_radiance_fn, r.env_irradiance_fn,
                          r.env_prefiltered_fn, device=r.device)


def recorder(fn):
    """`fn`, recording the arguments of every call in `.calls`."""
    def rec(*args, **kw):
        rec.calls.append((args, kw))
        return fn(*args, **kw)

    rec.calls = []
    return rec


def wavefronts(r, state, cam, light):
    """The inputs each kernel gets in this frame: primary rays (K1), the
    shadow + AO rays of the batched launch (K2), the temporally
    accumulated shadow plane + variance (K3, C=1), the shaded HDR frame
    (K3, C=3), the temporally accumulated AO plane (K4); and, recorded from
    the DDGI update, the screen sample and the reflections' ray trace: the
    probe and reflection rays (K1), the probe sun and sky rays and the
    reflection-hit shadow rays (K2), the three sampler calls (K5); and the
    reflections' temporal plane with its denoise mask (K3, C=3). `calls`
    holds the tracer calls of the K1 and K2 sites as the renderer makes
    them (the shadow + AO site: the two requests of its ``.many``; the
    probe sun and sky sites: the two halves of the DDGI update's one
    call)."""
    from hybrid_rendering_torch.models import (
        ao, ddgi, deferred, gbuffer, reflections, shadows)
    from hybrid_rendering_torch.ops import bvh
    from hybrid_rendering_torch.ops.math3d import INF_T
    from hybrid_rendering_torch.utils.camera import camera_rays

    cfg = r.config
    origins, dirs = camera_rays(cam, W, H)
    primary = bvh._linearize_req(origins, dirs, INF_T)[0]
    gb_surf = recorder(r.closest_surface_fn)
    gb = gbuffer.render_gbuffer(gb_surf, cam, W, H)
    gb_a = gbuffer.downsample_gbuffer(gb, 1)
    s_rays = shadows.make_rays(gb, light, state.frame_index, cfg.shadows)
    a_rays = ao.make_rays(gb_a, state.frame_index, cfg.ao)
    lin = [bvh._linearize_req(*req)[0] for req in (s_rays[:3], a_rays)]
    vis_rays = tuple(torch.cat([part[i] for part in lin]) for i in range(3))
    vis_s, vis_a = r.visibility_fn.many([s_rays[:3], a_rays])
    raw_s = shadows.finish_rays(vis_s, gb, s_rays[3])
    raw_a = ao.finish_rays(vis_a, gb_a)
    vis, var, _, _ = shadows.temporal_accumulation(raw_s, gb, state.prev_gbuffer,
                                                   state.shadows, cfg.shadows)
    ao_t, _ = ao.temporal_accumulation(
        raw_a, gb_a, gbuffer.downsample_gbuffer(state.prev_gbuffer, 1), state.ao, cfg.ao)
    hdr = deferred.deferred_shading(
        gb, cam, light, r.sky_radiance_fn, W, H, shadow_visibility=vis,
        env_irradiance_fn=r.env_irradiance_fn, env_prefiltered_fn=r.env_prefiltered_fn,
        cfg=cfg.deferred)

    # DDGI update, screen sample and reflections with recording tracers
    # and samplers (the renderer's own functions underneath)
    probe_surf, probe_vis = recorder(r.closest_surface_fn), recorder(r.visibility_fn)
    bounce = recorder(r.gi_sampler)
    ddgi_state = ddgi.ddgi_update(probe_surf, probe_vis, r.probe_grid, state.ddgi, light,
                                  r.sky_radiance_fn, state.frame_index, cfg.ddgi, bounce)
    screen = recorder(r.gi_sampler)
    ddgi.sample_probe_grid_screen(r.probe_grid, ddgi_state, cfg.ddgi,
                                  gbuffer.downsample_gbuffer(gb, cfg.ddgi.scale),
                                  cam.position, screen)
    refl_surf, refl_vis = recorder(r.closest_surface_fn), recorder(r.visibility_fn)
    merged = recorder(lambda p, n, wo, valid=None: r.gi_sampler(ddgi_state, p, n, wo,
                                                                valid=valid))
    gb_r = gbuffer.downsample_gbuffer(gb, cfg.reflections.scale)
    prev_r = gbuffer.downsample_gbuffer(state.prev_gbuffer, cfg.reflections.scale)
    raw_r, ray_length = reflections.ray_trace(
        refl_surf, refl_vis, gb_r, cam, light, r.sky_radiance_fn, state.frame_index,
        cfg.reflections, gi_sample_fn=merged, env_prefiltered_fn=r.env_prefiltered_fn)
    delta = torch.linalg.norm(cam.position - state.prev_cam_pos)
    refl_t, refl_var, _, _ = reflections.temporal_accumulation(
        raw_r, ray_length, gb_r, prev_r, cam, delta, state.reflections, cfg.reflections)
    rc = cfg.reflections
    denoise_mask = ((gb_r.mesh_id >= 0) & (gb_r.roughness >= rc.mirror_roughness_threshold)
                    & (gb_r.roughness <= rc.ddgi_roughness_threshold))

    def rays(call):
        return bvh._linearize_req(*call[0])[0]

    # the DDGI update traces its sun and sky rays in one call (K7's
    # layout: the shadow rays, then the sky rays): one site each half
    probe = probe_vis.calls[0][0]
    half = probe[0].shape[0] // 2
    probe_sun, probe_sky = (tuple(a[s] for a in probe)
                            for s in (slice(None, half), slice(half, None)))

    def k5_call(call, st=None):
        (a, kw) = call
        if st is None:
            st, a = a[0], a[1:]
        return dict(state=st, p=a[0], n=a[1], wo=a[2], valid=kw["valid"])

    return dict(
        # the tracer calls as the renderer makes them (images unlinearized)
        calls={"K1": {"primary": gb_surf.calls[0][0], "probe": probe_surf.calls[0][0],
                      "reflection": refl_surf.calls[0][0]},
               "K2": {"shadow + AO": [s_rays[:3], a_rays], "probe sun": probe_sun,
                      "probe sky": probe_sky, "reflection-hit shadow": refl_vis.calls[0][0]}},
        primary=primary, vis_rays=vis_rays, gb=gb, gb_a=gb_a, vis=vis, var=var,
        hdr=hdr.contiguous(), ao=ao_t,
        k1_more={"probe": rays(probe_surf.calls[0]), "reflection": rays(refl_surf.calls[0])},
        k2_more={"probe sun": rays((probe_sun, {})), "probe sky": rays((probe_sky, {})),
                 "reflection-hit shadow": rays(refl_vis.calls[0])},
        k5={"probe bounce": k5_call(bounce.calls[0]), "screen": k5_call(screen.calls[0]),
            "reflections merge": k5_call(merged.calls[0], ddgi_state)},
        refl=dict(color=refl_t, var=refl_var, gb=gb_r, mask=denoise_mask))


def walk_bound(ts, R, stats, any_hit):
    """K1/K2's bound on R rays: o, d, t_max in and t, u, v, id and the
    attribute row (K1) or the visibility (K2) out a ray; the BVH, the
    triangles (and K1's attribute table) read once; a slab test for each
    node visit and a Möller-Trumbore test for each triangle test of the
    walk on these rays."""
    nbytes = R * (28 + (4 if any_hit else 112)) + 4 * (
        ts.nodes_min.numel() + ts.nodes_max.numel() + ts.nodes_meta.numel()
        + ts.tri_pos.numel() + (0 if any_hit else ts.attrs.numel()))
    return bound(nbytes, stats["nodes"] * BOX_OPS + stats["tris"] * TRI_OPS)


def atrous_bound(args, kw):
    """K3's bound: color, variance, normal, depth and the mask in, the
    final and feedback colours and the variance out; every iteration's
    (2r+1)^2 taps on the pixels of the mask."""
    color, _, _, depth, mask = args
    C = color.shape[-1] if color.dim() == 3 else 1
    HW = depth.numel()
    taps = (2 * kw["radius"] + 1) ** 2
    ops = len(kw["steps"]) * int(mask.sum()) * (taps * K3_TAP_OPS[C] + K3_PIXEL_OPS)
    return bound(HW * (4 * C + 21) + HW * (8 * C + 4), ops)


def blur_bound(args, radius):
    """K4's bound: image, normal, depth and mask in, the image out; the
    vertical pass on every pixel, the horizontal one on the mask."""
    img, _, _, mask = args
    HW = img.numel()
    ops = (HW + int(mask.sum())) * ((2 * radius + 1) * K4_TAP_OPS + 2)
    return bound(HW * 21 + HW * 4, ops)


def sampler_bound(call):
    """K5's bound: p, n, wo in and the irradiance out a point, both atlases
    read once; the 8-corner cage of every point."""
    N = call["p"].numel() // 3
    st = call["state"]
    atlases = 4 * (st.irradiance.numel() + st.depth.numel())
    return bound(N * 48 + atlases, N * K5_POINT_OPS)


def check_k1(ts, rays, label, name):
    from hybrid_rendering_torch.ops import bvh

    o, d, tm = rays
    hit, attrs = bvh.closest_hit_attrs(ts, o, d, tm)
    stats = {}
    (ref, ref_attrs), plain_ms = wall_ms(
        lambda: bvh.closest_hit_attrs_plain(ts, o, d, tm, stats=stats))
    agree = hit.tri_id == ref.tri_id
    share = agree.float().mean().item()
    err = max((getattr(hit, f)[agree] - getattr(ref, f)[agree]).abs().max().item()
              for f in ("t", "u", "v"))
    print(f"[{label}] K1 closest+attrs, {name}: {o.shape[0]} rays, "
          f"{(ref.tri_id >= 0).sum().item()} hits, tri_id agree {share:.6f}, "
          f"max |d(t,u,v)| {err:.3g}; the walk: {stats['nodes'] / o.shape[0]:.1f} box and "
          f"{stats['tris'] / o.shape[0]:.1f} triangle tests a ray")
    check(share >= K1_MIN_AGREE, f"K1 {name}: tri_id agrees on {share} of rays")
    for f in ("t", "u", "v"):
        torch.testing.assert_close(getattr(hit, f)[agree], getattr(ref, f)[agree],
                                   rtol=K1_TOL, atol=K1_TOL, msg=f"K1 {name} {f}")
    check(torch.equal(attrs[agree], ref_attrs[agree]), f"K1 {name}: attribute rows differ")
    return err, plain_ms, walk_bound(ts, o.shape[0], stats, any_hit=False)


def check_k2(ts, rays, label, name):
    from hybrid_rendering_torch.ops import bvh

    o, d, tm = rays
    vis = bvh.visibility(ts, o, d, tm)
    stats = {}
    ref, plain_ms = wall_ms(lambda: bvh.visibility_plain(ts, o, d, tm, stats=stats))
    live = tm > 0
    share = share_equal(vis[live], ref[live])  # counted in integers: the bar is 1.0
    err = (vis[live] - ref[live]).abs().max().item() if live.any() else 0.0
    print(f"[{label}] K2 any-hit, {name}: {o.shape[0]} rays ({live.sum().item()} live), "
          f"agree {share:.6f}, unoccluded {vis[live].mean().item():.4f}; the plain walk: "
          f"{stats['nodes'] / max(live.sum().item(), 1):.1f} box and "
          f"{stats['tris'] / max(live.sum().item(), 1):.1f} triangle tests a live ray")
    check(share >= K2_MIN_AGREE, f"K2 {name}: agrees on {share} of live rays")
    return err, plain_ms, walk_bound(ts, o.shape[0], stats, any_hit=True)


def k3_errors(got, ref):
    """Max abs error of (final, feedback, variance), the two colours
    relative to max(1, the plain plane's maximum)."""
    errs = []
    for i, (g, p) in enumerate(zip(got, ref)):
        check(g.shape == p.shape, f"K3: output {i} has shape {tuple(g.shape)}")
        scale = max(1.0, p.abs().max().item()) if i < 2 and p.numel() else 1.0
        errs.append((g - p).abs().max().item() / scale if p.numel() else 0.0)
    return errs


def k2_by_batch_size(ts, vis_rays):
    """K2's queued time on prefixes of the frame's shadow rays and of its AO
    rays: K2 picks the form of its leaf test by the size of the batch
    (csrc/trace.cu SMALL_BATCH), and these sizes lie on either side of it."""
    from hybrid_rendering_torch.ops import bvh

    shadow_rays = W * H  # the batched launch: the shadow rays, then the AO rays
    for name, start, counts in (("shadow", 0, (1 << 17, 1 << 19, 1 << 20, shadow_rays)),
                                ("AO", shadow_rays, (1 << 17, vis_rays[0].shape[0] - shadow_rays))):
        for n in counts:
            o, d, tm = (x[start:start + n].contiguous() for x in vis_rays)
            ms = cuda_ms(lambda: bvh.visibility(ts, o, d, tm), 20, queued=True)
            print(f"K2 by batch size, the first {n} {name} rays: {ms:.4f} ms queued")


def check_k3(args, kw, label, name):
    from hybrid_rendering_torch.ops import stencil

    got = stencil.atrous_chain(*args, **kw)
    ref, plain_ms = wall_ms(lambda: stencil.atrous_chain_plain(*args, **kw))
    errs = k3_errors(got, ref)
    print(f"[{label}] K3 à-trous x{len(kw['steps'])}, {name}, {tuple(args[0].shape)}: "
          f"max |d| final {errs[0]:.3g}, feedback {errs[1]:.3g}, variance {errs[2]:.3g}")
    check(max(errs) <= K3_TOL, f"K3 {name}: max abs difference {errs}")
    return max(errs), plain_ms


def check_k5(r, call, label, name):
    """K5 against its plain version on points whose ray hit (the outputs
    of the others are masked by the caller)."""
    from hybrid_rendering_torch.models import ddgi
    from hybrid_rendering_torch.ops import ddgi_sample

    grid, cfg = r.probe_grid, r.config.ddgi
    args = (grid, call["state"], cfg, call["p"], call["n"], call["wo"])
    got = ddgi_sample.sample_irradiance(*args)
    ref, plain_ms = wall_ms(lambda: ddgi.sample_irradiance(*args))
    valid = call["valid"]
    err = (got[valid] - ref[valid]).abs().max().item()
    print(f"[{label}] K5 DDGI sampler, {name}: {valid.numel()} points "
          f"({valid.sum().item()} valid), max |d| {err:.3g}, "
          f"mean irradiance {ref[valid].mean().item():.4f}")
    check(bool(torch.isfinite(got[valid]).all()), f"K5 {name}: non-finite output")
    check(err <= K5_TOL, f"K5 {name}: max abs difference {err}")
    return err, plain_ms, (lambda: ddgi_sample.sample_irradiance(*args))


def time_site(kernel, site, fn, reps, plain_ms, bnd):
    """Time one call site, print it beside its plain version and bound,
    and return (ms, plain_ms, bound_ms, bound_by)."""
    ms = cuda_ms(fn, reps)
    queued = cuda_ms(fn, reps, queued=True)
    print(f"{kernel} {site}: kernel {ms:.3f} ms ({queued:.3f} ms queued behind a busy card), "
          f"plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    return (ms, plain_ms) + bnd


def check_kernels(r, wf, label, timing):
    """Each kernel against its plain version on this frame's inputs.
    Returns ({kernel: max abs error over its call sites}, {kernel: (ms,
    plain_ms, bound_ms, bound_by)} at its largest main-path call when
    timing, else {})."""
    from hybrid_rendering_torch.ops import bvh, stencil

    ts = r.trace_scene
    out = {}
    errs = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5")}

    # the first site of each kernel is its largest on the main path
    for name, rays in dict(primary=wf["primary"], **wf["k1_more"]).items():
        err, plain_ms, bnd = check_k1(ts, rays, label, name)
        errs["K1"] = max(errs["K1"], err)
        if timing:
            timed = time_site("K1", name, lambda: bvh.closest_hit_attrs(ts, *rays), 10,
                              plain_ms, bnd)
            out.setdefault("K1", timed)
    for name, rays in {"shadow + AO": wf["vis_rays"], **wf["k2_more"]}.items():
        err, plain_ms, bnd = check_k2(ts, rays, label, name)
        errs["K2"] = max(errs["K2"], err)
        if timing:
            timed = time_site("K2", name, lambda: bvh.visibility(ts, *rays), 10, plain_ms, bnd)
            out.setdefault("K2", timed)
    if timing:
        k2_by_batch_size(ts, wf["vis_rays"])

    def chain_kw(c, phi_color):
        return dict(steps=tuple(1 << i for i in range(c.atrous_iterations)),
                    radius=c.atrous_radius, phi_color=phi_color, phi_normal=c.phi_normal,
                    sigma_depth=c.sigma_depth, feedback_iteration=c.feedback_iteration)

    gb, rf = wf["gb"], wf["refl"]
    geom = (gb.normal, gb.linear_z, gb.mesh_id >= 0)
    kw = chain_kw(r.config.shadows, r.config.shadows.phi_visibility)
    rkw = chain_kw(r.config.reflections, r.config.reflections.phi_color)
    sites = {"C=1 shadows": ((wf["vis"], wf["var"]) + geom, kw, True),
             "C=3 reflections, denoise mask": (
                 (rf["color"], rf["var"], rf["gb"].normal, rf["gb"].linear_z, rf["mask"]),
                 rkw, True),
             "C=3 HDR frame": ((wf["hdr"], wf["var"]) + geom, kw, False)}
    for name, (args, k, on_main_path) in sites.items():
        err, plain_ms = check_k3(args, k, label, name)
        errs["K3"] = max(errs["K3"], err)
        if timing and on_main_path:
            timed = time_site("K3", name, lambda: stencil.atrous_chain(*args, **k), 20,
                              plain_ms, atrous_bound(args, k))
            out.setdefault("K3", timed)

    gb_a = wf["gb_a"]
    args = (wf["ao"], gb_a.normal, gb_a.linear_z, gb_a.mesh_id >= 0)
    radius = r.config.ao.blur_radius
    got = stencil.bilateral_blur(*args, radius=radius)
    ref, plain_ms = wall_ms(lambda: stencil.bilateral_blur_plain(*args, radius=radius))
    err = (got - ref).abs().max().item()
    errs["K4"] = err
    print(f"[{label}] K4 bilateral blur r={radius} on {tuple(got.shape)}: max |d| {err:.3g}")
    check(err <= STENCIL_TOL, f"K4: max abs difference {err}")
    if timing:
        out["K4"] = time_site("K4", "AO", lambda: stencil.bilateral_blur(*args, radius=radius),
                              20, plain_ms, blur_bound(args, radius))

    for name, call in wf["k5"].items():
        err, plain_ms, launch = check_k5(r, call, label, name)
        errs["K5"] = max(errs["K5"], err)
        if timing:
            out.setdefault("K5", time_site("K5", name, launch, 20, plain_ms, sampler_bound(call)))
    return errs, out


def random_planes(Hh, Ww, C, dev, seed, mask="corner"):
    """Seeded K3 inputs with structure: piecewise-flat normals and depth, a
    black band (C=3: luma below its floor), some zero normals (weight 0
    taps) and flat zero variance in a corner (phi_l at its floor)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    color = torch.rand((Hh, Ww) if C == 1 else (Hh, Ww, C), generator=g)
    color[Hh // 3:Hh // 2, :Ww // 4] = 0.0
    var = torch.rand((Hh, Ww), generator=g) * 0.1
    var[Hh // 2:, Ww // 2:] = 0.0
    n = torch.randn((Hh, Ww, 3), generator=g)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    n[:, :Ww // 2] = torch.tensor([0.0, 1.0, 0.0])
    n[:2, -2:] = 0.0
    depth = torch.rand((Hh, Ww), generator=g) * 9 + 1
    depth[:Hh // 2] = 2.0
    if mask == "corner":
        m = torch.ones((Hh, Ww), dtype=torch.bool)
        m[:4, :4] = False
        m[Hh // 2, :] = False
    else:
        m = torch.full((Hh, Ww), mask == "all", dtype=torch.bool)
    return tuple(t.to(dev).contiguous() for t in (color, var, n, depth, m))


def k3_edge_cases(dev):
    """The tiled K3 against the plain version where tiles and halos meet
    the image's edge or exceed it, and on every option of the chain."""
    from hybrid_rendering_torch.ops import stencil

    full = (1, 2, 4, 8)
    base = dict(radius=1, phi_color=10.0, phi_normal=32.0, sigma_depth=1.0,
                feedback_iteration=1)
    cases = [  # (H, W, C, steps, overrides, mask)
        (13, 9, 1, full, {}, "corner"),
        (13, 9, 3, full, {}, "corner"),
        (135, 241, 1, full, {}, "corner"),
        (135, 241, 3, full, {}, "corner"),
        (1080, 1920, 1, full, {}, "corner"),
        (1080, 1920, 3, full, {}, "corner"),
        (50, 60, 1, full, {}, "corner"),
        (50, 60, 3, full, {}, "corner"),
        (135, 244, 3, full, {"radius": 2}, "corner"),
        (135, 241, 3, (1,), {}, "corner"),
        (135, 241, 1, (1, 2, 4), {"feedback_iteration": 2}, "corner"),
        (135, 241, 3, (1, 2), {"feedback_iteration": 5}, "corner"),
        (135, 241, 1, full, {"feedback_iteration": 0}, "corner"),
        (135, 241, 1, (1, 2, 4), {"radius": 0}, "corner"),
        (135, 241, 3, (1, 1, 1, 1, 1), {"radius": 0, "feedback_iteration": 2}, "corner"),
        (135, 241, 3, (1, 2), {"radius": 2, "phi_normal": 16.0, "phi_color": 4.0,
                               "sigma_depth": 0.5}, "corner"),
        (135, 241, 1, (1, 2), {"phi_normal": 0.0}, "corner"),
        (135, 241, 1, full, {}, "none"),
        (135, 241, 3, full, {}, "all"),
    ]
    worst = 0.0
    for i, (Hh, Ww, C, steps, over, mask) in enumerate(cases):
        kw = dict(base, steps=steps, **over)
        args = random_planes(Hh, Ww, C, dev, seed=100 + i, mask=mask)
        got = stencil.atrous_chain(*args, **kw)
        ref = stencil.atrous_chain_plain(*args, **kw)
        errs = k3_errors(got, ref)
        print(f"[edge] K3 {Hh}x{Ww} C={C} steps {steps} {over or ''} mask {mask}: "
              f"max |d| {max(errs):.3g}")
        check(all(bool(torch.isfinite(g).all()) for g in got), f"K3 edge case {i}: non-finite")
        check(max(errs) <= K3_TOL, f"K3 edge case {i}: max abs difference {errs}")
        if mask == "none":
            check(torch.equal(got[0], args[0]) and torch.equal(got[2], args[1]),
                  "K3 with an all-false mask changed a pixel")
        worst = max(worst, max(errs))
    return worst


def k4_edge_cases(dev):
    """K4 against its plain version where its tiles meet the image's edge
    or exceed it: all-false and all-true masks, planes one pixel wide,
    planes smaller than a tile, radii 1 and 8; r = 0 has no Gaussian, and
    both refuse it."""
    from hybrid_rendering_torch.ops import stencil

    cases = [  # (H, W, radius, mask)
        (540, 960, 4, "none"), (540, 960, 4, "all"), (1, 960, 4, "random"),
        (540, 1, 4, "random"), (1, 1, 4, "all"), (5, 7, 4, "random"), (3, 3, 8, "all"),
        (20, 30, 8, "random"), (135, 241, 8, "random"), (135, 241, 1, "random"),
    ]
    worst = 0.0
    for i, (Hh, Ww, r, mask) in enumerate(cases):
        img, _, n, depth, m = random_planes(Hh, Ww, 1, dev, seed=300 + i,
                                            mask="all" if mask == "random" else mask)
        if mask == "random":
            g = torch.Generator(device="cpu").manual_seed(400 + i)
            m = (torch.rand((Hh, Ww), generator=g) > 0.3).to(dev)
        got = stencil.bilateral_blur(img, n, depth, m, radius=r)
        ref = stencil.bilateral_blur_plain(img, n, depth, m, radius=r)
        err = (got - ref).abs().max().item()
        print(f"[edge] K4 {Hh}x{Ww} r={r} mask {mask}: max |d| {err:.3g}")
        check(bool(torch.isfinite(got).all()), f"K4 edge case {i}: non-finite")
        check(err <= STENCIL_TOL, f"K4 edge case {i}: max abs difference {err}")
        if mask == "none":
            check(torch.equal(got, img), "K4 with an all-false mask changed a pixel")
        worst = max(worst, err)
    img, _, n, depth, m = random_planes(8, 8, 1, dev, seed=399)
    for fn in (stencil.bilateral_blur, stencil.bilateral_blur_plain):
        try:
            fn(img, n, depth, m, radius=0)
        except (ValueError, ZeroDivisionError) as e:
            print(f"[edge] K4 r=0: {fn.__name__} refuses it ({type(e).__name__})")
        else:
            raise AssertionError(f"{fn.__name__} took r = 0")
    return worst


def k1_edge_cases(ts, primary, dev):
    """K1/K2 at the tail of a launch: every ray dead, one ray, a count that
    is no multiple of 32 with dead rays mixed in."""
    from hybrid_rendering_torch.ops import bvh

    o, d, tm = (x[:100003].clone() for x in primary)
    g = torch.Generator(device="cpu").manual_seed(5)
    mixed = tm.clone()
    mixed[(torch.rand(tm.shape[0], generator=g) < 0.8).to(dev)] = 0.0
    cases = {"all dead": (o, d, torch.zeros_like(tm)), "one ray": (o[:1], d[:1], tm[:1]),
             "one dead ray": (o[:1], d[:1], torch.zeros_like(tm[:1])),
             "100003 rays": (o, d, tm), "100003 rays, 80% dead": (o, d, mixed),
             "33 rays": (o[:33], d[:33], mixed[:33])}
    for name, (o_, d_, tm_) in cases.items():
        o_, d_, tm_ = o_.contiguous(), d_.contiguous(), tm_.contiguous()
        ref, ref_attrs = bvh.closest_hit_attrs_plain(ts, o_, d_, tm_)
        hit, attrs = bvh.closest_hit_attrs(ts, o_, d_, tm_)
        same = all(torch.equal(getattr(hit, f), getattr(ref, f))
                   for f in ("t", "tri_id", "u", "v")) and torch.equal(attrs, ref_attrs)
        check(same, f"K1 edge case {name} differs")
        check(torch.equal(bvh.visibility(ts, o_, d_, tm_),
                          bvh.visibility_plain(ts, o_, d_, tm_)), f"K2 edge case {name} differs")
        print(f"[edge] K1/K2 {name}: {o_.shape[0]} rays, {(ref.tri_id >= 0).sum().item()} hits, "
              f"equal to the plain walk")


def k2_edge_cases(ts, primary, dev):
    """K2 where the lanes of a warp end their walks apart or not at all:
    every ray dead, blocked or escaping, batches of 1, 31, 33 and 129 rays,
    rays that start inside a leaf's box, and t_max = inf. Equal to the
    plain walk on every ray."""
    from hybrid_rendering_torch.ops import bvh

    o, d, tm = (x[::10].contiguous() for x in primary)  # every 10th primary ray
    hits = bvh.closest_hit_attrs(ts, o, d, tm)[0].tri_id >= 0
    check(bool(hits.any()) and bool((~hits).any()), "K2 edge cases: no mix of hits and misses")
    mixed = torch.nonzero(hits)[0, 0].item()  # from the first hit on
    leaves = ts.nodes_meta[:, 1] > 0
    centers = ((ts.nodes_min + ts.nodes_max) * 0.5)[leaves]
    g = torch.Generator(device="cpu").manual_seed(6)
    dirs = torch.randn((centers.shape[0], 3), generator=g).to(dev)
    dirs = dirs / torch.linalg.norm(dirs, dim=1, keepdim=True)
    far = torch.full((centers.shape[0],), 1e4, device=dev)
    cases = {"all dead": (o, d, torch.zeros_like(tm)),
             "all blocked": (o[hits], d[hits], tm[hits]),
             "all escaping": (o[~hits], d[~hits], tm[~hits]),
             "inside a leaf's box": (centers, dirs, far),
             "t_max = inf": (o, d, torch.full_like(tm, float("inf")))}
    for n in (1, 31, 33, 129):
        sl = slice(max(mixed - n // 2, 0), max(mixed - n // 2, 0) + n)
        cases[f"{n} rays"] = (o[sl], d[sl], tm[sl])
    for name, rays in cases.items():
        o_, d_, tm_ = (x.contiguous() for x in rays)
        vis = bvh.visibility(ts, o_, d_, tm_)
        torch.cuda.synchronize()
        ref = bvh.visibility_plain(ts, o_, d_, tm_)
        check(torch.equal(vis, ref), f"K2 edge case {name} differs")
        if name in ("all dead", "all escaping"):
            check(bool((vis == 1).all()), f"K2 edge case {name}: a ray is blocked")
        if name == "all blocked":
            check(bool((vis == 0).all()), f"K2 edge case {name}: a ray is visible")
        print(f"[edge] K2 {name}: {o_.shape[0]} rays, unoccluded {vis.mean().item():.4f}, "
              f"equal to the plain walk")


def k5_edge_cases(dev):
    """K5 against its plain version on random atlases where cells and
    texels clamp: points outside the grid on every side, on a cage face,
    zero normals, the visibility test off, the smallest grid
    ``make_probe_grid`` builds (2 x 2 x 2), and NaN/inf positions, whose
    outputs are not compared: they must not fault."""
    from hybrid_rendering_torch.config import DDGIConfig
    from hybrid_rendering_torch.models import ddgi
    from hybrid_rendering_torch.ops import ddgi_sample

    g = torch.Generator(device="cpu").manual_seed(11)

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    def unit(n):
        v = torch.randn((n, 3), generator=g)
        return v / torch.linalg.norm(v, dim=1, keepdim=True)

    def atlases(grid, cfg):
        P, S, D = grid.num_probes, cfg.irradiance_oct_size, cfg.depth_oct_size
        mean = rand(P, D, D, lo=0.2, hi=1.5 * grid.max_distance)
        return ddgi.DDGIState(
            irradiance=rand(P, S, S, 3, hi=2.0).to(dev),
            depth=torch.stack([mean, mean * mean + rand(P, D, D, hi=2.0)], -1).to(dev),
            first_frame=0, accum_frames=7)

    cfg = DDGIConfig(probe_distance=1.0, normal_bias=0.25)
    grid = ddgi.make_probe_grid([-5.0, -0.1, -5.0], [5.0, 10.0, 5.0], cfg)
    tiny_cfg = DDGIConfig(probe_distance=1.0, grid_layout="interior")
    tiny = ddgi.make_probe_grid([0.0, 0.0, 0.0], [0.9, 0.9, 0.9], tiny_cfg)
    check(tuple(tiny.counts) == (2, 2, 2), f"smallest grid has counts {tiny.counts}")

    def span(gr):
        lo = torch.as_tensor(gr.start)
        return lo, lo + (torch.as_tensor(gr.counts, dtype=torch.float32) - 1) * torch.as_tensor(gr.step)

    N = 4096
    lo, hi = span(grid)
    inside = rand(N, 3) * (hi - lo) + lo
    outside = inside.clone()  # each point beyond the grid on one side of one axis, or a corner
    which = torch.arange(N) % 7
    for axis in range(3):
        outside[which == 2 * axis, axis] = lo[axis] - rand(N, hi=3.0)[which == 2 * axis]
        outside[which == 2 * axis + 1, axis] = hi[axis] + rand(N, hi=3.0)[which == 2 * axis + 1]
    outside[which == 6] = (hi + rand(N, 3, hi=2.0))[which == 6]
    face = inside.clone()  # on a probe plane of one axis, the first and last among them
    plane = torch.randint(0, max(grid.counts), (N,), generator=g)
    for axis in range(3):
        k = torch.minimum(plane, torch.tensor(grid.counts[axis] - 1)).to(torch.float32)
        sel = torch.arange(N) % 3 == axis
        face[sel, axis] = (lo[axis] + k * float(grid.step[axis]))[sel]
    broken = inside.clone()
    broken[::5] = float("nan")
    broken[1::5, 0] = float("inf")
    broken[2::5, 2] = float("-inf")
    t_lo, t_hi = span(tiny)
    around_tiny = rand(N, 3, lo=-1.0, hi=2.0) * (t_hi - t_lo) + t_lo

    state, tiny_state = atlases(grid, cfg), atlases(tiny, tiny_cfg)
    off = dataclasses.replace(cfg, visibility_test=False)
    cases = {  # name: (grid, state, cfg, p, n, rows compared)
        "outside the grid on every side": (grid, state, cfg, outside, unit(N), None),
        "on a cage face": (grid, state, cfg, face, unit(N), None),
        "zero normals": (grid, state, cfg, inside, torch.zeros(N, 3), None),
        "visibility test off": (grid, state, off, outside, unit(N), None),
        "grid 2 x 2 x 2": (tiny, tiny_state, tiny_cfg, around_tiny, unit(N), None),
        "NaN and inf positions": (grid, state, cfg, broken, unit(N),
                                  torch.isfinite(broken).all(dim=1)),
    }
    worst = 0.0
    for name, (gr, st, c, p, n, rows) in cases.items():
        args = (gr, st, c, p.to(dev).contiguous(), n.to(dev).contiguous(),
                unit(N).to(dev).contiguous())
        got = ddgi_sample.sample_irradiance(*args)
        torch.cuda.synchronize()  # a fault of the kernel surfaces here
        ref = ddgi.sample_irradiance(*args)
        rows = torch.ones(N, dtype=torch.bool) if rows is None else rows
        rows = rows.to(dev)
        err = (got[rows] - ref[rows]).abs().max().item()
        print(f"[edge] K5 {name}: {N} points ({int(rows.sum())} compared), max |d| {err:.3g}")
        check(bool(torch.isfinite(got[rows]).all()), f"K5 edge case {name}: non-finite output")
        check(err <= K5_TOL, f"K5 edge case {name}: max abs difference {err}")
        worst = max(worst, err)
    return worst


def sampler_check(dev):
    """The blue-noise grid at 1920x1080 on the card against the CPU, both
    modes, bit for bit (integer and float32 ops of one rounding each)."""
    from hybrid_rendering_torch.ops import bluenoise

    for mode in bluenoise.MODES:
        for dim in (0, 1, 2):
            for frame in (0, 7, 2**20 + 3):
                card = bluenoise.sample2d_grid(H, W, frame, dim, device=dev, mode=mode)
                cpu = bluenoise.sample2d_grid(H, W, frame, dim, mode=mode)
                check(all(bits_equal(a.cpu(), b) for a, b in zip(card, cpu)),
                      f"sampler {mode} dim {dim} frame {frame}: card and CPU differ")
        print(f"[sampler] {mode} {W}x{H}, dims 0-2, frames 0, 7, 2**20+3: card equals CPU")


def launch_floor():
    """The time of a kernel that does no work (one thread), launched through
    the same ctypes path as K1-K6′: what the card and the wrapper take for
    any launch, beside which the smallest bounds (K2's and K5's small
    sites) have to be read."""
    from hybrid_rendering_torch.ops import kernels

    lib = kernels.lib()

    def noop():
        kernels.check(lib.hr_noop(kernels.stream_ptr()), "hr_noop")

    ms, queued = cuda_ms(noop, 200), cuda_ms(noop, 200, queued=True)
    print(f"empty kernel (one thread, no work): {ms:.4f} ms a launch one by one, "
          f"{queued:.4f} ms queued behind a busy card")
    return ms, queued


def kernel_phase(dev):
    r, light, camkw = bench_torch._build(SCENE, W, H, device=dev)
    state = r.create_state()
    cam0 = r.make_camera(camkw["eye"], camkw["target"], 0)
    wf = wavefronts(r, state, cam0, light)
    launch_floor()
    errs0, times = check_kernels(r, wf, "frame 0", timing=True)
    k1_edge_cases(r.trace_scene, wf["primary"], dev)
    k2_edge_cases(r.trace_scene, wf["primary"], dev)
    errs0["K3"] = max(errs0["K3"], k3_edge_cases(dev))
    errs0["K4"] = max(errs0["K4"], k4_edge_cases(dev))
    sampler_check(dev)
    errs0["K5"] = max(errs0["K5"], k5_edge_cases(dev))
    del wf
    _, state = r.render_frame(state, cam0, light)
    eye1 = tuple(np.asarray(camkw["eye"]) + [EYE_STEP, 0.0, 0.0])
    cam1 = r.make_camera(eye1, camkw["target"], 1, prev_view_proj=cam0.view_proj)
    errs1, _ = check_kernels(r, wavefronts(r, state, cam1, light), "camera moved",
                             timing=False)
    return merge_times(errs0, errs1, times)


def merge_times(errs0, errs1, times):
    """{kernel: (max abs err over both frames, ms, plain_ms, bound_ms,
    bound_by)}, printed."""
    timed = {}
    for k, (ms, plain_ms, bound_ms, bound_by) in times.items():
        timed[k] = (max(errs0[k], errs1[k]), ms, plain_ms, bound_ms, bound_by)
        print(f"{k}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}, {bound_ms / ms:.1%} of the kernel's time), "
              f"max abs err {timed[k][0]:.3g}")
    return timed


def dense_ops(fs, o, d, tm, any_hit):
    """fp32 operations a scan of the triangles in index order needs on
    these rays: DET_OPS for each tested pair, T_OPS more where |det| >
    1e-9, UV_OPS more where t_min < t < the running best (t_max, lowered
    by each accepted hit for closest hit). A masked ray tests nothing; an
    any-hit ray stops at its first blocker."""
    from hybrid_rendering_torch.ops import flashtrace

    feats = flashtrace.features(o, d, fs.center)
    ops = 0
    for sl, det_ok, t, _, _, ok in flashtrace.pair_tests(fs, feats, tm, T_MIN):
        t_max = tm[sl, None]
        tested = (t_max > T_MIN).expand_as(ok)
        if any_hit:
            first = torch.where(ok.any(dim=1), ok.to(torch.int32).argmax(dim=1) + 1, fs.num_tris)
            tested = tested & (torch.arange(fs.num_tris, device=o.device)[None, :] < first[:, None])
            best = t_max
        else:
            # the running best before each triangle: t_max and the hits
            # accepted at lower indices
            run = torch.where(ok, t, torch.full_like(t, float("inf"))).cummin(dim=1).values
            best = torch.minimum(torch.cat([t_max, run[:, :-1]], dim=1), t_max)
            del run
        det_ok &= tested
        ops += (DET_OPS * int(tested.sum()) + T_OPS * int(det_ok.sum())
                + UV_OPS * int((det_ok & (t > T_MIN) & (t < best)).sum()))
    return ops


def hold_hit(hit, ref, name):
    """tri_id agreement of two Hits and the largest |d(t,u,v)| where the
    ids agree, held to the K6 bars (every id equal, t, u, v bit for bit).
    Returns (share, err, agree)."""
    agree = hit.tri_id == ref.tri_id
    share = share_equal(hit.tri_id, ref.tri_id)
    err = max((getattr(hit, f)[agree] - getattr(ref, f)[agree]).abs().max().item()
              if agree.any() else 0.0 for f in ("t", "u", "v"))
    check(share >= K6_MIN_AGREE, f"{name}: tri_id agrees on {share} of rays")
    for f in ("t", "u", "v"):
        check(bits_equal(getattr(hit, f)[agree], getattr(ref, f)[agree]),
              f"{name}: {f} differs bit for bit")
    return share, err, agree


def check_k6(fs, rays, label, name, timing):
    """K6 with attribute rows, and K6 without them (the closest-hit
    tracer's launch), against their plain versions. Returns (max
    |d(t,u,v)|, plain_ms, (ms, bound_ms, bound_by) when timing, hit)."""
    from hybrid_rendering_torch.ops import flashtrace

    o, d, tm = rays
    R = o.shape[0]
    hit, attrs = flashtrace.flash_closest_hit_attrs(fs, o, d, tm)
    (ref, ref_attrs), plain_ms = wall_ms(
        lambda: flashtrace.flash_closest_hit_attrs_plain(fs, o, d, tm))
    share, err, agree = hold_hit(hit, ref, f"K6 {name}")
    check(torch.equal(attrs, ref_attrs), f"K6 {name}: attribute rows differ")
    share0, err0, _ = hold_hit(flashtrace.flash_closest_hit(fs, o, d, tm),
                               flashtrace.flash_closest_hit_plain(fs, o, d, tm),
                               f"K6 without attributes, {name}")
    print(f"[{label}] K6 dense closest+attrs, {name}: {R} rays "
          f"({(tm > T_MIN).sum().item()} live), {(ref.tri_id >= 0).sum().item()} hits, "
          f"tri_id agree {share:.6f}, max |d(t,u,v)| {err:.3g}, rows equal; without "
          f"attributes: tri_id agree {share0:.6f}, max |d(t,u,v)| {err0:.3g}")
    err = max(err, err0)
    timed = None
    if timing:
        def run():
            return flashtrace.flash_closest_hit_attrs(fs, o, d, tm)

        ms, queued = cuda_ms(run, 10), cuda_ms(run, 10, queued=True)
        bnd = bound(R * (28 + 112) + fs.num_tris * (4 * 20 + 4 * 24),
                    dense_ops(fs, o, d, tm, any_hit=False))
        rpt = flashtrace.rays_per_thread(R)
        parts = flashtrace.split_parts(R, rpt, fs.coef.shape[0] // flashtrace.TILE,
                                       flashtrace._resident_blocks(torch.cuda.current_device(), rpt))
        print(f"K6 {name}: kernel {ms:.3f} ms ({queued:.3f} ms queued), plain {plain_ms:.3f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}); {rpt} ray(s) a thread, the triangles in "
              f"{parts} part(s)")
        timed = (ms,) + bnd
    return err, plain_ms, timed, hit


def k6_edge_cases(fs, scene, primary, dev):
    """K6 against its plain version, bit for bit, in every launch plan:
    batches of 1, 31, 33 and 129 rays, all rays missing, t_max <= t_min,
    the whole ray set behind the scene looking away, t_max = inf, a
    triangle count that is no multiple of the 128-triangle tile, and one
    triangle."""
    from hybrid_rendering_torch.ops import bvh, flashtrace

    o, d, tm = (x[::10].contiguous() for x in primary)  # every 10th primary ray
    ref = flashtrace.flash_closest_hit_plain(fs, o, d, tm)
    hits = ref.tri_id >= 0
    check(bool(hits.any()) and bool((~hits).any()), "K6 edge cases: no mix of hits and misses")
    mixed = torch.nonzero(hits)[0, 0].item()
    attrs = bvh.attr_table(scene)
    top = torch.mode(ref.tri_id[hits]).values.item()  # the triangle most rays hit
    small = {300: flashtrace.make_flash_scene(scene.tri_pos[:300].contiguous(),
                                              attrs[:300].contiguous()),
             1: flashtrace.make_flash_scene(scene.tri_pos[top:top + 1].contiguous(),
                                            attrs[top:top + 1].contiguous())}
    cases = {"all missing": (fs, o[~hits], d[~hits], tm[~hits]),
             "t_max <= t_min": (fs, o, d, torch.where(hits, T_MIN, 0.0).to(tm.dtype)),
             "behind the scene, looking away": (fs, fs.center + 1e3 * d, d, tm),
             "t_max = inf": (fs, o, d, torch.full_like(tm, float("inf"))),
             "300 triangles": (small[300], o, d, tm),
             "1 triangle": (small[1], o, d, tm)}
    for n in (1, 31, 33, 129):
        sl = slice(max(mixed - n // 2, 0), max(mixed - n // 2, 0) + n)
        cases[f"{n} rays"] = (fs, o[sl], d[sl], tm[sl])
    for name, (fs_, o_, d_, tm_) in cases.items():
        o_, d_, tm_ = (x.contiguous() for x in (o_, d_, tm_))
        want, want_attrs = flashtrace.flash_closest_hit_attrs_plain(fs_, o_, d_, tm_)
        for plan in (None,) + K6_EDGE_PLANS:
            got, got_attrs = flashtrace._launch_closest(fs_, o_, d_, tm_, T_MIN, True, plan)
            same = all(bits_equal(getattr(got, f), getattr(want, f))
                       for f in ("t", "tri_id", "u", "v")) and bits_equal(got_attrs, want_attrs)
            check(same, f"K6 edge case {name}, plan {plan or 'of the wrapper'} differs")
        check(bits_equal(flashtrace.flash_closest_hit(fs_, o_, d_, tm_).t, want.t),
              f"K6 edge case {name}: the wrapper without attributes differs")
        print(f"[edge] K6 {name}: {o_.shape[0]} rays, {fs_.num_tris} triangles, "
              f"{(want.tri_id >= 0).sum().item()} hits, every plan equal to the plain "
              f"version bit for bit")
    try:  # the merge key orders t > 0 only (csrc/flashtrace.cu)
        flashtrace.flash_closest_hit(fs, o[:4], d[:4], tm[:4], t_min=-1.0)
    except ValueError as e:
        print(f"[edge] K6 t_min = -1: refused ({e})")
    else:
        check(False, "K6 took a negative t_min")


def tile_boxes(tri_pos, fs):
    """(tiles, 2, 3): the lower and upper corner of each 128-triangle tile's
    box, in the coefficient table's order (the scene's)."""
    from hybrid_rendering_torch.ops import flashtrace

    tiles = fs.coef.shape[0] // flashtrace.TILE
    v = tri_pos.reshape(-1, 9)
    v = torch.cat([v, v[-1:].expand(tiles * flashtrace.TILE - v.shape[0], 9)])
    v = v.reshape(tiles, -1, 3)
    return torch.stack([v.amin(dim=1), v.amax(dim=1)], dim=1)


def box_skip_share(boxes, o, d, tm):
    """Share of (live ray, tile) pairs whose segment (t_min, t_max) misses
    the tile's box by an unpadded slab test: what a per-tile cull as the
    TPU kernel's (_ray_box_any) would skip. Information only; K6′ culls
    nothing."""
    live = tm > T_MIN
    o, d, tm = o[live], d[live], tm[live]
    skip = 0
    for s in range(0, o.shape[0], 1 << 19):
        oc, dc, tc = o[s:s + (1 << 19), None, :], d[s:s + (1 << 19), None, :], tm[s:s + (1 << 19)]
        inv = 1.0 / torch.where(dc.abs() < 1e-12, torch.full_like(dc, 1e-12), dc)
        lo, hi = (boxes[None, :, 0] - oc) * inv, (boxes[None, :, 1] - oc) * inv
        near = torch.minimum(lo, hi).amax(dim=2)
        far = torch.maximum(lo, hi).amin(dim=2)
        enters = (near <= far) & (far > T_MIN) & (near < tc[:, None])
        skip += int((~enters).sum())
    return skip / max(o.shape[0] * boxes.shape[0], 1)


def check_k6p(fs, rays, label, name, timing, boxes=None):
    """K6′ against its plain version: bit for bit on every ray (live rays
    equal, masked rays blocked). Returns (max |d|, plain_ms, (ms, bound_ms,
    bound_by) when timing)."""
    from hybrid_rendering_torch.ops import flashtrace

    o, d, tm = rays
    R = o.shape[0]
    vis = flashtrace.flash_visibility(fs, o, d, tm)
    ref, plain_ms = wall_ms(lambda: flashtrace.flash_visibility_plain(fs, o, d, tm))
    live = tm > T_MIN
    share = share_equal(vis[live], ref[live])
    err = (vis[live] - ref[live]).abs().max().item() if live.any() else 0.0
    print(f"[{label}] K6′ dense any-hit, {name}: {R} rays ({live.sum().item()} live), "
          f"agree {share:.6f}, unoccluded {vis[live].mean().item():.4f}")
    check(share >= K6P_MIN_AGREE, f"K6′ {name}: agrees on {share} of live rays")
    check(bool((vis[~live] == 0).all()), f"K6′ {name}: a masked ray is not blocked")
    check(bits_equal(vis, ref), f"K6′ {name}: differs from the plain version bit for bit")
    timed = None
    if timing:
        def run():
            return flashtrace.flash_visibility(fs, o, d, tm)

        ms, queued = cuda_ms(run, 10), cuda_ms(run, 10, queued=True)
        bnd = bound(R * (28 + 4) + fs.num_tris * 4 * 20, dense_ops(fs, o, d, tm, any_hit=True))
        rpt = flashtrace.rays_per_thread(R)
        parts = flashtrace.split_parts(int(live.sum()), rpt, fs.coef.shape[0] // flashtrace.TILE,
                                       flashtrace._resident_blocks(torch.cuda.current_device(),
                                                                   rpt, any_hit=True))
        print(f"K6′ {name}: kernel {ms:.3f} ms ({queued:.3f} ms queued), plain {plain_ms:.3f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}); {rpt} ray(s) a thread, the triangles in "
              f"{parts} part(s) for the live rays")
        if boxes is not None:
            print(f"K6′ {name}: an unpadded segment-box test would skip "
                  f"{box_skip_share(boxes, o, d, tm):.4f} of (live ray, 128-triangle tile) pairs "
                  f"(information only: no cull is applied)")
        timed = (ms,) + bnd
    return err, plain_ms, timed


def k6p_edge_cases(fs, scene, vis_rays, dev):
    """K6′ against its plain version, bit for bit, in every launch plan:
    batches of 1, 31, 33 and 129 rays, all rays unoccluded, all blocked,
    t_max <= t_min, t_max = inf, t_min = 0, a negative t_min (with t_max
    in (t_min, 0] too), 300 triangles and 1, and rays whose only blocker
    lies in the last tile."""
    from hybrid_rendering_torch.ops import flashtrace

    o, d, tm = (x[::10].contiguous() for x in vis_rays)  # every 10th live shadow / AO ray
    live = tm > T_MIN
    o, d, tm = o[live], d[live], tm[live]
    ref = flashtrace.flash_visibility_plain(fs, o, d, tm)
    free, blocked = ref == 1.0, ref == 0.0
    check(bool(free.any()) and bool(blocked.any()), "K6′ edge cases: no mix of visible and blocked")
    mixed = torch.nonzero(blocked)[0, 0].item()
    # the triangle that blocks the most rays
    hits = sum(ok.sum(dim=0) for *_, ok in flashtrace.pair_tests(
        fs, flashtrace.features(o, d, fs.center), tm))
    top = int(hits.argmax())
    small = {300: flashtrace.make_flash_scene(scene.tri_pos[:300].contiguous()),
             1: flashtrace.make_flash_scene(scene.tri_pos[top:top + 1].contiguous())}
    # rays that start a little off each triangle of the last tile and end
    # a little past it, kept where the plain version's only blockers lie
    # in that tile
    T, last = fs.num_tris, (fs.num_tris - 1) // flashtrace.TILE * flashtrace.TILE
    tri = scene.tri_pos[last:T]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / torch.linalg.norm(n, dim=1, keepdim=True)
    lo_ = tri.mean(dim=1) + 0.01 * n
    ld_ = -n.contiguous()
    ltm = torch.full((tri.shape[0],), 0.02, device=dev)
    feats = flashtrace.features(lo_, ld_, fs.center)
    ok = next(flashtrace.pair_tests(fs, feats, ltm))[-1]
    only_last = ok[:, last:].any(dim=1) & ~ok[:, :last].any(dim=1)
    check(int(only_last.sum()) > 0, "K6′ edge cases: no ray blocked in the last tile alone")
    cases = {"all unoccluded": (fs, o[free], d[free], tm[free], T_MIN),
             "all blocked": (fs, o[blocked], d[blocked], tm[blocked], T_MIN),
             "t_max <= t_min": (fs, o, d, torch.where(free, T_MIN, 0.0).to(tm.dtype), T_MIN),
             "t_max = inf": (fs, o, d, torch.full_like(tm, float("inf")), T_MIN),
             "t_min = 0": (fs, o, d, tm, 0.0),
             "t_min = -1": (fs, o, d, tm, -1.0),
             "t_min = -1, t_max in (-1, 0]": (fs, o, d, torch.linspace(0.0, -0.999, tm.shape[0],
                                                                        device=dev), -1.0),
             "300 triangles": (small[300], o, d, tm, T_MIN),
             "1 triangle": (small[1], o, d, tm, T_MIN),
             "blocked in the last tile alone": (fs, lo_[only_last], ld_[only_last],
                                                ltm[only_last], T_MIN)}
    for k in (1, 31, 33, 129):
        sl = slice(max(mixed - k // 2, 0), max(mixed - k // 2, 0) + k)
        cases[f"{k} rays"] = (fs, o[sl], d[sl], tm[sl], T_MIN)
    for name, (fs_, o_, d_, tm_, t_min) in cases.items():
        o_, d_, tm_ = (x.contiguous() for x in (o_, d_, tm_))
        want = flashtrace.flash_visibility_plain(fs_, o_, d_, tm_, t_min)
        for plan in (None,) + K6_EDGE_PLANS:
            got = flashtrace._launch_visibility(fs_, o_, d_, tm_, t_min, plan)
            check(bits_equal(got, want), f"K6′ edge case {name}, plan {plan or 'of the wrapper'} "
                                         f"differs")
        check(bits_equal(flashtrace.flash_visibility(fs_, o_, d_, tm_, t_min), want),
              f"K6′ edge case {name}: the wrapper differs")
        print(f"[edge] K6′ {name}: {o_.shape[0]} rays, {fs_.num_tris} triangles, t_min {t_min}, "
              f"{int((want == 0).sum())} blocked, every plan equal to the plain version bit for "
              f"bit")


def check_dense(fs, ts, wf, label, timing, boxes=None):
    """K6/K6′ at every ray site of the dense frame, and K6 against K1 (on
    the BVH `ts`) on its primary rays; `boxes`: the tile boxes, for K6′'s
    box-cull share. Returns ({"K6", "K6′": max abs err}, {kernel: (ms,
    plain_ms, bound_ms, bound_by)} at the largest site when timing)."""
    from hybrid_rendering_torch.ops import bvh

    errs, out = {}, {}
    sites = dict(primary=wf["primary"], **wf["k1_more"])
    for name, rays in sites.items():
        err, plain_ms, timed, hit = check_k6(fs, rays, label, name, timing)
        errs["K6"] = max(errs.get("K6", 0.0), err)
        if timing and name == "primary":
            out["K6"] = (timed[0], plain_ms) + timed[1:]
        if name == "primary":
            k1, _ = bvh.closest_hit_attrs(ts, *rays)
            both = (k1.tri_id >= 0) & (hit.tri_id >= 0)
            hit_miss = share_equal(k1.tri_id >= 0, hit.tri_id >= 0)
            ids = share_equal(k1.tri_id[both], hit.tri_id[both])
            print(f"[{label}] K6 vs K1 on primary rays: hit/miss agree {hit_miss:.6f}, "
                  f"tri_id agree on rays both hit {ids:.6f}")
            check(hit_miss >= K6_K1_MIN_AGREE and ids >= K6_K1_MIN_AGREE,
                  f"K6 vs K1: hit/miss {hit_miss}, tri_id {ids}")
    sites = {"shadow + AO": wf["vis_rays"], **wf["k2_more"]}
    for name, rays in sites.items():
        err, plain_ms, timed = check_k6p(fs, rays, label, name, timing, boxes)
        errs["K6′"] = max(errs.get("K6′", 0.0), err)
        if timing and name == "shadow + AO":
            out["K6′"] = (timed[0], plain_ms) + timed[1:]
    return errs, out


def dense_phase(dev):
    """K6/K6′ on the wavefronts of the frame traced with
    tracer_method="flash_dense", at frame 0 and after one camera move."""
    from hybrid_rendering_torch.ops import bvh, flashtrace

    r, light, camkw = bench_torch._build(SCENE, W, H, device=dev, tracer_method="flash_dense")
    fs, ts = r.trace_scene, bvh.make_trace_scene(r.scene)
    check(isinstance(fs, flashtrace.FlashScene), "the dense renderer holds no FlashScene")
    state = r.create_state()
    cam0 = r.make_camera(camkw["eye"], camkw["target"], 0)
    wf = wavefronts(r, state, cam0, light)
    errs0, times = check_dense(fs, ts, wf, "dense frame 0", timing=True,
                               boxes=tile_boxes(r.scene.tri_pos, fs))
    k6_edge_cases(fs, r.scene, wf["primary"], dev)
    k6p_edge_cases(fs, r.scene, wf["vis_rays"], dev)
    del wf
    _, state = r.render_frame(state, cam0, light)
    eye1 = tuple(np.asarray(camkw["eye"]) + [EYE_STEP, 0.0, 0.0])
    cam1 = r.make_camera(eye1, camkw["target"], 1, prev_view_proj=cam0.view_proj)
    errs1, _ = check_dense(fs, ts, wavefronts(r, state, cam1, light), "dense, camera moved",
                           timing=False)
    return merge_times(errs0, errs1, times)


def check_ldr(ldr, label):
    check(tuple(ldr.shape) == (H, W, 3), f"{label}: ldr shape {tuple(ldr.shape)}")
    check(bool(torch.isfinite(ldr).all()), f"{label}: ldr has non-finite values")
    check(ldr.min().item() >= 0.0 and ldr.max().item() <= 1.0, f"{label}: ldr outside [0, 1]")
    check(ldr.std().item() > 0.02, f"{label}: ldr std {ldr.std().item()}")


def read_counts(counters):
    return {k: sum(fn.launches for fn in fns) for k, fns in counters.items()}


def zero_counts(counters):
    for fns in counters.values():
        for fn in fns:
            fn.launches = 0


def slice_phase(dev, counters):
    """The bench frame through HybridRenderer: 1 warm-up + 8 timed frames,
    launch counters set to 0 just before and read just after; then the
    frame with DDGI and reflections off, timed beside it."""
    r, light, camkw = bench_torch._build(SCENE, W, H, device=dev)
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    ms, _, out = bench_torch._time_frames(r, light, camkw, TIMED_FRAMES)
    launches = read_counts(counters)
    per_frame = {k: n / (TIMED_FRAMES + 1) for k, n in launches.items()}
    print(f"frame: {SCENE} {W}x{H}, DDGI ({r.config.ddgi.rays_per_probe} rays x "
          f"{r.probe_grid.num_probes} probes, scale {int(r.config.ddgi.scale)}) + reflections "
          f"(scale {int(r.config.reflections.scale)}): {ms:.2f} ms/frame over {TIMED_FRAMES} "
          f"frames, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches} ({per_frame} per frame)")
    check_ldr(out["ldr"], "full frame")
    for k in ("K1", "K2", "K3", "K4", "K5", "K7"):
        check(launches[k] > 0, f"{k} was not launched on the main path")
    # K3: the shadows' and the reflections' chain, each in the launches of
    # its plan
    from hybrid_rendering_torch.ops import stencil
    cfg = r.config
    k3_frame = sum(len(stencil._plan([1 << i for i in range(c.atrous_iterations)],
                                     c.atrous_radius)) for c in (cfg.shadows, cfg.reflections))
    check(launches["K3"] == k3_frame * (TIMED_FRAMES + 1),
          f"K3: {launches['K3']} launches, expected {k3_frame} a frame")
    for k in ("K6", "K6′"):
        check(launches[k] == 0, f"{k} was launched on the BVH path")
    # K8: one launch at each denoiser's temporal stage
    check(launches["K8"] == 3 * (TIMED_FRAMES + 1),
          f"K8: {launches['K8']} launches, expected 3 a frame")
    del out

    r = without_gi(r)
    ms_off, _, out = bench_torch._time_frames(r, light, camkw, TIMED_FRAMES_OFF)
    print(f"frame, DDGI + reflections off: {ms_off:.2f} ms/frame over {TIMED_FRAMES_OFF} frames")
    check_ldr(out["ldr"], "DDGI/reflections-off frame")
    return ms, launches


def dense_slice_phase(dev, counters):
    """The bench frame with tracer_method="flash_dense": 1 warm-up + 4
    timed frames, launch counters set to 0 just before and read just
    after; every trace goes through K6/K6′, none through K1/K2."""
    r, light, camkw = bench_torch._build(SCENE, W, H, device=dev, tracer_method="flash_dense")
    zero_counts(counters)
    ms, _, out = bench_torch._time_frames(r, light, camkw, TIMED_FRAMES_OFF)
    launches = read_counts(counters)
    per_frame = {k: n / (TIMED_FRAMES_OFF + 1) for k, n in launches.items()}
    print(f"dense frame (tracer_method=\"flash_dense\"): {ms:.2f} ms/frame over "
          f"{TIMED_FRAMES_OFF} frames, launches {launches} ({per_frame} per frame)")
    check_ldr(out["ldr"], "dense frame")
    for k in ("K6", "K6′", "K3", "K4", "K5"):
        check(launches[k] > 0, f"{k} was not launched on the dense path")
    for k in ("K1", "K2"):
        check(launches[k] == 0, f"{k} was launched on the dense path")
    return ms, launches


def fidelity_phase(dev, counters):
    """The bench's fidelity section on the card through both tracers:
    gi_test at 256x256, TAA off, debug outputs on, 32 hybrid frames
    against a 96-spp GT, launch counters set to 0 just before each report
    and read just after; the two GT images must agree."""
    from hybrid_rendering_torch.utils import image, oracle

    golden = image.read_png(GOLDEN_GT)[..., :3]
    gts = {}
    for method, traced, idle in (("flash_dense", ("K6", "K6′"), ("K1", "K2")),
                                 ("auto", ("K1", "K2"), ("K6", "K6′"))):
        r, light, camkw = bench_torch._build(FID_SCENE, FID_SIZE, FID_SIZE, device=dev, taa=False,
                                            debug=True, tracer_method=method)
        cam = r.make_camera(camkw["eye"], camkw["target"], 0)
        zero_counts(counters)
        t0 = time.perf_counter()
        rep = oracle.fidelity_report(r, cam, light, hybrid_frames=FID_FRAMES, gt_spp=FID_SPP)
        secs = time.perf_counter() - t0
        launches = read_counts(counters)
        print(f"fidelity ({method}) launches: {launches}")
        for k in traced + ("K3", "K4", "K5"):
            check(launches[k] > 0, f"fidelity {method}: {k} was not launched")
        for k in idle:
            check(launches[k] == 0, f"fidelity {method}: {k} was launched")
        gt = rep["gt_ldr"]
        check(gt.shape == (FID_SIZE, FID_SIZE, 3), f"fidelity {method}: GT shape {gt.shape}")
        check(bool(np.isfinite(gt).all()) and gt.min() >= 0.0 and gt.max() <= 1.0,
              f"fidelity {method}: GT not finite or outside [0, 1]")
        print(f"fidelity ({method}, {FID_SCENE} {FID_SIZE}x{FID_SIZE}, {FID_FRAMES} frames vs "
              f"{FID_SPP} spp, {secs:.1f} s): pooled_relative_rmse "
              f"{rep['pooled_relative_rmse']:.4f}, relative_rmse {rep['relative_rmse']:.4f}, "
              f"hybrid mean {rep['hybrid_mean']:.4f}, GT mean {rep['gt_mean']:.4f}; "
              f"GT vs the committed 8-bit golden GT (made on a TPU): relative_rmse "
              f"{image.relative_rmse(gt, golden):.4f}")
        gts[method] = gt
    d = image.rmse(oracle._pool4(gts["flash_dense"]), oracle._pool4(gts["auto"]))
    print(f"GT through K6/K6′ vs GT through K1/K2: pooled RMSE {d:.3g}")
    check(d <= GT_GT_MAX_POOLED_RMSE, f"the two GT images differ: pooled RMSE {d}")


def compare_runs(runs, label):
    """Hold the card's frames against the CPU's, plane by plane, to the
    correctness tolerances (PERF.md §2)."""
    for f, (gpu, cpu) in enumerate(zip(runs["cuda"], runs["cpu"])):
        check(sorted(gpu) == sorted(cpu), f"{label}: card and CPU give other planes")
        for key in sorted(cpu):
            d = np.abs(gpu[key].astype(np.float64) - cpu[key])
            px = d.max(axis=-1) if d.ndim == 3 else d
            atol, share = LDR_TOL if key in ("taa", "ldr") else SHADED_TOL
            outside = float((px > atol).mean())
            if key in ("ldr", "ddgi", "reflections") or f == len(runs["cpu"]) - 1:
                print(f"{label}: card vs CPU frame {f} {key}: {outside:.4%} of pixels beyond "
                      f"{atol}, max {d.max():.3g}, mean {d.mean():.3g}")
            check(outside <= share, f"{label} frame {f} {key}: {outside} of pixels beyond {atol}")
            if key in ("taa", "ldr"):
                check(d.max() <= LDR_MAX and d.mean() <= LDR_MEAN,
                      f"{label} frame {f} {key}: max {d.max()} mean {d.mean()}")


def small_phase(dev, build=None, label="bench frame"):
    """Three moving-camera frames at 256x144 on the card (kernels) and on
    the CPU (plain versions), DDGI and reflections on; every plane
    compared. `build(w, h, device)` -> (renderer, light, camera kwargs),
    with debug outputs on; the bench frame's by default."""
    if build is None:
        def build(w, h, device):
            return bench_torch._build(SCENE, w, h, device=device, debug=True)
    runs = {}
    for device in (dev, torch.device("cpu")):
        r, light, camkw = build(SMALL_W, SMALL_H, device)
        state, prev, frames = r.create_state(), None, []
        for f in range(3):
            eye = tuple(np.asarray(camkw["eye"]) + [EYE_STEP * f, 0.0, 0.0])
            cam = r.make_camera(eye, camkw["target"], f, prev_view_proj=prev)
            prev = cam.view_proj
            out, state = r.render_frame(state, cam, light)
            frames.append({k: v.cpu().numpy() for k, v in out.items()})
        runs[device.type] = frames
    compare_runs(runs, label)


# ---------------------------------------------------------------------------
# scenes: a textured glTF file and an animated shadows_test
# ---------------------------------------------------------------------------


def _png_bytes(img):
    import io

    from hybrid_rendering_torch.utils.image import write_png

    buf = io.BytesIO()
    write_png(buf, np.asarray(img, np.float32))
    return buf.getvalue()


def write_textured_glb(path):
    """A .glb of scene/primitives.py shapes that uses all four glTF map
    kinds: a 16 x 16 ground with a checkerboard base colour and a normal
    map tilted about both tangent axes; a box and a pillar with a
    metallic-roughness map whose G (roughness) and B (metallic) differ; a
    sphere with an emissive map and the checkerboard. Nodes: a root with a
    translation, children placed by TRS and by a matrix. The ground tilts
    0.08 rad about z: on a level ground a camera without roll sees equal
    depths along each image row, where TAA's velocity dilation picks its
    motion by the last ulp of depth, which the card and the CPU round
    apart (level, the LDR plane read 0.087 from the CPU's at a checker
    edge against LDR_MAX 0.1 on an H100); its normal map keeps its curvature
    off 0, so the reflections' `curvature == 0` test does not flip there.
    Returns the number of triangles written."""
    import struct as pystruct

    from hybrid_rendering_torch.scene import primitives as prim
    from hybrid_rendering_torch.scene.textures import checkerboard

    n = 128
    yy, xx = np.meshgrid(np.arange(n) / n, np.arange(n) / n, indexing="ij")
    tilt = np.stack([0.35 * np.sin(2 * np.pi * 4 * xx), 0.35 * np.cos(2 * np.pi * 3 * yy),
                     np.ones_like(xx)], -1)
    tilt /= np.linalg.norm(tilt, axis=-1, keepdims=True)
    mr = np.stack([np.zeros_like(xx), 0.15 + 0.7 * (xx > 0.5), 0.9 * (yy > 0.5)], -1)
    images = [checkerboard(256, a=(0.9, 0.85, 0.8), b=(0.15, 0.2, 0.3), cells=16),
              tilt * 0.5 + 0.5, mr,
              np.random.RandomState(0).uniform(size=(16, 16, 3))]
    blob = bytearray()
    views, accessors = [], []

    def view(data):
        blob.extend(b"\x00" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
        blob.extend(data)
        return len(views) - 1

    def accessor(arr, kind, ctype):
        accessors.append({"bufferView": view(arr.tobytes()), "componentType": ctype,
                          "count": len(arr), "type": kind})
        return len(accessors) - 1

    meshes = []
    shapes = [(prim.plane(16.0, 16.0), 0), (prim.box(2.0, 2.0, 2.0), 1),
              (prim.uv_sphere(1.2, 24, 48), 2), (prim.cylinder(radius=0.6, height=3.0), 3)]
    triangles = 0
    for mesh, material in shapes:
        triangles += mesh.num_triangles
        meshes.append({"primitives": [{
            "attributes": {"POSITION": accessor(mesh.positions.astype(np.float32), "VEC3", 5126),
                           "NORMAL": accessor(mesh.normals.astype(np.float32), "VEC3", 5126),
                           "TEXCOORD_0": accessor(mesh.uvs.astype(np.float32), "VEC2", 5126)},
            "indices": accessor(mesh.indices.astype(np.uint32).ravel(), "SCALAR", 5125),
            "material": material}]})
    pillar = np.eye(4, dtype=np.float32)
    pillar[:3, 3] = (0.0, 1.5, -4.0)
    quarter = [0.0, float(np.sin(np.pi / 8)), 0.0, float(np.cos(np.pi / 8))]  # 45 deg about y
    tilt_z = [0.0, 0.0, float(np.sin(0.04)), float(np.cos(0.04))]  # 0.08 rad about z
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"children": [1, 2, 3, 4], "translation": [0.0, 0.0, 0.0]},
                  {"mesh": 0, "rotation": tilt_z},
                  {"mesh": 1, "translation": [-3.5, 1.0, 0.5], "rotation": quarter},
                  {"mesh": 2, "translation": [3.0, 1.2, 0.0], "scale": [1.0, 1.0, 1.0]},
                  {"mesh": 3, "matrix": pillar.T.ravel().tolist()}],
        "meshes": meshes,
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}, "roughnessFactor": 0.7,
                                      "metallicFactor": 0.0},
             "normalTexture": {"index": 1}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.35, 0.25, 1.0],
                                      "metallicRoughnessTexture": {"index": 2}}},
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}, "metallicFactor": 0.0},
             "emissiveTexture": {"index": 3}, "emissiveFactor": [1.5, 1.2, 0.8]},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.6, 0.7, 0.8, 1.0],
                                      "metallicRoughnessTexture": {"index": 2}},
             "normalTexture": {"index": 1}}],
        "textures": [{"source": i} for i in range(len(images))],
        "images": [{"bufferView": view(_png_bytes(im)), "mimeType": "image/png"}
                   for im in images],
    }
    blob.extend(b"\x00" * (-len(blob) % 4))
    doc.update(bufferViews=views, accessors=accessors, buffers=[{"byteLength": len(blob)}])
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    with open(path, "wb") as f:
        f.write(pystruct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob)))
        f.write(pystruct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(pystruct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    return triangles


def textured_build(scene, debug=False):
    """build(w, h, device) -> the bench frame's renderer (bench.py _build's
    config: shadows FULL, AO HALF, reflections HALF, DDGI at its defaults,
    TAA) over `scene`, lit as shadows_test is."""
    from hybrid_rendering_torch.config import (
        AOConfig, DDGIConfig, RayTraceScale, ReflectionsConfig, RendererConfig,
        ShadowsConfig, TAAConfig)
    from hybrid_rendering_torch.models.renderer import HybridRenderer
    from hybrid_rendering_torch.ops.sh import make_env_fallbacks
    from hybrid_rendering_torch.ops.sky import ProceduralSky
    from hybrid_rendering_torch.types import Light

    def build(w, h, device):
        cfg = RendererConfig(width=w, height=h, debug_outputs=debug,
                             shadows=ShadowsConfig(scale=RayTraceScale.FULL),
                             ao=AOConfig(scale=RayTraceScale.HALF),
                             reflections=ReflectionsConfig(scale=RayTraceScale.HALF),
                             ddgi=DDGIConfig(), taa=TAAConfig(enabled=True))
        light = Light.directional((0.35, 0.9, 0.25), color=(1.0, 0.96, 0.9), intensity=3.0,
                                  radius=0.05)
        sky = ProceduralSky.create(light.direction.numpy()).to(device)
        irr, pref = make_env_fallbacks(sky.radiance, device=device)
        r = HybridRenderer(scene, cfg, sky.radiance, irr, pref, device=device)
        return r, light.to(device), TEXTURED_CAMERA

    return build


def primary_rays(cam, w, h):
    """The camera's primary rays, flat: (origins, directions, t_max)."""
    from hybrid_rendering_torch.ops.math3d import INF_T
    from hybrid_rendering_torch.utils import camera as camera_utils

    o, d = camera_utils.camera_rays(cam, w, h)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    return o, d, torch.full((o.shape[0],), INF_T, device=o.device)


def textured_phase(dev, counters):
    """A textured glTF scene through the port: write_textured_glb's file
    loaded by load_gltf_scene, rendered at 1920x1080 with the bench frame's
    passes: 1 + TIMED_FRAMES frames with the launch counters set to 0 just
    before and read just after (K1-K5 launched); the same scene with and
    without its atlas timed in alternating runs; K1's rows on the primary
    rays against the plain walk's; three moving-camera frames at 256x144
    on the card against the CPU; and one 256x144 frame with the atlas
    removed, which must give another LDR frame. Returns ms/frame."""
    import tempfile

    from hybrid_rendering_torch.ops import bvh
    from hybrid_rendering_torch.scene.fetch import surface_from_attrs
    from hybrid_rendering_torch.scene.gltf import load_gltf_scene

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "textured.glb")
        written = write_textured_glb(path)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        scene = load_gltf_scene(path)
        load_s = time.perf_counter() - t0
    check(scene.num_triangles == written, f"textured: {scene.num_triangles} of {written} triangles")
    check(scene.materials.maps == {"albedo_tex", "normal_tex", "roughness_tex", "metallic_tex",
                                   "emissive_tex"}, f"textured: maps {scene.materials.maps}")
    print(f"textured: {size} bytes of .glb, {scene.num_triangles} triangles, "
          f"{scene.atlas.num_textures} textures in a {tuple(scene.atlas.image.shape[:2])} atlas, "
          f"loaded in {load_s:.2f} s")
    build = textured_build(scene)
    r, light, camkw = build(W, H, dev)
    zero_counts(counters)
    ms, _, out = bench_torch._time_frames(r, light, camkw, TIMED_FRAMES)
    launches = read_counts(counters)
    per_frame = {k: n / (TIMED_FRAMES + 1) for k, n in launches.items()}
    print(f"textured frame: {W}x{H}, DDGI {r.probe_grid.counts} = {r.probe_grid.num_probes} "
          f"probes: {ms:.2f} ms/frame over {TIMED_FRAMES} frames, launches {launches} "
          f"({per_frame} per frame)")
    check_ldr(out["ldr"], "textured frame")
    for k in ("K1", "K2", "K3", "K4", "K5"):
        check(launches[k] > 0, f"{k} was not launched on the textured frame")
    del out
    # what the maps cost: the same scene without its atlas, in alternating runs
    r_plain = textured_build(dataclasses.replace(scene, atlas=None))(W, H, dev)[0]
    readings = {"maps": [], "no maps": []}
    for name, rr in (("no maps", r_plain), ("maps", r), ("no maps", r_plain), ("maps", r)):
        readings[name].append(bench_torch._time_frames(rr, light, camkw, TIMED_FRAMES_OFF)[0])
    print("textured frame with and without its maps, alternating runs of "
          f"{TIMED_FRAMES_OFF} frames: " + "; ".join(
              f"{k} " + ", ".join(f"{v:.2f}" for v in vs) + " ms/frame"
              for k, vs in readings.items()))
    del r_plain
    cam = r.make_camera(camkw["eye"], camkw["target"], 0)
    rays = primary_rays(cam, W, H)
    check_k1(r.trace_scene, rays, "textured", "primary")
    # the surface fetch of the primary rays with and without the maps
    hit, attrs = bvh.closest_hit_attrs(r.trace_scene, *rays)
    plain = dataclasses.replace(r.scene, atlas=None)
    fetch_ms = {name: (cuda_ms(lambda: surface_from_attrs(sc, rays[0], rays[1], hit, attrs), 10),
                       cuda_ms(lambda: surface_from_attrs(sc, rays[0], rays[1], hit, attrs), 10,
                               queued=True))
                for name, sc in (("maps", r.scene), ("no maps", plain))}
    print(f"textured: surface_from_attrs on the {rays[0].shape[0]} primary rays, ms one by one / "
          f"queued: " + "; ".join(f"{k} {a:.3f} / {q:.3f}" for k, (a, q) in fetch_ms.items()))
    # a row gather both ways, PyTorch's and math3d.take_rows: one bilinear
    # tap of the atlas (16-byte texels), and tables of 24- and 64-byte rows
    # (a float32 6-vector, a 4x4 matrix) at the same indices
    from hybrid_rendering_torch.ops.math3d import take_rows

    texels = r.scene.atlas.image.reshape(-1, 4)
    lin = torch.randint(texels.shape[0], (rays[0].shape[0],), device=dev)
    tables = {16: texels, 24: torch.rand((texels.shape[0], 6), device=dev),
              64: torch.rand((texels.shape[0], 4, 4), device=dev)}
    gathers = []
    for nbytes, table in tables.items():
        check(torch.equal(take_rows(table, lin), table[lin]),
              f"take_rows differs from indexing on {nbytes}-byte rows")
        gathers.append(f"{nbytes} bytes: table[idx] "
                       f"{cuda_ms(lambda: table[lin], 10, queued=True):.3f}, take_rows "
                       f"{cuda_ms(lambda: take_rows(table, lin), 10, queued=True):.3f}")
    print(f"textured: a gather of {lin.shape[0]} rows from {texels.shape[0]} (ms queued), "
          + "; ".join(gathers))
    small_phase(dev, textured_build(scene, debug=True), "textured frame")
    ldr = {}
    for name, sc in (("maps", scene), ("no maps", dataclasses.replace(scene, atlas=None))):
        rs, ls, ck = textured_build(sc)(SMALL_W, SMALL_H, dev)
        out, _ = rs.render_frame(rs.create_state(), rs.make_camera(ck["eye"], ck["target"], 0), ls)
        ldr[name] = out["ldr"]
    diff = (ldr["maps"] - ldr["no maps"]).abs().amax(dim=-1)
    print(f"textured vs its maps removed, {SMALL_W}x{SMALL_H} LDR: {(diff > 0.01).float().mean():.2%} "
          f"of pixels beyond 0.01, mean {diff.mean():.4f}")
    check((diff > 0.01).float().mean().item() > 0.2, "the maps hardly change the frame")
    return ms


def hero_animator(frame, device=None):
    """shadows_test's hero (instance HERO_INSTANCE) turned about y around
    its centre by 0.3 rad a frame and moved by (0.4, 0.05, -0.2) a frame;
    every other instance at identity. (14, 4, 4) float32."""
    c, s = np.cos(0.3 * frame), np.sin(0.3 * frame)
    rot = np.eye(4)
    rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = c, s, -s, c
    to, back = np.eye(4), np.eye(4)
    to[:3, 3] = np.asarray(HERO_CENTER) + np.asarray([0.4, 0.05, -0.2]) * frame
    back[:3, 3] = -np.asarray(HERO_CENTER)
    m = np.tile(np.eye(4), (14, 1, 1))
    m[HERO_INSTANCE] = to @ rot @ back
    return torch.as_tensor(m.astype(np.float32), device=device)


def refit_ms(scene, accel, transforms, method="auto"):
    """A refit (the soup re-posed by `transforms` and the trace structures
    refitted): (ms launched one by one, ms queued) over 20 calls."""
    from hybrid_rendering_torch.ops import bvh
    from hybrid_rendering_torch.scene import dynamic

    def refit():
        return bvh.refit_accel(accel, dynamic.refit_scene(scene, transforms), method)

    return cuda_ms(refit, 20), cuda_ms(refit, 20, queued=True)


def dynamic_phase(dev, counters, hero=None):
    """shadows_test with hero_animator through HybridRenderer(animator=) at
    1920x1080 with the bench frame's passes: 1 + TIMED_FRAMES frames with
    the launch counters set to 0 just before and read just after (K1-K5
    launched), and the refit's ms a frame; no call of posed_tracers that
    makes the host wait for the card, and a whole frame that waits no more
    often than the same renderer's frame without its animator; K1
    and K2 on the refitted tree against their plain versions and against
    brute force on the moved soup; the motion plane of a static camera; three frames at 256x144 on
    the card against the CPU; the refit of the hero scene's tree (`hero`:
    (scene, TraceScene) on the card, built here when None); and 1 + 2
    frames with tracer_method="flash_dense" (K6 and K6′ launched, K1 and K2
    not). Returns (ms/frame, refit ms)."""
    from hybrid_rendering_torch.models import gbuffer
    from hybrid_rendering_torch.ops import bvh, intersect
    from hybrid_rendering_torch.ops.math3d import normalize3
    from hybrid_rendering_torch.scene import dynamic
    from hybrid_rendering_torch.utils import camera as camera_utils

    r, light, camkw = bench_torch._build(SCENE, W, H, device=dev, animator=hero_animator)
    zero_counts(counters)
    ms, _, out, state, frame_cam, _ = bench_torch._time_frames(r, light, camkw, TIMED_FRAMES,
                                                               keep_state=True)
    launches = read_counts(counters)
    per_frame = {k: n / (TIMED_FRAMES + 1) for k, n in launches.items()}
    check_ldr(out["ldr"], "dynamic frame")
    for k in ("K1", "K2", "K3", "K4", "K5"):
        check(launches[k] > 0, f"{k} was not launched on the dynamic frame")
    for k in ("K6", "K6′"):
        check(launches[k] == 0, f"{k} was launched on the dynamic frame")
    del out
    # the pose of a frame reaches the card without making the host wait:
    # the next frame (the animator called once, its last pose kept) and a
    # frame out of order (both poses copied); then a whole frame, which
    # waits no more often than the same renderer's frame without animator
    f = state.frame_index
    waits = synchronizing_calls(lambda: (r.posed_tracers(f), r.posed_tracers(3)))
    frame_waits = synchronizing_calls(lambda: r.render_frame(state, frame_cam, light))
    r.animator = None
    static_waits = synchronizing_calls(lambda: r.render_frame(state, frame_cam, light))
    r.animator = hero_animator
    sites = sorted({w: frame_waits.count(w) for w in frame_waits}.items())
    print(f"dynamic: synchronizing calls in posed_tracers: {waits or 'none'}; in a whole "
          f"dynamic frame: {len(frame_waits)} (the frame without animator: "
          f"{len(static_waits)}), by site: {sites}")
    check(not waits, f"posed_tracers waits for the card at {waits}")
    check(len(frame_waits) <= len(static_waits),
          f"the dynamic frame waits for the card {len(frame_waits)} times, the static one "
          f"{len(static_waits)}")
    m = hero_animator(3, dev)
    one, queued = refit_ms(r.scene, r.trace_scene, m)
    print(f"dynamic frame: {SCENE} {W}x{H}, the hero animated: {ms:.2f} ms/frame over "
          f"{TIMED_FRAMES} frames, launches {launches} ({per_frame} per frame); the refit "
          f"({r.scene.num_triangles} triangles, {r.trace_scene.nodes_min.shape[0]} nodes, "
          f"{len(r.trace_scene.plan.levels)} levels, {r.trace_scene.wide_packed.shape[0]} wide "
          f"nodes): {one:.3f} ms a frame one by one, {queued:.3f} queued")

    # K1 and K2 on the refitted tree (frame 3's pose, a camera without jitter)
    moved = dynamic.refit_scene(r.scene, m)
    rts = bvh.refit_accel(r.trace_scene, moved)
    cam = camera_utils.make_camera(camkw["eye"], camkw["target"], width=W, height=H, device=dev)
    o, d, tm = primary_rays(cam, W, H)
    check_k1(rts, (o, d, tm), "dynamic", "primary, refitted tree")
    hit, attrs = bvh.closest_hit_attrs(rts, o, d, tm)
    valid = hit.valid
    on_hero = valid & (attrs[:, 16].round() == HERO_INSTANCE)
    p = o + hit.t[:, None] * d + attrs[:, 17:20] * 1e-3
    gen = torch.Generator(device=dev).manual_seed(0)
    ao_dir = normalize3(attrs[:, 17:20] + normalize3(
        torch.randn(d.shape, device=dev, generator=gen)))
    sun = light.direction.expand_as(p)
    vis_o = torch.cat([p[valid], p[valid]])
    vis_d = torch.cat([sun[valid], ao_dir[valid]]).contiguous()
    vis_tm = torch.cat([torch.full((int(valid.sum()),), float("inf"), device=dev),
                        torch.full((int(valid.sum()),), 1.0, device=dev)])
    check_k2(rts, (vis_o.contiguous(), vis_d, vis_tm), "dynamic", "shadow + AO, refitted tree")
    # brute force on the moved soup: a sample of SAMPLE rays, half on the hero
    k = DYNAMIC_SAMPLE // 2
    hero_idx = torch.nonzero(on_hero).squeeze(1)
    idx = torch.cat([hero_idx[torch.randint(hero_idx.numel(), (k,), device=dev, generator=gen)],
                     torch.randint(o.shape[0], (k,), device=dev, generator=gen)])
    ref = intersect.closest_hit_brute(moved.tri_pos, o[idx], d[idx], tm[idx])
    check(torch.equal(hit.valid[idx], ref.valid),
          "K1 on the refitted tree: hit/miss differs from brute")
    differ = hit.tri_id[idx] != ref.tri_id
    tie = bool(((hit.t[idx] - ref.t).abs() <= 1e-5 * ref.t.abs())[differ].all())
    agree = 1.0 - differ.float().mean().item()
    check(agree >= K1_MIN_AGREE and tie, f"K1 vs brute on the moved soup: tri_id agree {agree}")
    vidx = torch.randint(vis_o.shape[0], (DYNAMIC_SAMPLE,), device=dev, generator=gen)
    vis = bvh.visibility(rts, vis_o[vidx].contiguous(), vis_d[vidx].contiguous(), vis_tm[vidx])
    vref = intersect.occluded_brute(moved.tri_pos, vis_o[vidx], vis_d[vidx], vis_tm[vidx])
    check(torch.equal(vis, vref), "K2 on the refitted tree: visibility differs from brute")
    # K2 through the stale tree must miss some of the moved hero's shadow
    stale = bvh.visibility(r.trace_scene, vis_o[vidx].contiguous(), vis_d[vidx].contiguous(),
                           vis_tm[vidx])
    print(f"dynamic: K1 vs brute on {DYNAMIC_SAMPLE} rays ({k} on the hero) of the moved soup: "
          f"tri_id agree {agree:.6f} (other ids only at ties of t); K2 vs brute on "
          f"{DYNAMIC_SAMPLE} shadow + AO rays: equal, unoccluded {vis.mean().item():.4f}; the "
          f"unrefitted tree would answer {(stale != vref).sum().item()} of them otherwise")

    # the motion plane, static camera, frame 3
    surf_fn, _, deltas = r.posed_tracers(3)
    gb = gbuffer.render_gbuffer(surf_fn, cam, W, H, motion_deltas=deltas)
    mesh = gb.mesh_id
    motion = gb.motion.abs().amax(dim=-1)
    hero_px = mesh == HERO_INSTANCE
    static = (mesh >= 0) & ~hero_px
    print(f"dynamic: motion plane, static camera: hero {int(hero_px.sum())} pixels, median "
          f"|motion| {motion[hero_px].median().item():.4g}; static geometry max "
          f"{motion[static].max().item():.3g}")
    check(int(hero_px.sum()) > 1000 and motion[hero_px].median().item() > 1e-3,
          "the moving hero has no motion")
    check(motion[static].max().item() <= 1e-4, "static geometry moves in the motion plane")
    del gb, r, state

    small_phase(dev, lambda w, h, device: bench_torch._build(
        SCENE, w, h, device=device, debug=True, animator=hero_animator), "dynamic frame")

    if hero is None:
        from hybrid_rendering_torch.scene.scenes import load_scene

        hero_scene = load_scene(HERO_SCENE)[0].to(dev)
        hero = hero_scene, bvh.make_accel(hero_scene)
    hero_scene, hero_ts = hero
    num_i = int(hero_scene.tri_mesh_id.max()) + 1
    hm = dynamic.identity_transforms(num_i, dev).clone()
    hm[num_i // 2] = hero_animator(2, dev)[HERO_INSTANCE]
    h_one, h_queued = refit_ms(hero_scene, hero_ts, hm)
    print(f"dynamic: the refit of {HERO_SCENE}'s tree ({hero_scene.num_triangles} triangles, "
          f"{hero_ts.nodes_min.shape[0]} nodes, {len(hero_ts.plan.levels)} levels, "
          f"{hero_ts.wide_packed.shape[0]} wide nodes, {num_i} instances, one moved): "
          f"{h_one:.3f} ms one by one, {h_queued:.3f} queued")

    r, light, camkw = bench_torch._build(SCENE, W, H, device=dev, tracer_method="flash_dense",
                                        animator=hero_animator)
    zero_counts(counters)
    dms, _, out = bench_torch._time_frames(r, light, camkw, 2)
    launches = read_counts(counters)
    check_ldr(out["ldr"], "dynamic dense frame")
    for k in ("K6", "K6′"):
        check(launches[k] > 0, f"{k} was not launched on the dynamic dense frame")
    for k in ("K1", "K2"):
        check(launches[k] == 0, f"{k} was launched on the dynamic dense frame")
    d_one, d_queued = refit_ms(r.scene, r.trace_scene, m, "flash_dense")
    print(f"dynamic dense frame (tracer_method=\"flash_dense\"): {dms:.2f} ms/frame over 2 "
          f"frames, launches {launches}; make_flash_scene on the moved soup {d_one:.3f} ms one "
          f"by one, {d_queued:.3f} queued")
    return ms, one


# ---------------------------------------------------------------------------
# multi-device: the tracers sharded over meshes that repeat the card
# ---------------------------------------------------------------------------


def same_bits(got, ref):
    """Equal bit for bit: tensors (NaN included), Hit and Surface fields,
    tuples and lists of those."""
    if isinstance(ref, torch.Tensor):
        return bits_equal(got, ref)
    if isinstance(ref, (tuple, list)):
        return len(got) == len(ref) and all(same_bits(g, r) for g, r in zip(got, ref))
    return all(same_bits(getattr(got, f.name), getattr(ref, f.name))
               for f in dataclasses.fields(ref))


def site_call(fn, args, many):
    """A call of tracer `fn` at a site: ``fn.many(args)`` or ``fn(*args)``."""
    return (lambda: fn.many(args)) if many else (lambda: fn(*args))


def sharded_sites(r, wf, counters, kernels):
    """Every K1/K2 site of `wf` (the renderer's own calls, ``wavefronts``
    ``calls``) through `r`'s tracers and through the same tracers sharded
    over meshes of PARALLEL_SHARDS repeated cards: bit for bit, each
    sharded call launching its kernel once a shard; ms of each (CUDA
    events, 5 calls after a warm-up). `kernels`: the counters of the
    closest-hit and any-hit sites ("K1", "K2" or "K6", "K6′")."""
    from hybrid_rendering_torch.parallel import mesh as mesh_mod
    from hybrid_rendering_torch.parallel import trace as ptrace

    dev, method = r.device, r.tracer_method
    for n in PARALLEL_SHARDS:
        mesh = mesh_mod.make_mesh(devices=[dev] * n)
        _, s_vis, s_surf = ptrace.shard_renderer_tracers(
            mesh, r.closest_fn, r.visibility_fn, r.closest_surface_fn,
            ptrace.replicate(mesh, r.scene, r.trace_scene), method)
        sites = [(kernels[0], name, r.closest_surface_fn, s_surf, args)
                 for name, args in wf["calls"]["K1"].items()]
        sites += [(kernels[1], name, r.visibility_fn, s_vis, args)
                  for name, args in wf["calls"]["K2"].items()]
        for kernel, name, fn, s_fn, args in sites:
            many = name == "shadow + AO"
            call, s_call = site_call(fn, args, many), site_call(s_fn, args, many)
            ref = call()
            zero_counts(counters)
            got = s_call()
            launched = read_counts(counters)[kernel]
            shapes = [tuple(q[0].shape[:-1]) for q in (args if many else [args])]
            rays = sum(int(np.prod(sh)) for sh in shapes)
            split = ("rows split" if not many and len(shapes[0]) == 2 and shapes[0][0] % n == 0
                     else f"flat, {(-rays) % n} rays of padding")
            check(same_bits(got, ref),
                  f"{kernel} {name} sharded over {n} shards differs from the unsharded call")
            check(launched == n, f"{kernel} {name} over {n} shards: {launched} launches")
            ms, s_ms = cuda_ms(call, 5), cuda_ms(s_call, 5)
            print(f"[parallel] {kernel} {name} {shapes} ({rays} rays, {split}) over {n} x {dev}: "
                  f"bit for bit; {s_ms:.3f} ms sharded against {ms:.3f} ms unsharded, "
                  f"{launched} launches a call")


def moving_frames(r, light, camkw, frames):
    """1 + `frames` frames of a camera sliding along x: each frame's LDR
    frame and its TAA-resolved HDR frame."""
    state, prev, out = r.create_state(), None, []
    for f in range(1 + frames):
        eye = tuple(np.asarray(camkw["eye"]) + [EYE_STEP * f, 0.0, 0.0])
        cam = r.make_camera(eye, camkw["target"], f, prev_view_proj=prev)
        prev = cam.view_proj
        o, state = r.render_frame(state, cam, light)
        out.append((o["ldr"], state.taa.history))
    return out


def parallel_phase(dev, counters):
    """The multi-device path on meshes that repeat the card: K1/K2 sharded
    over 2 and 3 shards at every 1080p site of the bench frame, and K6/K6′
    at the dense frame's, bit for bit against the unsharded calls, timed
    beside them; the bench frame with its tracers sharded over 2 shards
    (``HybridRenderer(mesh=)``), 1 + PARALLEL_FRAMES moving-camera frames
    bit for bit against the unsharded frame on the LDR and HDR frames, with
    the counters set to 0 just before each run and read just after, both
    timed in turns (``bench_torch._time_frames``: unsharded, sharded,
    sharded, unsharded), and the sharded frame making no
    more synchronizing calls than the unsharded one; the sharded GT step
    against the unsharded GT at 256x256; and ``entry_torch.dryrun_multichip
    (8)`` on the card."""
    import entry_torch
    from hybrid_rendering_torch.config import PathTracerConfig
    from hybrid_rendering_torch.models import path_tracer
    from hybrid_rendering_torch.ops import bvh
    from hybrid_rendering_torch.ops.sky import ProceduralSky
    from hybrid_rendering_torch.parallel import mesh as mesh_mod
    from hybrid_rendering_torch.parallel.render import path_trace_frame_sharded
    from hybrid_rendering_torch.utils import camera as camera_utils

    for method, kernels in (("auto", ("K1", "K2")), ("flash_dense", ("K6", "K6′"))):
        r, light, camkw = bench_torch._build(SCENE, W, H, device=dev, tracer_method=method)
        cam = r.make_camera(camkw["eye"], camkw["target"], 0)
        wf = wavefronts(r, r.create_state(), cam, light)
        sharded_sites(r, wf, counters, kernels)
        del wf, r

    # the bench frame, its tracers sharded over PARALLEL_FRAME_SHARDS shards
    n = PARALLEL_FRAME_SHARDS
    mesh = mesh_mod.make_mesh(devices=[dev] * n)
    runs, launches, waits = {}, {}, {}
    ms = {"unsharded": [], "sharded": []}
    r, light, camkw = bench_torch._build(SCENE, W, H, device=dev)
    rs, _, _ = bench_torch._build(SCENE, W, H, device=dev, mesh=mesh)
    for label, rr in (("unsharded", r), ("sharded", rs)):
        zero_counts(counters)
        runs[label] = moving_frames(rr, light, camkw, PARALLEL_FRAMES)
        launches[label] = {k: v / (1 + PARALLEL_FRAMES) for k, v in read_counts(counters).items()}
    # timed in turns, as the frame follows the host
    for label, rr in (("unsharded", r), ("sharded", rs), ("sharded", rs), ("unsharded", r)):
        t, _, out, state, cam, _ = bench_torch._time_frames(rr, light, camkw, TIMED_FRAMES,
                                                            keep_state=True)
        ms[label].append(t)
        check_ldr(out["ldr"], f"{label} bench frame")
        waits[label] = synchronizing_calls(lambda: rr.render_frame(state, cam, light))
    for f, ((ldr, hdr), (ldr_ref, hdr_ref)) in enumerate(zip(runs["sharded"],
                                                             runs["unsharded"])):
        check(bits_equal(ldr, ldr_ref) and bits_equal(hdr, hdr_ref),
              f"sharded bench frame {f}: LDR or HDR differs from the unsharded frame")
    sh, un = launches["sharded"], launches["unsharded"]
    for k in ("K1", "K2", "K3", "K4", "K5"):
        check(sh[k] > 0, f"{k} was not launched on the sharded bench frame")
    for k in ("K1", "K2"):
        check(sh[k] == n * un[k], f"{k}: {sh[k]} launches a sharded frame, {un[k]} unsharded")
    for k in ("K3", "K4", "K5", "K6", "K6′", "K7"):
        check(sh[k] == un[k], f"{k}: {sh[k]} launches a sharded frame, {un[k]} unsharded")
    print(f"[parallel] bench frame {W}x{H} over {n} x {dev} (HybridRenderer(mesh=)): LDR and HDR "
          f"bit for bit over 1 + {PARALLEL_FRAMES} moving-camera frames; "
          f"ms/frame over {TIMED_FRAMES} frames, timed in the order unsharded, sharded, sharded, "
          f"unsharded: sharded {ms['sharded'][0]:.2f}, {ms['sharded'][1]:.2f}, unsharded "
          f"{ms['unsharded'][0]:.2f}, {ms['unsharded'][1]:.2f}; launches a frame sharded {sh}, "
          f"unsharded {un}; "
          f"synchronizing calls in a frame: sharded {len(waits['sharded'])}, unsharded "
          f"{len(waits['unsharded'])}; the sharded frame's beyond the unsharded's at "
          f"{sorted((Counter(waits['sharded']) - Counter(waits['unsharded'])).items()) or 'none'}")
    check(len(waits["sharded"]) <= len(waits["unsharded"]),
          f"the sharded frame waits for the card {len(waits['sharded'])} times, the unsharded "
          f"{len(waits['unsharded'])}")
    del runs, rs

    # the GT path tracer, a row block a shard, against the unsharded one
    G = PARALLEL_GT
    gcam = camera_utils.make_camera(camkw["eye"], camkw["target"], width=G, height=G,
                                    device=dev)
    sky = ProceduralSky.create(light.direction.cpu().numpy()).to(dev)
    cfg = PathTracerConfig()
    surf, vis = (bvh.make_surface_tracer(r.scene, method="bvh"),
                 bvh.make_tracers(r.scene, method="bvh")[1])
    ref, gt_ms = wall_ms(lambda: path_tracer.render_progressive(
        r.scene, surf, vis, gcam, light, sky.radiance, G, G, 2, cfg))
    for gn in PARALLEL_GT_SHARDS:
        step = path_trace_frame_sharded(mesh_mod.make_mesh(devices=[dev] * gn), r.scene, gcam,
                                        light, sky, G, G, cfg)
        zero_counts(counters)

        def two_steps():
            st = path_tracer.GroundTruthState.create(G, G, dev)
            return step(step(st))

        got, s_ms = wall_ms(two_steps)
        gl = read_counts(counters)
        d = (got.color - ref.color).abs().max().item()
        print(f"[parallel] GT {G}x{G}, 2 spp over {gn} x {dev}: max |d| {d:.3g} against the "
              f"unsharded GT; {s_ms:.1f} ms sharded against {gt_ms:.1f} ms unsharded (host "
              f"clock, 2 samples); launches {gl}")
        check(int(got.num_frames) == 2 and bits_equal(got.color, ref.color),
              f"the sharded GT over {gn} shards differs from the unsharded GT (max |d| {d})")
        check(gl["K1"] > 0 and gl["K2"] > 0, "the sharded GT launched no K1 or K2")
    del r

    entry_torch.dryrun_multichip(PARALLEL_DRYRUN)


def run_cli(label, argv, out):
    """render_torch.py in a subprocess with APPS_TIMEOUT_S: it must exit 0
    and write a non-constant PNG to `out`. Its lines are printed in one
    write, so that runs in threads do not interleave. Returns its
    stderr."""
    from hybrid_rendering_torch.utils import image

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "render_torch.py"), *argv,
                           "--out", out], cwd=ROOT, capture_output=True, text=True,
                          timeout=APPS_TIMEOUT_S)
    secs = time.perf_counter() - t0
    lines = [f"[{label}] {line}" for line in proc.stderr.splitlines()[-12:]]
    lines.append(f"{label}: render_torch.py {' '.join(argv)}: exit {proc.returncode} after "
                 f"{secs:.1f} s")
    sys.stdout.write("\n".join(lines) + "\n")
    check(proc.returncode == 0, f"{label}: render_torch.py exited {proc.returncode}")
    check(proc.stdout.strip().splitlines()[-1] == out, f"{label}: printed {proc.stdout!r}")
    img = image.read_png(out)
    check(img.ndim == 3 and bool(np.isfinite(img).all()) and img.std() > 0.02,
          f"{label}: {out} is not a non-constant image (std {img.std()})")
    return proc.stderr


def frame_timer_ms(stderr):
    """The FrameTimer's frame row of a --profile run: (ms a frame, frames)."""
    import re

    m = re.search(r"^\s*frame\s+([\d.]+) ms \(x(\d+)\)$", stderr, flags=re.M)
    check(m is not None, "no FrameTimer frame row in the --profile output")
    return float(m.group(1)), int(m.group(2))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def read_viewer(port, proc, timeout):
    """/stats once a frame is up, then the first frame of /stream (its PNG
    bytes). http.client, which reads no proxy setting: every request goes
    to 127.0.0.1 itself."""
    import http.client

    deadline = time.monotonic() + timeout
    while True:
        check(proc.poll() is None, f"viewer_torch.py exited {proc.returncode}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.request("GET", "/stats")
            stats = conn.getresponse().read().decode()
            if "fps" in stats:
                break
        except OSError:
            pass
        finally:
            conn.close()
        check(time.monotonic() < deadline, f"viewer_torch.py: no frame after {timeout} s")
        time.sleep(0.5)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        check(resp.status == 200, f"/stream: HTTP {resp.status}")
        boundary = resp.fp.readline()
        check(boundary.strip() == b"--FRAME", f"/stream: {boundary!r}")
        headers = {}
        while True:
            line = resp.fp.readline().strip()
            if not line:
                break
            key, _, value = line.decode().partition(":")
            headers[key.strip().lower()] = value.strip()
        png = resp.fp.read(int(headers["content-length"]))
    finally:
        conn.close()
    return stats, png


def viewer_check(args=()):
    """viewer_torch.py started on 127.0.0.1 at a free port: /stats and the
    first frame of /stream (a non-constant image), then the process is
    stopped. Returns (stats line, image shape)."""
    import tempfile

    from hybrid_rendering_torch.utils import image

    port = free_port()
    with tempfile.TemporaryFile("w+") as log:
        proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "viewer_torch.py"),
                                 "--port", str(port), *args], cwd=ROOT,
                                stdout=log, stderr=subprocess.STDOUT)
        try:
            stats, png = read_viewer(port, proc, APPS_TIMEOUT_S)
        except BaseException:
            log.seek(0)
            print("[viewer] " + "\n[viewer] ".join(log.read().splitlines()[-20:]))
            raise
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    img = image.read_png(png)
    check(img.ndim == 3 and img.std() > 0.02, f"viewer frame: std {img.std()}")
    return stats.splitlines()[0], img.shape


def envlit_runs(dev, counters):
    """render_torch.py's renderer lit by APPS_ENV at 256x144, DDGI and
    reflections on, over APPS_SMALL_FRAMES frames of the scene's
    DemoPlayer camera, on the card (launch counters set to 0 just before
    and read just after: K1-K5 each launched) and on the CPU; every plane
    compared."""
    import render_torch
    from hybrid_rendering_torch.utils.animation import DemoPlayer

    args = render_torch.parse_args(["--scene", SCENE, "--width", str(SMALL_W), "--height",
                                    str(SMALL_H), "--env", APPS_ENV])
    runs = {}
    for device in (dev, torch.device("cpu")):
        r, light, camkw, preset = render_torch.build(args, device)
        check(r.config.ddgi.enabled and r.config.reflections.enabled,
              "env-lit frame: DDGI or reflections off")
        player = DemoPlayer(preset.demo_keyframes)
        player.play()
        state, prev, frames = r.create_state(), None, []
        zero_counts(counters)
        for f in range(APPS_SMALL_FRAMES):
            eye, target = player.update(1.0 / 30.0)
            cam = r.make_camera(eye, target, f, prev)
            prev = cam.view_proj
            out, state = r.render_frame(state, cam, light)
            frames.append({k: v.cpu().numpy() for k, v in out.items()})
        launches = read_counts(counters)
        if device.type == "cuda":
            print(f"env-lit frame ({APPS_ENV}, {SMALL_W}x{SMALL_H}, {APPS_SMALL_FRAMES} DemoPlayer "
                  f"frames) on the card: launches {launches}")
            for k in ("K1", "K2", "K3", "K4", "K5"):
                check(launches[k] > 0, f"env-lit frame: {k} was not launched")
        else:
            check(not any(launches.values()), f"env-lit frame on the CPU launched {launches}")
        runs[device.type] = frames
    compare_runs(runs, "env-lit frame")


def passes_by_sky(dev):
    """render_torch.py's 1080p renderer lit by APPS_ENV and by the Hosek
    sky, both built and warmed first (2 frames each). Each pass with a
    synchronize around it, over SKY_FRAMES frames a window, the windows in
    SKY_ORDER; then deferred shading and the reflections pass, where the
    image environment's radiance and prefiltered pyramid are read, called
    alone on one frame's recorded arguments, SKY_REPS calls between CUDA
    events a reading, the readings in SKY_ORDER. Prints the median of each
    sky's readings and their range."""
    import statistics

    import render_torch
    from hybrid_rendering_torch.models import deferred, reflections

    runs = {}
    for sky in (["--env", APPS_ENV], ["--sky", "hosek"]):
        args = render_torch.parse_args(["--scene", SCENE, "--width", str(W), "--height", str(H),
                                        *sky])
        r, light, camkw, _ = render_torch.build(args, dev)
        cam = r.make_camera(camkw["eye"], camkw["target"], 0)
        state = r.create_state()
        for _ in range(2):
            _, state = r.render_frame(state, cam, light)
        runs[sky[1]] = [r, state, cam, light]
    torch.cuda.synchronize()

    windows = {sky: {} for sky in runs}
    for sky in SKY_ORDER:
        run, times = runs[sky], {}
        with pass_timers(times):
            for _ in range(SKY_FRAMES):
                _, run[1] = run[0].render_frame(run[1], run[2], run[3])
        for name, total in times.items():
            windows[sky].setdefault(name, []).append(total / SKY_FRAMES)

    alone = {sky: {} for sky in runs}
    targets = ((deferred, "deferred_shading"), (reflections, "reflections_pass"))
    calls = {}
    for sky, run in runs.items():
        saved = [getattr(mod, name) for mod, name in targets]
        recs = [recorder(fn) for fn in saved]
        try:
            for (mod, name), rec in zip(targets, recs):
                setattr(mod, name, rec)
            _, run[1] = run[0].render_frame(run[1], run[2], run[3])
        finally:
            for (mod, name), fn in zip(targets, saved):
                setattr(mod, name, fn)
        calls[sky] = [(name, fn, rec.calls[0]) for (_, name), fn, rec in zip(targets, saved, recs)]
    for sky in SKY_ORDER:
        for name, fn, (a, kw) in calls[sky]:
            alone[sky].setdefault(name, []).append(cuda_ms(lambda: fn(*a, **kw), SKY_REPS))
    del runs, calls

    def row(readings):
        return (f"{statistics.median(readings):.3f} [{min(readings):.3f}-"
                f"{max(readings):.3f}]")

    env, hosek = windows[APPS_ENV], windows["hosek"]
    print(f"per pass at {W}x{H} (synchronized, ms a frame, median [range] of "
          f"{SKY_ORDER.count('hosek')} windows of {SKY_FRAMES} frames each, in the order "
          f"{', '.join(SKY_ORDER)}), lit by {APPS_ENV} / by the Hosek sky:")
    for name in sorted(env, key=lambda k: -statistics.median(env[k])):
        print(f"  {name}: {row(env[name])} / {row(hosek[name])}")
    print(f"called alone on one frame's arguments (CUDA events, {SKY_REPS} calls a reading, "
          f"ms a call, median [range] of {SKY_ORDER.count('hosek')} readings), lit by "
          f"{APPS_ENV} / by the Hosek sky:")
    for name in alone[APPS_ENV]:
        print(f"  {name}: {row(alone[APPS_ENV][name])} / {row(alone['hosek'][name])}")
    return windows, alone


def apps_phase(dev, counters, card):
    """The apps of the port. First, alone on the card: render_torch.py at
    1920x1080, animated and env-lit with --profile and a checkpoint (its
    FrameTimer row is the apps' frame time). Then, in threads beside the
    env-lit frame on the card against the CPU (K1-K5 counted), none of
    them timed: the same run resumed from the checkpoint, render_torch.py
    at 1920x1080 lit by the Hosek sky and in GT mode at 480x270, and
    viewer_torch.py's first frame. Then, alone again: each pass lit by the
    image environment and by the Hosek sky, and the Hosek fit's time on
    the card's host. Every render_torch.py run is a subprocess that must
    exit 0 and write a non-constant PNG."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from hybrid_rendering_torch.ops.hosek import HosekWilkieSky
    from hybrid_rendering_torch.scene.scenes import load_scene

    os.makedirs(APPS_OUT, exist_ok=True)
    full = ["--scene", SCENE, "--width", str(W), "--height", str(H)]
    gw, gh, spp = APPS_GT
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "state.npz")
        anim = full + ["--animate", "--frames", str(APPS_FRAMES), "--env", APPS_ENV,
                       "--visualize", "reflections", "--profile", "--checkpoint", ck]
        err = run_cli("animated", anim, os.path.join(APPS_OUT, "animated.png"))
        ms, n = frame_timer_ms(err)
        check(n == APPS_FRAMES and os.path.exists(ck), "animated run: frames or checkpoint")
        print(f"{card}: render_torch.py {W}x{H} env {APPS_ENV}, DDGI + reflections: FrameTimer "
              f"{ms:.2f} ms a frame over {APPS_FRAMES} frames")
        # each job stops its own process, and leaving the pool waits for them
        with ThreadPoolExecutor(4) as pool:
            jobs = [pool.submit(run_cli, "resumed", anim, os.path.join(APPS_OUT, "resumed.png")),
                    pool.submit(run_cli, "hosek", full + ["--sky", "hosek"],
                                os.path.join(APPS_OUT, "hosek.png")),
                    pool.submit(run_cli, "gt", ["--scene", SCENE, "--width", gw, "--height", gh,
                                                "--mode", "gt", "--spp", spp],
                                os.path.join(APPS_OUT, "gt.png")),
                    pool.submit(viewer_check)]
            envlit_runs(dev, counters)
            results = [job.result() for job in jobs]
    check(f"resumed state from {ck}" in results[0],
          "the second run did not resume the checkpoint")
    stats, shape = results[3]
    print(f"viewer_torch.py: /stats {stats!r}, first /stream frame {shape} (the resumed run, the "
          f"viewer and the Hosek and GT runs shared the card)")
    passes_by_sky(dev)
    sun = load_scene(SCENE, use_bvh=False)[1].direction.numpy()
    t0 = time.perf_counter()
    HosekWilkieSky.create(sun)
    print(f"HosekWilkieSky.create ({SCENE}'s sun) on the card's host: "
          f"{time.perf_counter() - t0:.3f} s")


def hero_phase(dev, counters):
    """The hero scene (sponza_scan, 249,765 triangles) at 1920x1080 through
    the bench's build: the BVH builder's seconds and the tree's size; 1 +
    HERO_FRAMES frames with the launch counters set to 0 just before and
    read just after (K1-K5 launched, K6/K6′ not); then K1-K5 held against
    their plain versions on the hero's own wavefronts and timed there,
    with the plain walk's seconds: the walk kernels on a deep tree.
    Returns the hero's (scene, TraceScene) on the card."""
    from hybrid_rendering_torch.ops import bvh
    from hybrid_rendering_torch.scene import native

    t0 = time.perf_counter()
    r, light, camkw = bench_torch._build(HERO_SCENE, W, H, device=dev)
    build_s = time.perf_counter() - t0
    T = r.scene.num_triangles
    check(T == HERO_TRIANGLES, f"hero: {T} triangles, expected {HERO_TRIANGLES}")
    builder = native.build_bvh_native if native.get_lib() is not None else bvh.build_bvh
    t0 = time.perf_counter()
    builder(r.scene.tri_pos.cpu().numpy())
    bvh_s = time.perf_counter() - t0
    ts = r.trace_scene
    t0 = time.perf_counter()
    bvh.pack_wide_nodes(ts.nodes_min.cpu(), ts.nodes_max.cpu(), ts.nodes_meta.cpu())
    pack_s = time.perf_counter() - t0
    print(f"hero: {HERO_SCENE} {W}x{H}, {T} triangles, scene + BVH + renderer built in "
          f"{build_s:.1f} s; the BVH builder ({native.builder_name()}) takes {bvh_s:.2f} s "
          f"on the hero's triangles")
    print(f"hero tree: {ts.nodes_min.shape[0]} binary nodes, {ts.wide_packed.shape[0]} 4-wide "
          f"nodes (pack_wide_nodes {pack_s:.2f} s); DDGI {r.probe_grid.counts} = "
          f"{r.probe_grid.num_probes} probes x {r.config.ddgi.rays_per_probe} rays")

    zero_counts(counters)
    ms, _, out = bench_torch._time_frames(r, light, camkw, HERO_FRAMES)
    launches = read_counts(counters)
    per_frame = {k: n / (HERO_FRAMES + 1) for k, n in launches.items()}
    print(f"hero frame: {ms:.2f} ms/frame over {HERO_FRAMES} frames, launches {launches} "
          f"({per_frame} per frame)")
    check_ldr(out["ldr"], "hero frame")
    for k in ("K1", "K2", "K3", "K4", "K5", "K7"):
        check(launches[k] > 0, f"{k} was not launched on the hero frame")
    for k in ("K6", "K6′"):
        check(launches[k] == 0, f"{k} was launched on the hero frame")
    del out

    state = r.create_state()
    cam = r.make_camera(camkw["eye"], camkw["target"], 0)
    wf = wavefronts(r, state, cam, light)
    errs, times = check_kernels(r, wf, "hero", timing=True)
    print(f"hero: the plain walk took {times['K1'][1] / 1e3:.2f} s on the "
          f"{wf['primary'][0].shape[0]} primary rays and {times['K2'][1] / 1e3:.2f} s on the "
          f"{wf['vis_rays'][0].shape[0]} shadow + AO rays; max abs err {errs}")
    return r.scene, r.trace_scene


def bench_phase():
    """bench_torch.py (the port's bench, 1920x1080) in a subprocess with
    BENCH_BUDGET_S, its lines echoed. Fails unless it exits 0 and its last
    line holds fidelity, golden, passes_ms with the nine passes and
    nothing skipped, hero_ms and the hero's 249,765 triangles, and no
    *_error and no watchdog: a section's caught error cannot hide here."""
    env = {k: v for k, v in os.environ.items() if k != "BENCH_RES"}
    env["BENCH_BUDGET_S"] = str(BENCH_BUDGET_S)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=BENCH_BUDGET_S + 120)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"[bench] {line}")
    for line in proc.stderr.splitlines()[-20:]:
        print(f"[bench stderr] {line}")
    print(f"bench_torch.py: exit {proc.returncode} after {secs:.1f} s")
    check(proc.returncode == 0, f"bench_torch.py exited {proc.returncode}")
    lines = [json.loads(s) for s in proc.stdout.splitlines() if s.startswith("{")]
    check(len(lines) >= 2, "bench_torch.py printed fewer than two JSON lines")
    check(sorted(lines[0]) == ["detail", "metric", "unit", "value", "vs_baseline"]
          and lines[0]["metric"] == "hybrid_pipeline_1080p",
          f"bench_torch.py headline: {lines[0]}")
    d = lines[-1]["detail"]
    errors = {k: v for k, v in d.items() if k.endswith("_error")}
    check(not errors, f"bench_torch.py sections failed: {errors}")
    check("watchdog" not in d, "bench_torch.py ran out of its budget")
    for key in ("fidelity", "golden", "passes_ms", "hero_ms"):
        check(key in d, f"bench_torch.py: no {key}")
    check(tuple(d["passes_ms"]) == PASSES, f"bench_torch.py passes_ms: {d['passes_ms']}")
    check(d["hero_triangles"] == HERO_TRIANGLES,
          f"bench_torch.py hero_triangles {d['hero_triangles']}")
    return lines[-1]["value"], d["hero_ms"]


@contextlib.contextmanager
def pass_timers(times):
    """Wrap each pass the renderer calls in a synchronize + host clock,
    summing ms into `times`; restores the passes on exit."""
    from hybrid_rendering_torch.models import (
        ao, ddgi, deferred, gbuffer, reflections, shadows, taa, tonemap)

    targets = [(gbuffer, "render_gbuffer"), (shadows, "shadows_pass"), (ao, "ao_pass"),
               (ddgi, "ddgi_update"), (ddgi, "sample_probe_grid_screen"),
               (reflections, "reflections_pass"), (deferred, "deferred_shading"),
               (taa, "taa_resolve"), (tonemap, "tonemap"), (ddgi, "visualize_probes")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    try:
        for mod, name, fn in saved:
            setattr(mod, name, timed(name, fn))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def device_time(r, light, camkw, frames):
    """torch.profiler over `frames` steady frames of `r`: (wall ms/frame
    profiled, device kernel ms/frame, kernel launches/frame, the kernel
    rows)."""
    from torch.profiler import ProfilerActivity, profile

    state = r.create_state()
    cam = r.make_camera(camkw["eye"], camkw["target"], 0)
    _, state = r.render_frame(state, cam, light)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            _, state = r.render_frame(state, cam, light)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an aten op's row repeats the device time of the
    # kernels it launched, and the program's spans (``hr::``, on while a
    # session records) are mirrored on the device's timeline
    kernels_ = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("hr::")]
    device_ms = sum(e.self_device_time_total for e in kernels_) / 1e3 / frames
    launches = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    return wall / frames, device_ms, launches / frames, kernels_


def profile_phase(dev, k4_calls):
    """Per-pass ms (a synchronize around each pass) and device busy share
    (torch.profiler over PROFILE_FRAMES steady frames) of the bench frame,
    with K4's kernels counted there: one a call, `k4_calls` calls a frame (the
    launch counter's reading); the device kernel time of the dense
    frame."""
    frames = PROFILE_FRAMES
    r, light, camkw = bench_torch._build(SCENE, W, H, device=dev)
    ms, _, _ = bench_torch._time_frames(r, light, camkw, frames)
    times = {}
    with pass_timers(times):
        ms_sync, _, _ = bench_torch._time_frames(r, light, camkw, frames)
    print(f"per-pass (synchronized, {ms_sync:.2f} ms/frame in this mode):")
    for name, total in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {total / (frames + 1):.3f} ms")
    wall, device_ms, launches, kernels_ = device_time(r, light, camkw, frames)
    print(f"profiler over {frames} frames: wall {wall:.2f} ms/frame profiled, "
          f"device kernel time {device_ms:.2f} ms/frame = {device_ms / ms:.1%} of the "
          f"unprofiled {ms:.2f} ms/frame, {launches:.0f} kernel launches per frame")
    for e in sorted(kernels_, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / frames:8.3f} ms/frame  "
              f"{e.count // frames:5d}x  {e.key[:90]}")
    k4 = sum(e.count for e in kernels_ if "blur_tile_kernel" in e.key)
    print(f"K4: {k4} kernels on the card over {frames} frames of {k4_calls:g} call(s) each")
    check(k4 == frames * k4_calls, f"K4 puts {k4 / (frames * k4_calls)} kernels a call on the card")
    del r
    r, light, camkw = bench_torch._build(SCENE, W, H, device=dev, tracer_method="flash_dense")
    wall, device_ms, launches, kernels_ = device_time(r, light, camkw, frames)
    print(f"profiler over {frames} dense frames: wall {wall:.2f} ms/frame profiled, device "
          f"kernel time {device_ms:.2f} ms/frame, {launches:.0f} kernel launches per frame")
    for e in sorted(kernels_, key=lambda e: -e.self_device_time_total)[:4]:
        print(f"  {e.self_device_time_total / 1e3 / frames:8.3f} ms/frame  "
              f"{e.count // frames:5d}x  {e.key[:90]}")
    # K6′'s kernels: its scan and its compaction
    k6p = [e for e in kernels_ if "k6p_" in e.key or "K6PArgs" in e.key]
    print(f"  K6′ on the dense frame: {sum(e.self_device_time_total for e in k6p) / 1e3 / frames:.3f} "
          f"ms/frame of device time in {sum(e.count for e in k6p) // frames} launches")


def profiler_sessions(fn, n):
    """CUDA kernels one call of `fn` puts on the card, counted by each of
    `n` torch.profiler sessions in turn."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    return counts


def frame_times(dev, profiled, readings=6):
    """The bench frame timed `readings` times over bench_torch's 20 frames
    in this process, after one profiled run of 5 frames (a session like
    profile_phase's) if `profiled`; prints the ms/frame readings as JSON."""
    r, light, camkw = bench_torch._build(SCENE, W, H, device=dev)
    if profiled:
        device_time(r, light, camkw, 5)
    ms = [bench_torch._time_frames(r, light, camkw, bench_torch.HEADLINE_FRAMES)[0]
          for _ in range(readings)]
    print(json.dumps({"profiled": profiled, "ms": ms}))


def profiler_effect(dev, pairs=3):
    """Whether torch.profiler changes what runs after it. K4 at the hero's
    AO site counted by three sessions at the start of this process and by
    three after each of two profiled runs of 5 bench frames; the bench
    frame timed by frame_times in fresh processes, `pairs` times without
    and with a profiled run first, in turn, so the host's drift falls on
    both; and bench_torch.py (bench_phase) in a fresh process."""
    from hybrid_rendering_torch.ops import stencil

    rh, lh, ch = bench_torch._build(HERO_SCENE, W, H, device=dev)
    wf = wavefronts(rh, rh.create_state(), rh.make_camera(ch["eye"], ch["target"], 0), lh)
    gb_a = wf["gb_a"]
    blur_args = (wf["ao"], gb_a.normal, gb_a.linear_z, gb_a.mesh_id >= 0)

    def blur():
        stencil.bilateral_blur(*blur_args, radius=rh.config.ao.blur_radius)

    print(f"[profiler effect] K4 at the hero's AO site, sessions 1-3 of the process: "
          f"{profiler_sessions(blur, 3)} kernel(s) a call")
    rb, lb, cb = bench_torch._build(SCENE, W, H, device=dev)
    for i in range(2):
        wall, device_ms, launches, kernels_ = device_time(rb, lb, cb, 5)
        print(f"[profiler effect] profiled run {i + 1}: wall {wall:.2f} ms/frame, device kernel "
              f"time {device_ms:.2f} ms/frame, {launches:.0f} launches a frame, "
              f"{sum(e.count for e in kernels_) / 5:.0f} device kernels a frame")
        print(f"[profiler effect] K4 at the hero's AO site, the next 3 sessions: "
              f"{profiler_sessions(blur, 3)} kernel(s) a call")
    del rb, rh, wf, blur_args
    torch.cuda.empty_cache()

    runs = {False: [], True: []}
    for _ in range(pairs):
        for profiled in (False, True):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--frame-times",
                                   "profiled" if profiled else "plain"], cwd=ROOT,
                                  capture_output=True, text=True, timeout=300)
            check(proc.returncode == 0, f"--frame-times exited {proc.returncode}: "
                                        f"{proc.stderr[-2000:]}")
            ms = json.loads(proc.stdout.splitlines()[-1])["ms"]
            runs[profiled] += ms
            print(f"[profiler effect] fresh process, {'after' if profiled else 'without'} a "
                  f"profiled run: bench frame {', '.join(f'{m:.2f}' for m in ms)} ms/frame")
    for profiled, ms in runs.items():
        print(f"[profiler effect] {'after' if profiled else 'without'} a profiled run: median "
              f"{np.median(ms):.2f} ms/frame, min {min(ms):.2f}, max {max(ms):.2f} over "
              f"{len(ms)} readings in {pairs} processes")
    print("[profiler effect] bench_torch.py in a fresh process: headline %.3f, hero %.2f "
          "ms/frame" % bench_phase())


def shade_calls(r, light, camkw):
    """The direct_lighting calls of one hybrid frame (DDGI's probe hits,
    the reflection hits) and one 1-spp path-traced sample (its bounces),
    each as (site, args, kw)."""
    from hybrid_rendering_torch.config import PathTracerConfig
    from hybrid_rendering_torch.models import ddgi, path_tracer, reflections
    from hybrid_rendering_torch.ops import lighting

    calls = []

    def recording(site, fn):
        def run(*args, **kw):
            calls.append((site, args, kw))
            return fn(*args, **kw)
        return run

    saved = ddgi.direct_lighting, reflections.direct_lighting, lighting.direct_lighting
    ddgi.direct_lighting = recording("ddgi", saved[0])
    reflections.direct_lighting = recording("reflections", saved[1])
    lighting.direct_lighting = recording("pt", saved[2])
    try:
        cam = r.make_camera(camkw["eye"], camkw["target"], 0)
        r.render_frame(r.create_state(), cam, light)
        path_tracer.trace_sample(r.scene, r.closest_surface_fn, r.visibility_fn, cam, light,
                                 r.sky_radiance_fn, W, H, 0, PathTracerConfig(max_ray_bounces=3))
    finally:
        ddgi.direct_lighting, reflections.direct_lighting, lighting.direct_lighting = saved
    out, bounce = [], 0
    for site, a, k in calls:
        if site == "pt":
            site, bounce = f"pt bounce {bounce}", bounce + 1
        out.append((site, a, k))
    return out


def plain_direct_lighting(light, wo, n, p, f0, cd, rough, *, visibility_fn=None,
                          throughput=None, rng_shadow=None, rng_sky=None, sky_radiance_fn=None,
                          ray_origin_bias=0.1, valid=None):
    """direct_lighting's plain path on any device: its two plain stages
    around one visibility call (what CPU tensors run)."""
    from hybrid_rendering_torch.ops import lighting

    lead = tuple(p.shape[:-1])
    rng_sky = rng_sky if sky_radiance_fn is not None else None
    k = 1 if rng_sky is None else 2
    origin, direction, t_max, att = lighting.shade_rays_plain(light, p, n, rng_shadow, rng_sky,
                                                              valid, ray_origin_bias)
    vis = None if visibility_fn is None else visibility_fn(origin, direction, t_max)
    sky_li = None if k == 1 else sky_radiance_fn(direction.reshape((2,) + lead + (3,))[1])
    return lighting.shade_combine_plain(light, wo, n, f0, cd, rough, att, direction, vis,
                                        throughput, sky_li)


def k7_bytes(N, k, soft, valid, throughput, sky_given):
    """Bytes K7a and K7b must move for N points (each input read once,
    each output written once): K7a reads p, n and the rng pairs (and the
    mask) and writes k rays (origin, direction, t_max) and att; K7b reads
    wo, n, f0, c_diffuse, roughness, att, the k directions and
    visibilities (and the throughput, and a given sky radiance) and
    writes the radiance."""
    a = N * (24 + 8 * soft + 8 * (k == 2) + valid + 28 * k + 4)
    b = N * (52 + 4 + 12 * throughput + 12 * sky_given + 16 * k + 12)
    return a, b


def kernel_rows(fn):
    """Device kernels (name, count) that one call of fn() puts on the
    card, from a torch.profiler session (``device_time``'s reading)."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return Counter(e.name for e in prof.events()
                   if e.device_type == cuda and not e.name.startswith("hr::"))


def check_k7(site, args, kw, timing, fails):
    """K7 at one direct_lighting call of the frame: K7a's rays and att
    against shade_rays_plain bit for bit, K7b against shade_combine_plain
    (the sky evaluated in the kernel, and given) on the same rays and
    visibilities; the whole call on the card against the plain path; its
    synchronizing calls (none where the sky is a ProceduralSky or absent).
    With `timing`, K7a, K7b and the whole call timed beside the plain
    stages and the byte bound. Failures are appended to `fails`."""
    from hybrid_rendering_torch.ops import bvh, lighting, shade

    light, wo, n, p, f0, cd, rough = args
    vis_fn, tp, rs = kw.get("visibility_fn"), kw.get("throughput"), kw.get("rng_shadow")
    sky_fn, valid = kw.get("sky_radiance_fn"), kw.get("valid")
    rsky = kw.get("rng_sky") if sky_fn is not None else None
    bias = kw.get("ray_origin_bias", 0.1)
    lead, N = tuple(p.shape[:-1]), p.numel() // 3
    k = 1 if rsky is None else 2
    req = (k * lead[0],) + lead[1:]
    a_args = (light, p, n, rs, rsky, valid, bias)
    got_a = shade.shade_rays(*a_args)
    ref_a, plain_a_ms = wall_ms(lambda: lighting.shade_rays_plain(*a_args))
    a_same = True
    for name, g, w in zip(("origin", "direction", "t_max", "att"), got_a, ref_a):
        w = w.reshape(g.shape)
        if not bits_equal(g, w):
            a_same = False
            off = (g != w) & ~(torch.isnan(g) & torch.isnan(w))
            fails.append(f"K7a {site}: {name} differs from the plain stage at "
                         f"{int(off.sum())} of {g.numel()} values, max |d| "
                         f"{float((g - w)[off].abs().max())}")
    origin, direction, t_max, att = got_a
    live = int((t_max[:N] > 0).sum())
    vis = None if vis_fn is None else vis_fn(origin.reshape(req + (3,)),
                                             direction.reshape(req + (3,)), t_max.reshape(req))
    sky = None if k == 1 else shade.procedural_sky(sky_fn)
    sky_li = None if k == 1 else sky_fn(direction.reshape((2,) + lead + (3,))[1])
    b_args = (light, wo, n, f0, cd, rough, att, direction, vis, tp)
    ref_b, plain_b_ms = wall_ms(lambda: lighting.shade_combine_plain(
        light, wo, n, f0, cd, rough, att.reshape(lead), direction.reshape(req + (3,)), vis, tp,
        sky_li).reshape(N, 3))
    errs = {}
    for mode, (sk, li) in {"in the kernel": (sky, None), "given": (None, sky_li)}.items():
        if mode == "in the kernel" and sky is None and k == 2:
            continue
        got_b = shade.shade_combine(*b_args, sk, li)
        d = (got_b - ref_b).abs()
        d[torch.isnan(got_b) & torch.isnan(ref_b)] = 0.0
        errs[mode] = (float(d.max()), bits_equal(got_b, ref_b))
        if k == 1:
            break
    whole = lighting.direct_lighting(*args, **kw)
    ref = plain_direct_lighting(*args, **kw)
    d = (whole - ref).abs()
    d[torch.isnan(whole) & torch.isnan(ref)] = 0.0
    whole_err = float(d.max())
    waits = synchronizing_calls(lambda: lighting.direct_lighting(*args, **kw))
    plain_waits = synchronizing_calls(lambda: plain_direct_lighting(*args, **kw))
    if (k == 1 or sky is not None) and waits:
        fails.append(f"K7 {site}: {len(waits)} synchronizing calls in direct_lighting: {waits}")
    sky_label = "none" if k == 1 else ("ProceduralSky" if sky is not None
                                       else type(getattr(sky_fn, "__self__", sky_fn)).__name__)
    print(f"K7 {site}: {N} points, {k} ray(s) a point, {live} live shadow rays, sky {sky_label}, "
          f"throughput {tp is not None}, mask {valid is not None}: K7a rays and att "
          f"{'bit for bit' if a_same else 'DIFFER'}; "
          f"K7b " + ", ".join(f"sky {m}: max abs err {e:.3g}{' (bit for bit)' if same else ''}"
                              for m, (e, same) in errs.items())
          + f"; the whole call against the plain path: max abs err {whole_err:.3g}; "
          f"synchronizing calls {len(waits)} (plain path {len(plain_waits)})")
    err = max([e for e, _ in errs.values()] + [whole_err])
    if err > K7_TOL:
        fails.append(f"K7b {site}: max abs err {err} against the plain stages")
    if not timing:
        return err, None
    ab, bb = k7_bytes(N, k, rs is not None, valid is not None, tp is not None,
                      k == 2 and sky is None)
    bound_a, bound_b = bound(ab, 0), bound(bb, 0)
    ms_a, q_a = (cuda_ms(lambda: shade.shade_rays(*a_args), 20, queued=q) for q in (False, True))
    ms_b, q_b = (cuda_ms(lambda: shade.shade_combine(*b_args, sky, None if sky else sky_li), 20,
                         queued=q) for q in (False, True))
    ms_whole = cuda_ms(lambda: lighting.direct_lighting(*args, **kw), 10)
    _, plain_whole = wall_ms(lambda: plain_direct_lighting(*args, **kw))
    before = (shade.shade_rays.launches, shade.shade_combine.launches, bvh.visibility.launches)
    rows = kernel_rows(lambda: lighting.direct_lighting(*args, **kw))
    after = (shade.shade_rays.launches, shade.shade_combine.launches, bvh.visibility.launches)
    plain_rows = kernel_rows(lambda: plain_direct_lighting(*args, **kw))
    print(f"K7 {site}: K7a {ms_a:.4f} ms ({q_a:.4f} ms queued), bound {bound_a[0]:.4f} ms "
          f"({ab} bytes), share {bound_a[0] / ms_a:.1%} ({bound_a[0] / q_a:.1%} queued); "
          f"K7b {ms_b:.4f} ms ({q_b:.4f} ms queued), bound {bound_b[0]:.4f} ms ({bb} bytes), "
          f"share {bound_b[0] / ms_b:.1%} ({bound_b[0] / q_b:.1%} queued); plain stages "
          f"{plain_a_ms:.3f} + {plain_b_ms:.3f} ms; the whole call {ms_whole:.3f} ms (plain "
          f"path {plain_whole:.3f} ms); launches a call: K7a {after[0] - before[0]}, "
          f"K7b {after[1] - before[1]}, K2 {after[2] - before[2]}; device kernels a call "
          f"{sum(rows.values())} ({dict(rows)}), plain path {sum(plain_rows.values())}")
    ms, q = ms_a + ms_b, q_a + q_b
    return err, (ms, q, plain_a_ms + plain_b_ms, bound_a[0] + bound_b[0], "bytes",
                 sum(rows.values()), sum(plain_rows.values()))


def k7_edge_cases(dev, fails):
    """direct_lighting on the card against its plain path on the card, on
    inputs the frames do not give: point and spot lights, hard shadows,
    skies K7b does not evaluate (Preetham, constant: their radiance is
    given), masks, no throughput, no visibility, batches of 1, 31, 33 and
    4,099 points and an image-shaped batch. The visibility is a function
    of the ray alone (blocked heading down, or at t_max = 0). Returns the
    largest difference."""
    from hybrid_rendering_torch import types
    from hybrid_rendering_torch.ops import brdf, lighting
    from hybrid_rendering_torch.ops.sky import ConstantSky, PreethamSky, ProceduralSky

    lights = {"directional": types.Light.directional((0.35, 0.9, 0.25), radius=0.05),
              "point": types.Light.point((1.0, 6.0, -2.0), intensity=40.0, radius=0.3),
              "spot": types.Light.spot((0.0, 9.0, 0.0), (0.0, -1.0, 0.1), intensity=250.0,
                                       radius=0.3, inner_angle_deg=35.0, outer_angle_deg=55.0)}
    sun = np.asarray([0.3, 0.8, 0.2])
    skies = {"procedural": ProceduralSky.create(sun).to(dev),
             "preetham": PreethamSky.create(sun).to(dev),
             "constant": ConstantSky(torch.tensor([0.3, 0.5, 0.7], device=dev))}

    def vis(o, d, t_max):
        return torch.where((d[..., 1] > -0.2) & (t_max > 0.0), 1.0, 0.0)

    worst, cases = 0.0, 0
    rs = np.random.RandomState(7)
    for lead in ((1,), (31,), (33,), (4099,), (36, 64)):
        def arr(*shape, lo=0.0, hi=1.0):
            return torch.from_numpy(rs.uniform(lo, hi, lead + shape).astype(np.float32)).to(dev)
        p = arr(3, lo=-5.0, hi=5.0)
        n = torch.nn.functional.normalize(arr(3, lo=-1.0, hi=1.0), dim=-1)
        wo = torch.nn.functional.normalize(arr(3, lo=-1.0, hi=1.0), dim=-1)
        albedo, metal, rough = arr(3), arr(), arr(lo=0.05)
        f0 = brdf.f0_from_metallic(albedo, metal)
        tp, r_sh, r_sky = arr(3, hi=2.0), arr(2), arr(2)
        valid = arr() < 0.7
        for (lname, light), (sname, sky) in itertools.product(lights.items(), skies.items()):
            light = light.to(dev)
            for soft, mask, use_tp, use_vis in ((True, True, True, True),
                                                (False, False, False, True),
                                                (True, False, True, False)):
                kw = dict(visibility_fn=vis if use_vis else None,
                          throughput=tp if use_tp else None, rng_shadow=r_sh if soft else None,
                          rng_sky=r_sky, sky_radiance_fn=sky.radiance,
                          valid=valid if mask else None)
                args = (light, wo, n, p, f0, albedo, rough)
                got = lighting.direct_lighting(*args, **kw)
                ref = plain_direct_lighting(*args, **kw)
                if not bits_equal(got, ref):
                    d = float((got - ref).abs().max())
                    worst = max(worst, d)
                    if d > K7_TOL:
                        fails.append(f"K7 edge {lead} {lname} {sname} soft={soft} mask={mask} "
                                     f"throughput={use_tp} vis={use_vis}: max abs err {d}")
                cases += 1
    print(f"[edge] K7: {cases} cases (3 light types x 3 skies x soft/hard, masks, throughput, "
          f"no visibility; 1, 31, 33, 4,099 and 36x64 points): max abs err against the plain "
          f"path {worst:.3g}")
    return worst


def shade_subprocess():
    """shade_phase in a fresh process (``--shade-only``), its lines echoed:
    it counts the kernels a call puts on the card in short torch.profiler
    sessions, which in this process would come after other sessions and
    lose kernels, and would make profile_phase's lose them. Returns K7's
    row of the kernel table, its last line."""
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--shade-only"],
                          capture_output=True, text=True, timeout=900, cwd=ROOT)
    print("\n".join(l for l in proc.stdout.splitlines()
                    if l.startswith(("K7", "[edge] K7", "[waits]", "FAIL"))))
    check(proc.returncode == 0, f"chip_smoke.py --shade-only exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    return {k: tuple(v) for k, v in json.loads(proc.stdout.splitlines()[-1]).items()}


def shade_phase(dev):
    """K7 at its three sites (DDGI's probe hits, the reflection hits, the
    path tracer's bounces) of the bench frame (shadows_test) and the hero
    (sponza_scan), 1920x1080 (``check_k7``, the first bounce and both
    passes timed); its edge cases; and the synchronizing calls of one
    hybrid frame and one path-traced sample of each scene, by site.
    Returns {"K7": (max abs err, ms, plain_ms, bound_ms, bound_by)} of the
    bench frame's first bounce, for the kernel table."""
    from hybrid_rendering_torch.config import PathTracerConfig
    from hybrid_rendering_torch.models import path_tracer

    fails, timed, err = [], None, 0.0
    for scene in (SCENE, HERO_SCENE):
        r, light, camkw = bench_torch._build(scene, W, H, device=dev)
        for site, args, kw in shade_calls(r, light, camkw):
            e, t = check_k7(f"{scene} {site}", args, kw, site != "pt bounce 2", fails)
            err = max(err, e)
            if scene == SCENE and site == "pt bounce 0":
                timed = t
        cam = r.make_camera(camkw["eye"], camkw["target"], 0)
        state = r.create_state()
        r.render_frame(state, cam, light)
        frame = Counter(synchronizing_calls(lambda: r.render_frame(state, cam, light)))
        sample = Counter(synchronizing_calls(lambda: path_tracer.trace_sample(
            r.scene, r.closest_surface_fn, r.visibility_fn, cam, light, r.sky_radiance_fn, W, H,
            0, PathTracerConfig(max_ray_bounces=3))))
        print(f"[waits] {scene} hybrid frame: {sum(frame.values())} synchronizing calls "
              f"{dict(frame)}")
        print(f"[waits] {scene} path-traced sample: {sum(sample.values())} synchronizing calls "
              f"{dict(sample)}")
        del r
        torch.cuda.empty_cache()
    err = max(err, k7_edge_cases(dev, fails))
    for f in fails:
        print("FAIL " + f)
    check(not fails, f"K7: {len(fails)} check(s) failed")
    ms, q, plain_ms, bnd, by, _, _ = timed
    print(f"K7 bench frame, first bounce: K7a + K7b {ms:.4f} ms ({q:.4f} ms queued), bound "
          f"{bnd:.4f} ms, share {bnd / ms:.1%} ({bnd / q:.1%} queued)")
    return {"K7": (err, ms, plain_ms, bnd, by)}


# ---------------------------------------------------------------------------
# K8: the denoisers' temporal stage
# ---------------------------------------------------------------------------

TEMPORAL_WARM = 3  # frames rendered before the recorded one
TEMPORAL_SITES = ("shadows", "ao", "reflections")
TEMPORAL_EDGE_SIZES = ((37, 70), (9, 5), (1, 1), (8, 32), (67, 129))


def k8_bytes(site, n):
    """The bytes K8 must move for `n` pixels of `site`, each once: both
    frames' G-buffer planes (position, normal, mesh id, motion; the
    previous position, normal, mesh id: 64 bytes), the pass's own inputs
    and its outputs."""
    own = {"shadows": 20 + 20,  # history, moments, length, samples; vis., variance, moments, length
           "ao": 12 + 8,  # history, length, samples; AO, length
           "reflections": 44 + 28}  # ray length, curvature, history, moments, length, colour; outputs
    return n * (64 + own[site])


def temporal_modules():
    from hybrid_rendering_torch.models import ao, reflections, shadows

    return {"shadows": shadows, "ao": ao, "reflections": reflections}


def temporal_calls(r, light, camkw):
    """The arguments of the three temporal_accumulation calls of a frame
    of `r`: TEMPORAL_WARM frames with the eye sliding EYE_STEP along x a
    frame, then the next frame's calls, recorded. {site: (args, kw)}."""
    mods = temporal_modules()
    saved = {k: m.temporal_accumulation for k, m in mods.items()}
    recs = {k: recorder(fn) for k, fn in saved.items()}
    state, prev = r.create_state(), None
    for f in range(TEMPORAL_WARM + 1):
        eye = tuple(np.asarray(camkw["eye"]) + [EYE_STEP * f, 0.0, 0.0])
        cam = r.make_camera(eye, camkw["target"], f, prev_view_proj=prev)
        prev = cam.view_proj
        try:
            if f == TEMPORAL_WARM:
                for k, m in mods.items():
                    m.temporal_accumulation = recs[k]
            _, state = r.render_frame(state, cam, light)
        finally:
            for k, m in mods.items():
                m.temporal_accumulation = saved[k]
    return {k: rec.calls[0] for k, rec in recs.items()}


def check_k8(label, site, call, fails):
    """K8 at one temporal_accumulation call: every output against
    temporal_accumulation_plain on the same CUDA tensors bit for bit, one
    K8 launch and no synchronizing call a call, one kernel on the card;
    K8's ms one by one and queued beside its byte bound and the plain
    stage's ms. Failures are appended to `fails`. Returns (ms, queued ms,
    plain ms, bound ms)."""
    from hybrid_rendering_torch.ops import temporal

    mod = temporal_modules()[site]
    args, kw = call
    counter = getattr(temporal, site)
    before = counter.launches
    got = mod.temporal_accumulation(*args, **kw)
    launched = counter.launches - before
    ref, plain_ms = wall_ms(lambda: mod.temporal_accumulation_plain(*args, **kw))
    same = True
    for i, (g, w) in enumerate(zip(got, ref)):
        if not bits_equal(g, w):
            same = False
            off = (g != w) & ~(torch.isnan(g) & torch.isnan(w))
            d = float((g - w)[off].abs().max()) if bool(off.any()) else 0.0
            fails.append(f"K8 {label} {site}: output {i} differs from the plain stage at "
                         f"{int(off.sum())} of {g.numel()} values, max |d| {d}")
    if launched != 1:
        fails.append(f"K8 {label} {site}: {launched} launches a call")
    waits = synchronizing_calls(lambda: mod.temporal_accumulation(*args, **kw))
    if waits:
        fails.append(f"K8 {label} {site}: {len(waits)} synchronizing calls: {waits}")
    gb = args[2] if site == "reflections" else args[1]
    n = gb.depth.numel()
    print(f"K8 {label} {site}: {tuple(gb.depth.shape)} pixels, {len(got)} outputs "
          f"{'bit for bit' if same else 'DIFFER'} against the plain stage; launches a call "
          f"{launched}; synchronizing calls {len(waits)}")
    ms, q = (cuda_ms(lambda: mod.temporal_accumulation(*args, **kw), 20, queued=qq)
             for qq in (False, True))
    nbytes = k8_bytes(site, n)
    bnd = bound(nbytes, 0)[0]
    rows = kernel_rows(lambda: mod.temporal_accumulation(*args, **kw))
    plain_rows = kernel_rows(lambda: mod.temporal_accumulation_plain(*args, **kw))
    if sum(rows.values()) != 1:
        fails.append(f"K8 {label} {site}: {dict(rows)} kernels on the card a call")
    print(f"K8 {label} {site}: {ms:.4f} ms ({q:.4f} ms queued), bound {bnd:.4f} ms "
          f"({nbytes} bytes), share {bnd / ms:.1%} ({bnd / q:.1%} queued); plain stage "
          f"{plain_ms:.3f} ms; device kernels a call {sum(rows.values())} ({dict(rows)}), "
          f"plain stage {sum(plain_rows.values())}")
    return ms, q, plain_ms, bnd


def k8_edge_cases(dev, fails):
    """K8 against the plain stage on the card on the frames of
    tests/test_torch_temporal.py (every branch of the reprojection; tiles
    cut by the frame, frames smaller than a tile or the box's halo), at
    TEMPORAL_EDGE_SIZES, two seeds, the camera still, at the cap's
    threshold and moving."""
    import importlib.util

    # by its path: a package named "tests" may be installed
    spec = importlib.util.spec_from_file_location(
        "test_torch_temporal", os.path.join(ROOT, "tests", "test_torch_temporal.py"))
    frames = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(frames)
    frame_inputs, site_calls = frames.frame_inputs, frames.site_calls
    cases = 0
    for (h, w), seed, delta in itertools.product(TEMPORAL_EDGE_SIZES, (3, 11),
                                                 (0.0, 1e-5, 0.3)):
        calls = site_calls(frame_inputs(h, w, seed, delta, device=dev))
        for site in TEMPORAL_SITES:
            mod = temporal_modules()[site]
            got = mod.temporal_accumulation(*calls[site])
            ref = mod.temporal_accumulation_plain(*calls[site])
            for i, (g, r) in enumerate(zip(got, ref)):
                if not bits_equal(g, r):
                    fails.append(f"K8 edge {site} {h}x{w} seed {seed} camera_delta {delta}: "
                                 f"output {i} differs at {int((g != r).sum())} values")
            cases += 1
    print(f"[edge] K8: {cases} cases (3 sites x {len(TEMPORAL_EDGE_SIZES)} sizes x 2 seeds x "
          f"3 camera moves)")


def temporal_subprocess():
    """temporal_phase in a fresh process (``--temporal-only``), its lines
    echoed (it counts kernels in short torch.profiler sessions, as
    shade_subprocess does). Returns K8's row of the kernel table, its last
    line."""
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--temporal-only"],
                          capture_output=True, text=True, timeout=900, cwd=ROOT)
    print("\n".join(l for l in proc.stdout.splitlines()
                    if l.startswith(("K8", "[edge] K8", "FAIL"))))
    check(proc.returncode == 0, f"chip_smoke.py --temporal-only exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    return {k: tuple(v) for k, v in json.loads(proc.stdout.splitlines()[-1]).items()}


def temporal_phase(dev):
    """K8 at the three temporal stages of a frame of the bench scene
    (shadows_test) and the hero (sponza_scan), 1920x1080 (``check_k8``,
    each timed), and its edge cases. Returns {"K8": (max abs err, ms,
    plain_ms, bound_ms, bound_by)}, the bench frame's three sites summed,
    for the kernel table."""
    fails, timed = [], {}
    for scene in (SCENE, HERO_SCENE):
        r, light, camkw = bench_torch._build(scene, W, H, device=dev)
        calls = temporal_calls(r, light, camkw)
        for site in TEMPORAL_SITES:
            t = check_k8(scene, site, calls[site], fails)
            if scene == SCENE:
                timed[site] = t
        del r, calls
        torch.cuda.empty_cache()
    k8_edge_cases(dev, fails)
    for f in fails:
        print("FAIL " + f)
    check(not fails, f"K8: {len(fails)} check(s) failed")
    ms, q, plain_ms, bnd = (sum(t[i] for t in timed.values()) for i in range(4))
    print(f"K8 bench frame, three sites: {ms:.4f} ms ({q:.4f} ms queued), bound {bnd:.4f} ms, "
          f"share {bnd / ms:.1%} ({bnd / q:.1%} queued); plain stages {plain_ms:.3f} ms")
    return {"K8": (0.0, ms, plain_ms, bnd, "bytes")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on a GPU",
              file=sys.stderr)
        return 1
    from hybrid_rendering_torch.ops import (
        bvh, ddgi_sample, flashtrace, kernels, shade, stencil, temporal)
    from hybrid_rendering_torch.scene import native

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"tf32 before: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; both set False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"BVH builder: {native.builder_name()}")

    t0 = time.perf_counter()
    keep = 0
    log = kernels.build(verbose=True)
    kernels.lib()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s ({kernels.LIB_PATH})")
    for line in log.splitlines():
        # registers, shared memory and spills of K1-K6′
        if "Compiling" in line and any(k in line for k in PTXAS_KERNELS):
            keep = 2
            print("  " + line.strip()[:160])
        elif keep and ("registers" in line or "spill" in line):
            keep -= 1
            print("    " + line.strip())

    if "--frame-times" in sys.argv[1:]:
        # one process of profiler_effect's comparison
        frame_times(dev, sys.argv[-1] == "profiled")
        return 0
    if "--profiler-effect" in sys.argv[1:]:
        # the frames timed before and after torch.profiler sessions, and
        # in a fresh process; prints no result line
        profiler_effect(dev)
        return 0
    if "--dense-only" in sys.argv[1:]:
        # the K6/K6′ checks, edge cases and times alone: a short call for
        # work on the dense kernels; prints no result line
        dense_phase(dev)
        return 0
    if "--shade-only" in sys.argv[1:]:
        # the K7 checks, edge cases, times and waits alone: a short call
        # for work on the direct light, and the full run's shade phase;
        # prints no result line, its last line K7's row of the kernel table
        print(json.dumps(shade_phase(dev)))
        return 0
    if "--temporal-only" in sys.argv[1:]:
        # the K8 checks, edge cases and times alone: a short call for work
        # on the denoisers' temporal stage, and the full run's K8 phase;
        # prints no result line, its last line K8's row of the kernel table
        print(json.dumps(temporal_phase(dev)))
        return 0
    counters = {"K1": (bvh.closest_hit_attrs,), "K2": (bvh.visibility,),
                "K3": (stencil.atrous_chain,), "K4": (stencil.bilateral_blur,),
                "K5": (ddgi_sample.sample_irradiance,),
                "K6": (flashtrace.flash_closest_hit, flashtrace.flash_closest_hit_attrs),
                "K6′": (flashtrace.flash_visibility,),
                "K7": (shade.shade_rays, shade.shade_combine),
                "K8": (temporal.shadows, temporal.ao, temporal.reflections)}
    card = smi.stdout.strip().splitlines()[0]
    if "--apps-only" in sys.argv[1:]:
        # render_torch.py and viewer_torch.py alone: a short call for work
        # on the apps; prints no result line
        apps_phase(dev, counters, card)
        return 0
    if "--parallel-only" in sys.argv[1:]:
        # parallel_phase alone: a short call for work on the multi-device
        # path; prints no result line
        parallel_phase(dev, counters)
        return 0
    if "--scenes-only" in sys.argv[1:]:
        # textured_phase and dynamic_phase alone: a short call for work on
        # textures, loaders and dynamic scenes; prints no result line
        textured_phase(dev, counters)
        dynamic_phase(dev, counters)
        return 0
    t = lap("build", t0)
    timed = kernel_phase(dev)
    t = lap("kernel_phase", t)
    if "--kernels-only" in sys.argv[1:]:
        # the K1-K6′ checks, edge cases and times, then stop: a short call
        # for work on a kernel; prints no result line
        dense_phase(dev)
        return 0
    _, launches = slice_phase(dev, counters)
    t = lap("slice_phase", t)
    _, dense_launches = dense_slice_phase(dev, counters)
    launches.update({k: dense_launches[k] for k in ("K6", "K6′")})
    t = lap("dense_slice_phase", t)
    small_phase(dev)
    t = lap("small_phase", t)
    textured_phase(dev, counters)
    t = lap("textured_phase", t)
    hero = hero_phase(dev, counters)
    t = lap("hero_phase", t)
    dynamic_phase(dev, counters, hero)
    del hero
    t = lap("dynamic_phase", t)
    fidelity_phase(dev, counters)
    t = lap("fidelity_phase", t)
    timed.update(dense_phase(dev))
    t = lap("dense_phase", t)
    parallel_phase(dev, counters)
    t = lap("parallel_phase", t)
    apps_phase(dev, counters, card)
    t = lap("apps_phase", t)
    # torch.profiler from here on: a session slows every frame timed after
    # it in the process, so the frames above are timed before the first
    timed.update(shade_subprocess())
    t = lap("shade_phase", t)
    timed.update(temporal_subprocess())
    t = lap("temporal_phase", t)
    profile_phase(dev, launches["K4"] / (TIMED_FRAMES + 1))
    t = lap("profile_phase", t)
    bench_phase()
    lap("bench_phase", t)

    meta = {
        "K1": ("trace.cu", "hybrid_rendering_tpu/ops/pallas/flashtrace.py:1358"),
        "K2": ("trace.cu", "hybrid_rendering_tpu/ops/pallas/flashtrace.py:1312"),
        "K3": ("stencil.cu", "hybrid_rendering_tpu/ops/pallas/stencil.py:162"),
        "K4": ("stencil.cu", "hybrid_rendering_tpu/ops/pallas/stencil.py:337"),
        "K5": ("ddgi_sample.cu", "hybrid_rendering_tpu/ops/pallas/ddgi_sample.py:537"),
        "K6": ("flashtrace.cu", "hybrid_rendering_tpu/ops/pallas/flashtrace.py:411"),
        "K6′": ("flashtrace.cu", "hybrid_rendering_tpu/ops/pallas/flashtrace.py:1742"),
        "K7": ("shade.cu", None),  # no TPU kernel: XLA fuses the JAX package's direct light
        "K8": ("temporal.cu", None),  # no TPU kernel: XLA fuses the temporal stage
    }
    # no single PyTorch call computes any of these functions: library_ms
    # is null for every row
    table = [dict(name=k, route="cuda", source=f"hybrid_rendering_torch/csrc/{src}",
                  replaces=rep, launches=launches[k], max_abs_err=timed[k][0],
                  ms=timed[k][1], plain_ms=timed[k][2], bound_ms=timed[k][3],
                  bound_by=timed[k][4], library_ms=None)
             for k, (src, rep) in meta.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
