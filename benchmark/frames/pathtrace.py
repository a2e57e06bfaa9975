"""Path-traced frames, the ground-truth mode: one 1-spp
``path_tracer.trace_sample`` a frame through the renderer's own tracers,
accumulated as ``render_progressive`` does, then tone-mapped. The camera
holds still for the mix's ``samples_per_view`` samples at each of its
``viewpoints`` points, spaced evenly over the path from the start the seed
draws, and the accumulation restarts at each; every seed so visits the
same spread of views, in another phase.

The check traces the mix's ``check_pixels`` pixels, drawn from the seed,
with the plain reference by brute force (a pixel's paths do not depend
on the others'), accumulates them over the program's accumulation before
the frame and holds the program's sample, accumulation and LDR frame at
those pixels to its own."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hrbench import compare, program, settings

PASSES = (("path_tracer", "trace_sample"), ("path_tracer", "accumulate"),
          ("tonemap", "tonemap"))
GROUPS = ("sample", "accum", "ldr")


def time_of(mix: dict, start: float, duration: float, i: int):
    """(path time, restart) of frame i."""
    per_view, views = int(mix["samples_per_view"]), int(mix["viewpoints"])
    view = i // per_view
    return start + (view % views) * duration / views, i % per_view == 0


class Frames:
    """The program's frames."""

    def __init__(self, prog: program.Program, mix: dict):
        from hybrid_rendering_torch.models import path_tracer

        self.prog = prog
        rc = prog.config
        self.state = path_tracer.GroundTruthState.create(rc.height, rc.width, prog.device)
        self.camera = None

    def step(self, i: int, eye, target, restart: bool, keep: bool):
        """Frame i; with `keep`, returns copies of (the accumulation before
        it, the accumulation after it, its sample and LDR frame)."""
        from hybrid_rendering_torch.models import path_tracer, tonemap
        from hybrid_rendering_torch.utils import camera as camera_utils

        r, rc = self.prog.renderer, self.prog.config
        if restart or self.camera is None:
            # the camera holds still between restarts, as in the viewer
            self.state = self.state.restart()
            self.camera = camera_utils.make_camera(eye=eye, target=target, width=rc.width,
                                                   height=rc.height, device=self.prog.device)
        before = program.snapshot(self.state) if keep else None
        sample = path_tracer.trace_sample(
            r.scene, r.closest_surface_fn, r.visibility_fn, self.camera, self.prog.light,
            r.sky_radiance_fn, rc.width, rc.height, self.state.num_frames, rc.path_tracer)
        self.state = path_tracer.accumulate(self.state, sample)
        ldr = tonemap.tonemap(self.state.color, rc.tonemap)
        if keep:
            return before, program.snapshot(self.state), {"sample": sample.clone(),
                                                          "ldr": ldr.clone()}
        return None


class Reference:
    """The plain reference's path tracer over brute-force tracers, with
    no tree, at the checked pixels."""

    def __init__(self, cfg: dict, schedule, device):
        from hrref import config as config_mod
        from hrref.ops import brute
        from hrref.ops import sh as sh_mod
        from hrref.ops import sky as sky_mod
        from hrref.scene.scenes import load_scene

        self.device = device
        self.rc = rc = settings.renderer_config(config_mod, cfg)
        scene, light, _ = load_scene(cfg["scene"])
        self.light = light.to(device)
        self.scene = scene.to(device)
        self.sky_radiance_fn, _, _ = settings.sky_and_env(sky_mod, sh_mod, light, device)
        self.closest_surface_fn, self.visibility_fn = brute.make_tracers(self.scene)
        n = min(int(schedule.mix["check_pixels"]), rc.width * rc.height)
        idx = np.sort(schedule.rng.choice(rc.width * rc.height, size=n, replace=False))
        self.pixels = torch.as_tensor(idx, dtype=torch.int64, device=device)

    def sample(self, schedule, k, before_color, nf, control=False):
        """The reference's sample k at the checked pixels, and the
        accumulation and tone map of it over the program's previous
        accumulation."""
        from hrref.models import path_tracer, tonemap
        from hrref.utils import camera as camera_utils

        rc, px = self.rc, self.pixels
        per_view = int(schedule.mix["samples_per_view"])
        eye, target, _ = schedule.frame(k - k % per_view)
        cam = camera_utils.make_camera(eye=eye, target=target, width=rc.width,
                                       height=rc.height, device=self.device)
        q = compare.bf16 if control else None
        fi = torch.tensor(nf, dtype=torch.int32, device=self.device)
        sample = path_tracer.trace_pixels(
            self.scene, self.closest_surface_fn, self.visibility_fn, cam, self.light,
            self.sky_radiance_fn, rc.width, rc.height, fi, px, rc.path_tracer, q)
        prev = before_color.to(self.device).reshape(-1, 3)[px]
        st = path_tracer.accumulate(path_tracer.GroundTruthState(color=prev, num_frames=fi),
                                    sample)
        color = compare.bf16(st.color) if control else st.color
        ldr = tonemap.tonemap(color, rc.tonemap)
        return sample, color, (compare.bf16(ldr) if control else ldr)

    def check(self, schedule, k, kept, control=False) -> Dict[str, float]:
        before, after, outputs = kept
        nf = int(before.num_frames)
        sample, color, ldr = self.sample(schedule, k, before.color, nf)
        if control:
            got = self.sample(schedule, k, before.color, nf, control=True)
        else:
            px = self.pixels.to(after.color.device)
            got = (outputs["sample"].reshape(-1, 3)[px], after.color.reshape(-1, 3)[px],
                   outputs["ldr"].reshape(-1, 3)[px])
        return {"sample": compare.off_share(got[0], sample),
                "accum": compare.off_share(got[1], color),
                "ldr": compare.off_share(got[2], ldr)}
