"""Hybrid frames: ``HybridRenderer.render_frame`` with the render state
threaded from frame to frame, the camera moving along the configuration's
path by the mix's ``path_seconds_per_frame`` of path time a frame (the
viewer's demo player), from the start the seed draws.

The check renders each checked frame k with the plain reference from the
program's state after frame k-1 (frame 0 from the reference's own empty
state) and holds the program's state after frame k, layer by layer, and
its LDR frame to the reference's."""
from __future__ import annotations

import dataclasses
from typing import Dict

from hrbench import compare, program, settings

# module functions of ``hybrid_rendering_torch.models`` the traced run
# puts a range around: (module, function)
PASSES = (("gbuffer", "render_gbuffer"), ("shadows", "shadows_pass"), ("ao", "ao_pass"),
          ("ddgi", "ddgi_update"), ("ddgi", "sample_probe_grid_screen"),
          ("reflections", "reflections_pass"), ("deferred", "deferred_shading"),
          ("taa", "taa_resolve"), ("tonemap", "tonemap"))
# the numbers compared: the state after the frame by layer, and the frame
GROUPS = ("gbuffer", "shadows", "ao", "ddgi", "reflections", "taa", "ldr")
# G-buffer planes the control rounds: the surface's attributes; position,
# depths and ids stay exact, since rays start from them
GBUFFER_ROUNDED = ("albedo", "metallic", "normal", "roughness", "curvature", "motion")


def time_of(mix: dict, start: float, duration: float, i: int):
    """(path time, restart) of frame i: the camera never holds still."""
    return start + i * float(mix["path_seconds_per_frame"]), False


class Frames:
    """The program's frames. A frame's camera carries the previous
    frame's view-projection (motion vectors) and the TAA jitter of its
    index."""

    def __init__(self, prog: program.Program, mix: dict):
        self.prog = prog
        self.state = prog.renderer.create_state()
        self.prev_view_proj = None

    def step(self, i: int, eye, target, restart: bool, keep: bool):
        """Frame i; with `keep`, returns copies of (the state before it,
        the state after it, its outputs) for the check."""
        r = self.prog.renderer
        cam = r.make_camera(eye, target, i, prev_view_proj=self.prev_view_proj)
        self.prev_view_proj = cam.view_proj
        before = program.snapshot(self.state) if keep else None
        outputs, self.state = r.render_frame(self.state, cam, self.prog.light)
        if keep:
            return before, program.snapshot(self.state), {"ldr": outputs["ldr"].clone()}
        return None


def _gbuffer_bf16(gb):
    return dataclasses.replace(gb, **{f: compare.bf16(getattr(gb, f)) for f in GBUFFER_ROUNDED})


class Reference:
    """The plain reference's renderer of the configuration."""

    def __init__(self, cfg: dict, schedule, device):
        from hrref import config as config_mod
        from hrref.models.renderer import HybridRenderer
        from hrref.ops import sh as sh_mod
        from hrref.ops import sky as sky_mod
        from hrref.scene.scenes import load_scene

        self.device = device
        self.rc = settings.renderer_config(config_mod, cfg)
        scene, light, _ = load_scene(cfg["scene"])
        self.light = light.to(device)
        sky, irr, pref = settings.sky_and_env(sky_mod, sh_mod, light, device)
        self.renderer = HybridRenderer(scene, self.rc, sky, irr, pref, device=device)

    def _camera(self, schedule, k):
        r = self.renderer
        prev = None
        if k > 0:
            eye, target, _ = schedule.frame(k - 1)
            prev = r.make_camera(eye, target, k - 1).view_proj
        eye, target, _ = schedule.frame(k)
        return r.make_camera(eye, target, k, prev_view_proj=prev)

    def frame(self, schedule, k, before, control=False):
        """(state after frame k, outputs): from the program's state before
        it, read field by field into the reference's own; frame 0 from
        the reference's own empty state."""
        r = self.renderer
        r.round_planes = compare.bf16 if control else (lambda x: x)
        state = r.create_state()
        if k > 0:
            state = compare.as_reference(state, before)
        if control:
            state = dataclasses.replace(state, prev_gbuffer=_gbuffer_bf16(state.prev_gbuffer))
        outputs, state = r.render_frame(state, self._camera(schedule, k), self.light)
        if control:
            state.prev_gbuffer = _gbuffer_bf16(state.prev_gbuffer)
        return state, outputs

    def check(self, schedule, k, kept, control=False) -> Dict[str, float]:
        before, after, outputs = kept
        state, ref_out = self.frame(schedule, k, before)
        if control:
            # the control's frame in the program's place
            after, outputs = self.frame(schedule, k, before, control=True)
        return {
            "gbuffer": compare.off_share(after.prev_gbuffer, state.prev_gbuffer),
            "shadows": compare.off_share(after.shadows, state.shadows),
            "ao": compare.off_share(after.ao, state.ao),
            "ddgi": compare.off_share(after.ddgi, state.ddgi),
            "reflections": compare.off_share(after.reflections, state.reflections),
            "taa": compare.off_share(after.taa, state.taa),
            "ldr": compare.off_share(outputs["ldr"], ref_out["ldr"]),
        }
