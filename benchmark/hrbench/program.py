"""The system under test: ``hybrid_rendering_torch``, built through its
public API from a configuration file.

Nothing here imports the JAX package. Every tensor lives on the device
the run names."""
from __future__ import annotations

import copy
import dataclasses
import time

import torch

from hrbench import settings


@dataclasses.dataclass
class Program:
    renderer: object  # hybrid_rendering_torch.models.renderer.HybridRenderer
    light: object
    config: object  # its RendererConfig
    device: torch.device


def load_native() -> float:
    """Loads the port's CUDA kernels and its native BVH builder, building
    them first where the checkout has no build yet; returns the seconds
    it took."""
    t0 = time.perf_counter()
    from hybrid_rendering_torch.ops import kernels
    from hybrid_rendering_torch.scene import native

    kernels.lib()
    native.get_lib()
    return time.perf_counter() - t0


def build(cfg: dict, device) -> Program:
    """The port's renderer for a configuration: its scene (``load_scene``,
    which builds the port's own tree), the settings of the file, the
    procedural sky of the scene's light and its SH fallbacks."""
    from hybrid_rendering_torch import config as config_mod
    from hybrid_rendering_torch.models.renderer import HybridRenderer
    from hybrid_rendering_torch.ops import sh as sh_mod
    from hybrid_rendering_torch.ops import sky as sky_mod
    from hybrid_rendering_torch.scene.scenes import load_scene

    rc = settings.renderer_config(config_mod, cfg)
    scene, light, _ = load_scene(cfg["scene"])
    device = torch.device(device)
    sky, irr, pref = settings.sky_and_env(sky_mod, sh_mod, light, device)
    r = HybridRenderer(scene, rc, sky, irr, pref, device=device,
                       tracer_method=cfg["tracer_method"])
    return Program(renderer=r, light=light.to(device), config=rc, device=device)


def snapshot(x):
    """A copy of `x` (a tensor, or a dataclass of them, nested) whose
    tensors are clones: what a checked frame read or made, kept as it was
    whatever the program later does in place. The clones are queued on
    the card in stream order, behind the frames before them. The
    program's classes are copied without calling them."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = copy.copy(x)
        for f in dataclasses.fields(x):
            object.__setattr__(out, f.name, snapshot(getattr(x, f.name)))
        return out
    return x
