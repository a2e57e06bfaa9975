"""Building one side of the comparison from a configuration file: the
renderer settings as data, applied to a package's own ``RendererConfig``.

The same function builds the program (``hybrid_rendering_torch``) and the
plain reference (``hrref``): each is handed its package's ``config``
module, and each derives everything else (tree, probe grid, samplers,
environment) itself."""
from __future__ import annotations

import dataclasses

PASS_SECTIONS = ("shadows", "ao", "reflections", "ddgi", "taa")


def renderer_config(config_mod, cfg: dict):
    """The configuration file's settings over `config_mod`'s defaults."""
    rc = config_mod.RendererConfig(width=int(cfg["width"]), height=int(cfg["height"]))
    over = {}
    for section in PASS_SECTIONS:
        kw = dict(cfg.get(section, {}))
        if "scale" in kw:
            kw["scale"] = config_mod.RayTraceScale(int(kw["scale"]))
        over[section] = dataclasses.replace(getattr(rc, section), **kw)
    over["path_tracer"] = dataclasses.replace(rc.path_tracer, **cfg.get("path_tracer", {}))
    return rc.replace(**over)


def sky_and_env(sky_mod, sh_mod, light, device):
    """The procedural sky of the light's sun and its SH fallbacks, on
    `device`: (sky radiance fn, env irradiance fn, env prefiltered fn)."""
    sky = sky_mod.ProceduralSky.create(light.direction.cpu().numpy()).to(device)
    irr_fn, pref_fn = sh_mod.make_env_fallbacks(sky.radiance, device=device)
    return sky.radiance, irr_fn, pref_fn
