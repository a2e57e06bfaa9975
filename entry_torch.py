#!/usr/bin/env python3
"""Entry points of the PyTorch port (the counterpart of
``__graft_entry__.py``).

    python3 entry_torch.py                        (one tiny hybrid frame)
    python3 entry_torch.py --dryrun N [--device cpu]

``entry(device=None) -> (fn, example_args)``: one step of the flagship
model, the full hybrid frame (G-buffer, shadows, AO, DDGI, reflections,
deferred, TAA, tone map) at 64x64 on a tiny scene; ``fn(state)`` returns
(LDR frame, state).

``dryrun_multichip(n_devices, device=None)``: the multi-device path on
tiny shapes over an `n_devices` mesh: the full hybrid frame with its
tracers sharded over the mesh (``HybridRenderer(mesh=)``, the BVH walk
``"flash"``), one sharded GT path-tracer step, and the sharded closest-hit
and visibility tracers on 8n + 3 rays (the pad path) against the
unsharded ones. The mesh is every card, repeated in turn up to n shards
(one card: n shards on ``cuda:0``), or n shards on `device` where given
(``"cpu"``: the plain versions). Without a card and without a device it
raises: the card is never silently replaced by the CPU.
"""
from __future__ import annotations

import argparse
import sys


def _tiny_setup(width: int, height: int, device=None):
    """(scene, light, sky, camera, PathTracerConfig) of the tiny scene: a
    ground plane, a red box and a sphere, on `device`."""
    from hybrid_rendering_torch.config import PathTracerConfig
    from hybrid_rendering_torch.ops.sky import ProceduralSky
    from hybrid_rendering_torch.scene import primitives as prim
    from hybrid_rendering_torch.scene.build import MaterialDef, SceneBuilder, translation
    from hybrid_rendering_torch.types import Light
    from hybrid_rendering_torch.utils import camera as cam_utils

    b = SceneBuilder()
    ground = b.add_material(MaterialDef(albedo=(0.8, 0.8, 0.8), roughness=0.9))
    red = b.add_material(MaterialDef(albedo=(0.8, 0.2, 0.2), roughness=0.4))
    b.add_instance(prim.plane(20.0, 20.0), ground)
    b.add_instance(prim.box(1.0, 1.0, 1.0), red, translation(0, 0.5, 0))
    b.add_instance(prim.uv_sphere(0.6, 8, 12), ground, translation(1.5, 0.6, 0.5))
    scene = b.build(use_bvh=True).to(device)
    light = Light.directional(direction=(0.3, 0.9, 0.2), intensity=5.0, radius=0.05).to(device)
    sky = ProceduralSky.create(sun_direction=(0.3, 0.9, 0.2)).to(device)
    cam = cam_utils.make_camera(eye=(4.0, 3.0, 6.0), target=(0.0, 0.5, 0.0), width=width,
                                height=height, device=device)
    return scene, light, sky, cam, PathTracerConfig(max_ray_bounces=2)


def _tiny_config(width: int, height: int):
    from hybrid_rendering_torch.config import (
        AOConfig, DDGIConfig, RayTraceScale, ReflectionsConfig, RendererConfig, ShadowsConfig,
        TAAConfig)

    return RendererConfig(
        width=width, height=height,
        shadows=ShadowsConfig(atrous_iterations=2),
        ao=AOConfig(scale=RayTraceScale.HALF),
        reflections=ReflectionsConfig(scale=RayTraceScale.HALF),
        ddgi=DDGIConfig(probe_distance=4.0, rays_per_probe=32, scale=RayTraceScale.HALF),
        taa=TAAConfig(enabled=True),
    )


def _device(device):
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device=\"cpu\" for the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def entry(device=None):
    """(fn, example_args): one step of the full hybrid frame at 64x64 on
    the card (or on `device`); ``fn(state) -> (ldr, state)``."""
    from hybrid_rendering_torch.models.renderer import HybridRenderer

    width = height = 64
    dev = _device(device)
    scene, light, sky, _, _ = _tiny_setup(width, height, dev)
    r = HybridRenderer(scene, _tiny_config(width, height), sky.radiance, device=dev)
    camera = r.make_camera((4.0, 3.0, 6.0), (0.0, 0.5, 0.0), 0)

    def fn(state):
        outputs, new_state = r.render_frame(state, camera, light)
        return outputs["ldr"], new_state

    return fn, (r.create_state(),)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the multi-device path once on tiny shapes over an
    `n_devices`-shard mesh (see the module's docstring); raises on any
    disagreement. Returns the figures it prints."""
    import numpy as np
    import torch

    from hybrid_rendering_torch.models import path_tracer
    from hybrid_rendering_torch.models.renderer import HybridRenderer
    from hybrid_rendering_torch.ops import bvh
    from hybrid_rendering_torch.parallel import mesh as mesh_mod
    from hybrid_rendering_torch.parallel.render import path_trace_frame_sharded
    from hybrid_rendering_torch.parallel.sharding import frame_shardings, shard_frame_state
    from hybrid_rendering_torch.parallel.trace import replicate, shard_renderer_tracers

    n = int(n_devices)
    if device is None:
        _device(None)  # raises without a card
        cards = torch.cuda.device_count()
        mesh = mesh_mod.make_mesh(devices=[torch.device("cuda", i % cards) for i in range(n)])
    else:
        mesh = mesh_mod.make_mesh(devices=[device] * n)
    dev = mesh.devices[0]
    width, height = 64, 8 * n
    scene, light, sky, _, _ = _tiny_setup(width, height, dev)

    # the full hybrid frame, its tracers sharded over the mesh
    r = HybridRenderer(scene, _tiny_config(width, height), sky.radiance,
                       tracer_method="flash", mesh=mesh)
    state = shard_frame_state(r.create_state(), mesh, height)
    cam = r.make_camera((4.0, 3.0, 6.0), (0.0, 0.5, 0.0), 0)
    outputs, state = r.render_frame(state, cam, light)
    ldr = outputs["ldr"]
    if tuple(ldr.shape) != (height, width, 3) or not bool(torch.isfinite(ldr).all()):
        raise RuntimeError(f"dryrun_multichip({n}): the hybrid frame is not a finite "
                           f"{height}x{width} image")
    if frame_shardings(outputs, mesh, height)["ldr"].spec != (mesh_mod.TILE_AXIS,):
        raise RuntimeError(f"dryrun_multichip({n}): the LDR frame's layout is not row-sharded")

    # the GT path tracer, a row block a shard
    gt_step = path_trace_frame_sharded(mesh, r.scene, cam, light, sky, width, height)
    gt = gt_step(path_tracer.GroundTruthState.create(height, width, dev))
    if not bool(torch.isfinite(gt.color).all()):
        raise RuntimeError(f"dryrun_multichip({n}): the sharded GT is not finite")

    # the tracers alone on 8n + 3 rays (not a multiple of n: the pad path)
    accel = bvh.make_accel(r.scene, "flash")
    closest, vis = bvh.make_tracers(r.scene, accel, "flash")
    surface = bvh.make_surface_tracer(r.scene, accel, "flash")
    s_closest, s_vis, _ = shard_renderer_tracers(
        mesh, closest, vis, surface, replicate(mesh, r.scene, accel), "flash")
    n_rays = 8 * n + 3
    th = torch.linspace(0.0, 2.0 * np.pi, n_rays, device=dev)
    o = torch.stack([4.0 * torch.cos(th), torch.full_like(th, 2.0), 4.0 * torch.sin(th)], 1)
    d = torch.stack([-torch.cos(th), torch.full_like(th, -0.3), -torch.sin(th)], 1)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    hit, ref = s_closest(o, d, 100.0), closest(o, d, 100.0)
    if not torch.equal(hit.tri_id, ref.tri_id):
        raise RuntimeError(f"dryrun_multichip({n}): sharded closest hit disagrees with unsharded")
    v = s_vis(o, d, 100.0)
    if not (bool(torch.isfinite(v).all()) and torch.equal(v, vis(o, d, 100.0))):
        raise RuntimeError(f"dryrun_multichip({n}): sharded visibility disagrees with unsharded")

    figures = dict(devices=[str(x) for x in mesh.devices], ldr_mean=ldr.mean().item(),
                   gt_mean=gt.color.mean().item(), hits=int((hit.tri_id >= 0).sum()),
                   rays=n_rays)
    print(f"dryrun_multichip({n}) OK on {figures['devices']}: hybrid ldr mean "
          f"{figures['ldr_mean']:.4f}, gt mean {figures['gt_mean']:.4f}, sharded hits "
          f"{figures['hits']}/{n_rays}")
    return figures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="run dryrun_multichip(N) instead of one tiny frame")
    ap.add_argument("--device", default=None,
                    help="device of every shard (\"cpu\": the plain path); default: the cards")
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, args.device)
        return 0
    fn, (state,) = entry(args.device)
    ldr, _ = fn(state)
    print(f"entry: {tuple(ldr.shape)} frame on {ldr.device}, ldr mean {ldr.mean().item():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
