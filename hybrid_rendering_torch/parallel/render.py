"""The ground-truth path tracer over the mesh, a row block a shard.

Port of ``hybrid_rendering_tpu/parallel/render.py``. Pixels are
embarrassingly parallel, so the frame splits along rows: shard i traces
rows ``[i * rows, (i + 1) * rows)`` on ``mesh.devices[i]`` against that
device's copy of the scene and its BVH (method ``"bvh"``: K1/K2 on the
card), seeds each pixel's RNG from its global row, and blends the running
mean into its own row block. JAX runs the shards under ``shard_map``;
here they run one after another, each on its device's current stream,
and the blocks meet in ``state.color``'s device.
"""
from __future__ import annotations

import torch

from hybrid_rendering_torch.config import PathTracerConfig
from hybrid_rendering_torch.models import path_tracer
from hybrid_rendering_torch.ops import bvh
from hybrid_rendering_torch.ops import rng as rng_ops
from hybrid_rendering_torch.parallel.mesh import TILE_AXIS, Mesh
from hybrid_rendering_torch.types import Camera, Light, SceneArrays
from hybrid_rendering_torch.utils import camera as camera_utils


def path_trace_frame_sharded(mesh: Mesh, scene: SceneArrays, camera: Camera, light: Light,
                             sky, width: int, height: int,
                             cfg: PathTracerConfig = PathTracerConfig()):
    """Returns ``step(state) -> state``: one 1-spp sample of the frame,
    traced a row block a shard, blended into ``state.color`` (the running
    mean of ``path_tracer.accumulate``). `sky` has ``.radiance`` and
    ``.to``. height must divide by the mesh size."""
    n = mesh.shape[TILE_AXIS]
    if height % n:
        raise ValueError(f"height {height} must divide by the mesh size {n}")
    rows = height // n
    home = scene.device
    per_device = {}
    for dev in dict.fromkeys(mesh.devices):
        s, cam, lt, sk = ((scene, camera, light, sky) if dev == home else
                          (scene.to(dev), camera.to(dev), light.to(dev), sky.to(dev)))
        accel = bvh.make_accel(s, "bvh")
        per_device[dev] = (s, bvh.make_surface_tracer(s, accel, "bvh"),
                           bvh.make_tracers(s, accel, "bvh")[1], cam, lt, sk)

    def shard(i, dev, color_local, num_frames):
        s, closest_surface, vis, cam, lt, sk = per_device[dev]
        y0 = i * rows
        yy, xx = torch.meshgrid(torch.arange(rows, device=dev),
                                torch.arange(width, device=dev), indexing="ij")
        gy = yy + y0
        rng = rng_ops.rng_init(xx.reshape(-1), gy.reshape(-1), num_frames)
        rng, jit2 = rng_ops.next_vec2(rng)
        jit2 = jit2.reshape(rows, width, 2)
        origins, dirs = camera_utils.camera_rays_for_pixels(
            cam, xx.to(torch.float32) + jit2[..., 0], gy.to(torch.float32) + jit2[..., 1],
            width, height)
        L = path_tracer.trace_wavefront(
            s, closest_surface, vis, lt, sk.radiance, origins.reshape(-1, 3),
            dirs.reshape(-1, 3), rng, cfg).reshape(rows, width, 3)
        # the running mean (reference rgen:94-111)
        blended = color_local + (L - color_local) / torch.clamp(num_frames, min=1).to(
            torch.float32)
        return torch.where(num_frames == 0, L, blended)

    def step(state: path_tracer.GroundTruthState) -> path_tracer.GroundTruthState:
        out = state.color.device
        blocks = [shard(i, dev, state.color[i * rows:(i + 1) * rows].to(dev, non_blocking=True),
                        state.num_frames.to(dev, non_blocking=True)).to(out, non_blocking=True)
                  for i, dev in enumerate(mesh.devices)]
        return path_tracer.GroundTruthState(color=torch.cat(blocks),
                                            num_frames=state.num_frames + 1)

    return step
