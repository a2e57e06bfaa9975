"""The temporal stage of the three SVGF denoisers on the card: kernel K8,
csrc/temporal.cu.

Each pass's ``temporal_accumulation`` (models/shadows.py, models/ao.py,
models/reflections.py) is one launch on CUDA tensors: the reprojection of
``ops/reprojection.reproject`` and the pass's blend, with the shadows'
17x17 mean and the reflections' virtual-point coordinates, camera-motion
cap and 17x17 colour clip. The plain versions are the passes'
``temporal_accumulation_plain``; these wrappers take CUDA tensors only.
Each call adds its pixels to the counter ``temporal_px``.
"""
from __future__ import annotations

import torch

from hybrid_rendering_torch.ops import kernels
from hybrid_rendering_torch.utils import profiler


def _plane(t, shape, name, dev, dtype=torch.float32):
    """`t` as a contiguous operand of `shape` (a contiguous tensor stays
    itself)."""
    t = t.contiguous()
    kernels.require(t, name, dtype, shape, dev)
    return t


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _gbuffers(gb, prev_gb, dev):
    """The G-buffer planes the reprojection reads: this frame's position,
    normal, mesh id and motion, the previous frame's position, normal and
    mesh id."""
    H, W = gb.depth.shape
    return (_plane(gb.position, (H, W, 3), "gb.position", dev),
            _plane(gb.normal, (H, W, 3), "gb.normal", dev),
            _plane(gb.mesh_id, (H, W), "gb.mesh_id", dev, torch.int32),
            _plane(gb.motion, (H, W, 2), "gb.motion", dev),
            _plane(prev_gb.position, (H, W, 3), "prev_gb.position", dev),
            _plane(prev_gb.normal, (H, W, 3), "prev_gb.normal", dev),
            _plane(prev_gb.mesh_id, (H, W), "prev_gb.mesh_id", dev, torch.int32))


def _empty(shape, dev):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def shadows(raw, gb, prev_gb, state, cfg):
    """K8 at the shadows (full or scaled resolution, one channel, with
    moments). Returns (visibility, variance, moments, history_length)."""
    dev = raw.device
    H, W = gb.depth.shape
    ins = (*_gbuffers(gb, prev_gb, dev), _plane(state.history, (H, W), "state.history", dev),
           _plane(state.moments, (H, W, 2), "state.moments", dev),
           _plane(state.history_length, (H, W), "state.history_length", dev),
           _plane(raw, (H, W), "raw", dev))
    outs = vis, var, moments, length = (_empty((H, W), dev), _empty((H, W), dev),
                                        _empty((H, W, 2), dev), _empty((H, W), dev))
    with torch.cuda.device(dev):
        err = kernels.lib().hr_temporal_shadows(
            H, W, *_ptrs(*ins), cfg.history_cap, cfg.alpha, cfg.moments_alpha,
            cfg.clamp_std_factor, *_ptrs(*outs), kernels.stream_ptr(dev))
    kernels.check(err, "hr_temporal_shadows")
    shadows.launches += 1
    profiler.count("temporal_px", H * W)
    return vis, var, moments, length


def ao(raw, gb, prev_gb, state, cfg):
    """K8 at the AO (one channel, no moments, no clamp). Returns (ao,
    history_length)."""
    dev = raw.device
    H, W = gb.depth.shape
    ins = (*_gbuffers(gb, prev_gb, dev), _plane(state.history, (H, W), "state.history", dev),
           _plane(state.history_length, (H, W), "state.history_length", dev),
           _plane(raw, (H, W), "raw", dev))
    outs = out, length = _empty((H, W), dev), _empty((H, W), dev)
    with torch.cuda.device(dev):
        err = kernels.lib().hr_temporal_ao(H, W, *_ptrs(*ins), cfg.history_cap, cfg.alpha,
                                           *_ptrs(*outs), kernels.stream_ptr(dev))
    kernels.check(err, "hr_temporal_ao")
    ao.launches += 1
    profiler.count("temporal_px", H * W)
    return out, length


def reflections(raw, ray_length, gb, prev_gb, camera, camera_delta, state, cfg):
    """K8 at the reflections (three channels, virtual-point reprojection,
    the cap read from `camera_delta`, a () tensor, on the card). Returns
    (color, variance, moments, history_length)."""
    dev = raw.device
    H, W = gb.depth.shape
    g = _gbuffers(gb, prev_gb, dev)
    ins = (*g[:4], _plane(ray_length, (H, W), "ray_length", dev),
           _plane(gb.curvature, (H, W), "gb.curvature", dev),
           _plane(camera.position, (3,), "camera.position", dev),
           _plane(camera.prev_view_proj, (4, 4), "camera.prev_view_proj", dev),
           _plane(camera_delta.reshape(1), (1,), "camera_delta", dev), *g[4:],
           _plane(state.history, (H, W, 3), "state.history", dev),
           _plane(state.moments, (H, W, 2), "state.moments", dev),
           _plane(state.history_length, (H, W), "state.history_length", dev),
           _plane(raw, (H, W, 3), "raw", dev))
    outs = color, var, moments, length = (_empty((H, W, 3), dev), _empty((H, W), dev),
                                          _empty((H, W, 2), dev), _empty((H, W), dev))
    with torch.cuda.device(dev):
        err = kernels.lib().hr_temporal_reflections(
            H, W, *_ptrs(*ins), cfg.history_cap, cfg.accumulation_cap_moving, cfg.alpha,
            cfg.moments_alpha, *_ptrs(*outs), kernels.stream_ptr(dev))
    kernels.check(err, "hr_temporal_reflections")
    reflections.launches += 1
    profiler.count("temporal_px", H * W)
    return color, var, moments, length


shadows.launches = 0
ao.launches = 0
reflections.launches = 0
