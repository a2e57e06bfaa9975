"""Denoiser stencils on the card: K3 (SVGF à-trous chain) and K4
(separable bilateral blur), csrc/stencil.cu.

Counterparts of ``hybrid_rendering_tpu/ops/pallas/stencil.py``
``atrous_chain`` and ``bilateral_blur``. CPU tensors take the plain
versions (``atrous_chain_plain`` / ``bilateral_blur_plain``, built on
ops/filters.py); CUDA tensors launch the kernels. K3 runs a chain as a few
launches of one tiled kernel, each fusing consecutive iterations
(``_plan``); it agrees with the plain version to a tolerance (folded
weights, approximate exp2). K4 is one launch of shared-memory tiles that
evaluates each pair's weights once, and rounds like its plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from hybrid_rendering_torch.ops import filters, kernels


def atrous_chain_plain(color, variance, normal, depth, mask, *, steps, radius=1,
                       phi_color=10.0, phi_normal=32.0, sigma_depth=1.0,
                       feedback_iteration=1):
    """Plain K3: the chain of ``filters.atrous_iteration`` calls. Returns
    (final, feedback, variance); feedback is the output of iteration
    `feedback_iteration`, or the input if the chain is shorter."""
    feedback = color
    for i, step in enumerate(steps):
        color, variance = filters.atrous_iteration(
            color, variance, normal, depth, step=step, radius=radius,
            phi_color=phi_color, phi_normal=phi_normal,
            sigma_depth=sigma_depth, mask=mask)
        if i == feedback_iteration:
            feedback = color
    return color, feedback, variance


SMEM_LIMIT = 232448  # dynamic shared memory a block may ask for (csrc/stencil.cu)
# How K3 launches, chosen by timings on an H100: iterations fuse into one
# launch while the launch's halo (the sum of its iterations' reaches) stays
# within _MAX_HALO (a larger halo loses more to recomputation than the
# fusion saves); (tile_w, tile_h, threads) of a launch by its halo.
_MAX_HALO = 3
_TILES = ((3, (32, 16, 256)), (15, (32, 32, 512)))


def _reach(step, radius):
    """Pixels an iteration reads beyond its own: its taps, and the 3x3
    variance box."""
    return max(radius * step, 1)


def _smem_bytes(tile_w, tile_h, halo, channels, fused):
    """Shared memory of one block of a launch of `fused` iterations
    (csrc/stencil.cu hr_atrous_fused): normal + depth, the mask, and one
    colour + variance buffer, or two to go from iteration to iteration."""
    pixels = (tile_w + 2 * halo) * (tile_h + 2 * halo)
    return pixels * (16 + (2 if fused > 1 else 1) * ((4 if channels == 1 else 16) + 4) + 1)


def _tile_for(halo, channels, fused):
    """(tile_w, tile_h, threads) for a launch with this halo: the first
    entry of _TILES that covers it, shrunk until it fits a block's shared
    memory."""
    tile_w, tile_h, threads = next((t for h, t in _TILES if halo <= h), _TILES[-1][1])

    def too_big():
        return _smem_bytes(tile_w, tile_h, halo, channels, fused) > SMEM_LIMIT

    while too_big() and tile_h > 1:
        tile_h //= 2
    while too_big() and tile_w > 1:
        tile_w //= 2
    if too_big():
        raise ValueError(f"atrous_chain: a halo of {halo} pixels does not fit a block")
    return tile_w, tile_h, threads


def _plan(steps, radius):
    """Group the chain's iterations into launches: consecutive iterations
    fuse while their summed reach stays within _MAX_HALO (and a launch
    holds at most MAX_FUSED). Returns a list of lists of chain indices."""
    groups, halo = [], 0
    for i, step in enumerate(steps):
        r = _reach(step, radius)
        if groups and halo + r <= _MAX_HALO and len(groups[-1]) < kernels.MAX_FUSED:
            groups[-1].append(i)
            halo += r
        else:
            groups.append([i])
            halo = r
    return groups


@functools.lru_cache(maxsize=64)
def _launches(steps, radius, sigma_depth, feedback_iteration, channels):
    """The chain's launches, ready to pass to the kernel: for each, (number
    of iterations, their steps and depth phis as C arrays, tile_w, tile_h,
    threads, the index of the iteration whose colour goes to a feedback
    plane of its own or -1, whether the launch's output is the feedback)."""
    out = []
    for group in _plan(steps, radius):
        n = len(group)
        halo = sum(_reach(steps[i], radius) for i in group)
        tile_w, tile_h, threads = _tile_for(halo, channels, n)
        # the feedback plane is this launch's output, or a plane of its own
        # when a later iteration of the launch goes on from it
        fb_at = group.index(feedback_iteration) if feedback_iteration in group[:-1] else -1
        out.append((n, (ctypes.c_int * n)(*(steps[i] for i in group)),
                    (ctypes.c_float * n)(*(filters.depth_phi(sigma_depth, steps[i])
                                           for i in group)),
                    tile_w, tile_h, threads, fb_at, group[-1] == feedback_iteration))
    return tuple(out)


def atrous_chain(color, variance, normal, depth, mask, *, steps, radius=1,
                 phi_color=10.0, phi_normal=32.0, sigma_depth=1.0,
                 feedback_iteration=1):
    """K3: SVGF à-trous iterations at the given steps; consecutive
    iterations fuse into one launch (``_plan``). color (H,W) or (H,W,3)
    float32; variance/depth (H,W); normal (H,W,3); mask (H,W) bool. Returns
    (final, feedback, variance)."""
    if kernels.on_cpu(color):
        return atrous_chain_plain(
            color, variance, normal, depth, mask, steps=steps, radius=radius,
            phi_color=phi_color, phi_normal=phi_normal,
            sigma_depth=sigma_depth, feedback_iteration=feedback_iteration)
    H, W = depth.shape
    C = 1 if color.ndim == 2 else color.shape[-1]
    if C not in (1, 3):
        raise ValueError(f"atrous_chain: 1 or 3 channels, got {C}")
    if not 0 <= radius <= 2:
        raise ValueError(f"atrous_chain: radius must be in [0, 2], got {radius}")
    dev = color.device
    kernels.require(color, "color", torch.float32, (H, W) if C == 1 else (H, W, 3), dev)
    kernels.require(variance, "variance", torch.float32, (H, W), dev)
    kernels.require(normal, "normal", torch.float32, (H, W, 3), dev)
    kernels.require(depth, "depth", torch.float32, (H, W), dev)
    kernels.require(mask, "mask", torch.bool, (H, W), dev)
    lib, stream = kernels.lib(), kernels.stream_ptr(dev)
    launches = _launches(tuple(int(s) for s in steps), int(radius), float(sigma_depth),
                         int(feedback_iteration), C)
    feedback = color
    # every launch's outputs, allocated once
    outs_c = torch.empty((len(launches),) + tuple(color.shape), dtype=color.dtype,
                         device=dev).unbind(0)
    outs_v = torch.empty((len(launches), H, W), dtype=variance.dtype, device=dev).unbind(0)
    planes = (normal.data_ptr(), depth.data_ptr(), mask.data_ptr(), H, W, int(radius))
    weights = (float(phi_color), float(phi_normal))
    for (n, steps_c, phis_c, tile_w, tile_h, threads, fb_at, is_feedback), out_c, out_v in zip(
            launches, outs_c, outs_v):
        out_fb = torch.empty_like(color) if fb_at >= 0 else None
        with torch.cuda.device(dev):
            err = lib.hr_atrous_fused(
                C, color.data_ptr(), variance.data_ptr(), *planes, n, steps_c, phis_c,
                *weights, fb_at, tile_w, tile_h, threads, out_c.data_ptr(), out_v.data_ptr(),
                out_fb.data_ptr() if fb_at >= 0 else None, stream)
        kernels.check(err, "hr_atrous_fused")
        atrous_chain.launches += 1
        color, variance = out_c, out_v
        if fb_at >= 0:
            feedback = out_fb
        elif is_feedback:
            feedback = color
    return color, feedback, variance


def bilateral_blur_plain(img, normal, depth, mask, *, radius=4, depth_phi=1.0,
                         normal_power=32.0):
    """Plain K4: ``filters.bilateral_blur_separable``."""
    return filters.bilateral_blur_separable(
        img, normal, depth, radius=radius, depth_phi=depth_phi,
        normal_power=normal_power, mask=mask)


def bilateral_blur(img, normal, depth, mask, *, radius=4, depth_phi=1.0,
                   normal_power=32.0):
    """K4: vertical then horizontal bilateral Gaussian (sigma = radius/1.5)
    with normal/depth edge stops; pixels outside `mask` keep their input.
    img/depth (H,W) float32, normal (H,W,3), mask (H,W) bool. One launch."""
    if kernels.on_cpu(img):
        return bilateral_blur_plain(img, normal, depth, mask, radius=radius,
                                    depth_phi=depth_phi, normal_power=normal_power)
    H, W = img.shape
    if not 1 <= radius <= kernels.MAX_BLUR_RADIUS:
        # r = 0 has no Gaussian (sigma = r / 1.5): the plain version and the
        # JAX package's raise on it too
        raise ValueError(f"bilateral_blur: radius must be in "
                         f"[1, {kernels.MAX_BLUR_RADIUS}], got {radius}")
    dev = img.device
    kernels.require(img, "img", torch.float32, (H, W), dev)
    kernels.require(normal, "normal", torch.float32, (H, W, 3), dev)
    kernels.require(depth, "depth", torch.float32, (H, W), dev)
    kernels.require(mask, "mask", torch.bool, (H, W), dev)
    taps = kernels.GaussTaps()
    for i, g in enumerate(filters.gauss_taps(radius)):
        taps.w[i] = g
    out = torch.empty_like(img)
    with torch.cuda.device(dev):
        err = kernels.lib().hr_bilateral_blur(
            img.data_ptr(), normal.data_ptr(), depth.data_ptr(), mask.data_ptr(),
            H, W, int(radius), taps, max(float(depth_phi), 1e-6), float(normal_power),
            out.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "hr_bilateral_blur")
    bilateral_blur.launches += 1
    return out


atrous_chain.launches = 0
bilateral_blur.launches = 0
