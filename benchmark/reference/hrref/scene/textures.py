"""Texture atlas: every material texture packed into one image plus a
per-texture rect table, as ``hybrid_rendering_tpu/scene/textures.py``
packs them in place of the reference's bindless samplers
(src/common.cpp:635-666, scene_descriptor_set.glsl:180-228).

Packing runs on the host in numpy, so the same images give the same atlas
bit for bit in both packages. ``sample_atlas`` is a plain gather: bilinear
with repeat wrap, clamped half a texel inside each rect.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from hrref.ops.math3d import take_rows


@dataclasses.dataclass
class TextureAtlas:
    """Packed atlas + per-texture rects."""

    image: torch.Tensor  # (H, W, 4) float32
    rects: torch.Tensor  # (T, 4) float32 [x0, y0, w, h] in texels

    @property
    def num_textures(self) -> int:
        return self.rects.shape[0]

    def to(self, device) -> "TextureAtlas":
        return TextureAtlas(image=self.image.to(device), rects=self.rects.to(device))


class AtlasBuilder:
    """Shelf-packs images into one atlas (images: (h, w), (h, w, 3) or
    (h, w, 4) float arrays; gray is repeated to RGB, alpha defaults to 1)."""

    def __init__(self):
        self._images: List[np.ndarray] = []

    def add(self, img: np.ndarray) -> int:
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        if img.shape[2] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=2)
        self._images.append(img)
        return len(self._images) - 1

    def build(self) -> Optional[TextureAtlas]:
        """The atlas on the CPU, or None when no image was added. Shelves in
        order of decreasing height; the width is the next power of two of
        the widest image, at least 256."""
        if not self._images:
            return None
        order = sorted(range(len(self._images)), key=lambda i: -self._images[i].shape[0])
        atlas_w = max(1, 1 << int(np.ceil(np.log2(
            max(max(im.shape[1] for im in self._images), 1)))))
        atlas_w = max(atlas_w, 256)
        shelves = []  # [y, height, x cursor]
        rects = [None] * len(self._images)
        total_h = 0
        for i in order:
            h, w = self._images[i].shape[:2]
            for s in shelves:
                if s[1] >= h and s[2] + w <= atlas_w:
                    rects[i] = (s[2], s[0], w, h)
                    s[2] += w
                    break
            else:
                shelves.append([total_h, h, w])
                rects[i] = (0, total_h, w, h)
                total_h += h
        atlas = np.zeros((max(total_h, 1), atlas_w, 4), np.float32)
        for i, im in enumerate(self._images):
            x0, y0, w, h = rects[i]
            atlas[y0:y0 + h, x0:x0 + w] = im
        return TextureAtlas(image=torch.from_numpy(atlas),
                            rects=torch.from_numpy(np.asarray(rects, np.float32)))


def sample_atlas(atlas: TextureAtlas, tex_idx, uv, valid=None):
    """Bilinear atlas sample with repeat wrap. tex_idx (...,) int (-1 =
    no texture: ones); uv (..., 2); valid (...,) bool or None (False:
    ones). Returns (..., 4)."""
    H, W = atlas.image.shape[:2]
    idx = torch.clamp(tex_idx, 0, atlas.num_textures - 1).to(torch.int64)
    rect = take_rows(atlas.rects, idx)
    # floor-mod, as jnp's %: negative uv wraps into [0, 1)
    u = torch.remainder(uv[..., 0], 1.0)
    v = torch.remainder(uv[..., 1], 1.0)
    # texel coordinates inside the rect, clamped half a texel in
    x = rect[..., 0] + torch.clamp(torch.clamp(u * rect[..., 2] - 0.5, min=0.0),
                                   max=rect[..., 2] - 1.0)
    y = rect[..., 1] + torch.clamp(torch.clamp(v * rect[..., 3] - 0.5, min=0.0),
                                   max=rect[..., 3] - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    flat = atlas.image.reshape(H * W, 4)

    def tap(xi, yi):
        return take_rows(flat, torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1))

    out = (tap(x0, y0) * (1 - fx) * (1 - fy)
           + tap(x0 + 1, y0) * fx * (1 - fy)
           + tap(x0, y0 + 1) * (1 - fx) * fy
           + tap(x0 + 1, y0 + 1) * fx * fy)
    out = torch.where((tex_idx < 0)[..., None], 1.0, out)
    if valid is not None:
        out = torch.where(valid[..., None], out, 1.0)
    return out


def checkerboard(size: int = 64, a=(1.0, 1.0, 1.0), b=(0.2, 0.2, 0.2),
                 cells: int = 8) -> np.ndarray:
    """Procedural test texture: (size, size, 3) float32, `cells` squares
    a side, `a` where the cell indices sum to an odd number."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    c = ((yy // (size // cells) + xx // (size // cells)) % 2).astype(np.float32)
    return (np.asarray(a, np.float32)[None, None] * c[..., None]
            + np.asarray(b, np.float32)[None, None] * (1 - c[..., None]))
