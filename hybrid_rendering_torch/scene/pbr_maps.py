"""Procedural PBR maps for the textured Sponza (``scenes.sponza_pbr``).

The public asset the scene stands for (Khronos glTF-Sample-Models
``2.0/Sponza``) ships about two dozen materials, most with a base-colour
map, a tangent-space normal map and a packed metallic-roughness map at
1024². Those files cannot be shipped here, so each material's three maps
are made from fixed seeds in vectorised numpy: tileable value noise,
running-bond blocks, flutes and a weave, all in float32. The same seed and
size give the same maps bit for bit.

Every map tiles (the sampler wraps), and each material returns
``(base colour RGB, normal RGB, metallic-roughness RGB)`` with glTF's
packing: R = occlusion (1), G = roughness, B = metallic.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# (kind, base colour, metal bands) of each material, in the order of
# ``GROUPS``
MATERIALS: Tuple[Tuple[str, Tuple[float, float, float], bool], ...] = (
    ("flagstones", (0.58, 0.55, 0.50), False),  # floor
    ("bricks", (0.62, 0.50, 0.40), False),  # long walls
    ("bricks", (0.57, 0.49, 0.42), False),
    ("plaster", (0.74, 0.70, 0.62), False),  # end walls
    ("plaster", (0.70, 0.67, 0.60), False),
    ("column", (0.72, 0.68, 0.62), False),  # 7 column pairs
    ("column", (0.70, 0.66, 0.60), True),
    ("column", (0.74, 0.70, 0.63), False),
    ("column", (0.69, 0.64, 0.58), True),
    ("column", (0.73, 0.69, 0.61), False),
    ("column", (0.71, 0.67, 0.60), True),
    ("column", (0.68, 0.65, 0.59), False),
    ("blocks", (0.70, 0.65, 0.57), False),  # entablatures
    ("blocks", (0.66, 0.62, 0.55), False),
    ("weave", (0.55, 0.12, 0.10), False),  # drapes
    ("weave", (0.14, 0.35, 0.16), False),
    ("weave", (0.13, 0.18, 0.45), False),
    ("rock", (0.45, 0.42, 0.38), False),  # 7 boulder groups
    ("rock", (0.50, 0.46, 0.40), False),
    ("rock", (0.41, 0.39, 0.36), False),
    ("rock", (0.48, 0.43, 0.35), False),
    ("rock", (0.43, 0.43, 0.42), False),
    ("rock", (0.52, 0.48, 0.43), False),
    ("rock", (0.39, 0.36, 0.32), False),
)
# the materials of each part of the hall, (first, count): the k-th object
# of a part takes material first + k % count. The floor, the two long
# walls, the two end walls, the 14 columns in 7 pairs (the two columns
# facing each other across the hall), the two entablatures, the three
# drapes and the 60 boulders in 7 groups: 24
GROUPS = {"floor": (0, 1), "wall": (1, 2), "end_wall": (3, 2), "column": (5, 7),
          "entablature": (12, 2), "drape": (14, 3), "boulder": (17, 7)}
BRONZE = (0.80, 0.55, 0.30)
SEED = 1000  # material k draws from seed SEED + k


def _coords(size: int, repeats: float):
    """Texel centres in [0, repeats), float32."""
    return (np.arange(size, dtype=np.float32) + np.float32(0.5)) * np.float32(repeats / size)


def _fade(t):
    return t * t * (np.float32(3.0) - np.float32(2.0) * t)


def value_noise(size: int, cells: int, seed: int, octaves: int = 4) -> np.ndarray:
    """Tileable value noise, (size, size) float32 in about [-1, 1]: a
    lattice of `cells` a side at the first octave, doubled each octave at
    half the amplitude, wrapping so that the map repeats seamlessly."""
    rs = np.random.RandomState(seed)
    out = np.zeros((size, size), np.float32)
    amp = np.float32(1.0)
    for _ in range(octaves):
        cells = min(cells, size)
        g = rs.uniform(-1.0, 1.0, (cells, cells)).astype(np.float32)
        x = _coords(size, cells)
        i0 = np.floor(x).astype(np.int64)
        f = _fade(x - i0.astype(np.float32))
        i0 %= cells
        i1 = (i0 + 1) % cells
        rows = g[:, i0] * (np.float32(1.0) - f) + g[:, i1] * f  # (cells, size): along x
        out += amp * (rows[i0] * (np.float32(1.0) - f)[:, None] + rows[i1] * f[:, None])
        amp = amp * np.float32(0.5)
        cells *= 2
    return out


def blocks(size: int, rows: int, cols: int, mortar: float, seed: int):
    """A running-bond pattern of rows x cols blocks, tileable: (mortar
    mask in [0, 1], a value in [0, 1) drawn for each block), (size, size)
    float32 each. `mortar` is the joint's half width in texels at 1024²."""
    y = _coords(size, rows)[:, None]
    r = np.floor(y)
    x = _coords(size, cols)[None, :] + np.float32(0.5) * (r % 2)
    c = np.floor(x)
    # distance to the block's edge in texels
    dy = np.minimum(y - r, np.float32(1.0) - (y - r)) * np.float32(size / rows)
    dx = np.minimum(x - c, np.float32(1.0) - (x - c)) * np.float32(size / cols)
    w = np.float32(max(mortar * size / 1024.0, 0.75))
    joint = np.clip((w - np.minimum(dx, dy)) / w + np.float32(0.5), 0.0, 1.0)
    table = np.random.RandomState(seed).uniform(0.0, 1.0, (rows, cols)).astype(np.float32)
    ids = table[r.astype(np.int64) % rows, c.astype(np.int64) % cols]
    return joint.astype(np.float32), ids


def weave(size: int, threads: int) -> np.ndarray:
    """Height of a plain weave, threads x threads over and under, in [0, 1]."""
    t = _coords(size, threads)
    i = np.floor(t)
    bulge = np.float32(4.0) * (t - i) * (np.float32(1.0) - (t - i))
    over = ((i[:, None] + i[None, :]) % 2) == 0
    return np.where(over, bulge[None, :], bulge[:, None]).astype(np.float32)


def normal_map(height: np.ndarray, relief: float) -> np.ndarray:
    """Tangent-space normal map (RGB in [0, 1], +Z out of the surface) of a
    tileable height field: wrapped central differences, `relief` the
    height of 1 in units of the map's width. Columns run along +u (the
    tangent), rows along +v (the bitangent)."""
    size = height.shape[0]
    k = np.float32(relief * size / 2.0)
    dx = (np.roll(height, -1, axis=1) - np.roll(height, 1, axis=1)) * k
    dy = (np.roll(height, -1, axis=0) - np.roll(height, 1, axis=0)) * k
    inv = np.float32(1.0) / np.sqrt(dx * dx + dy * dy + np.float32(1.0))
    n = np.stack([-dx * inv, -dy * inv, inv], axis=-1)
    return (n * np.float32(0.5) + np.float32(0.5)).astype(np.float32)


def material_maps(index: int, size: int):
    """The three maps of material `index` of ``MATERIALS`` at size²:
    (base colour, normal, metallic-roughness), each (size, size, 3)
    float32."""
    kind, colour, banded = MATERIALS[index]
    seed = SEED + index
    one = np.float32(1.0)
    noise = value_noise(size, 4, seed, octaves=5)
    fine = value_noise(size, 32, seed + 500, octaves=3)
    if kind in ("flagstones", "bricks", "blocks"):
        rows, cols, mortar = {"flagstones": (4, 3, 6.0), "bricks": (16, 6, 4.0),
                              "blocks": (4, 8, 5.0)}[kind]
        joint, ids = blocks(size, rows, cols, mortar, seed + 1)
        height = (one - joint) * np.float32(0.8) + np.float32(0.1) * (noise + fine)
        shade = (np.float32(0.8) + np.float32(0.3) * ids) * (one - np.float32(0.35) * joint)
        rough = np.float32(0.62) + np.float32(0.1) * noise + np.float32(0.25) * joint
    elif kind == "plaster":
        height = np.float32(0.5) * noise + np.float32(0.15) * fine
        shade = np.float32(0.92) + np.float32(0.12) * noise
        rough = np.float32(0.85) + np.float32(0.08) * fine
    elif kind == "column":
        u = _coords(size, 12)  # 12 flutes a repeat
        flute = (u - np.floor(u)) * (one - (u - np.floor(u))) * np.float32(4.0)
        height = np.broadcast_to(flute[None, :], (size, size)) + np.float32(0.1) * fine
        shade = np.float32(0.9) + np.float32(0.1) * noise + np.float32(0.05) * flute[None, :]
        rough = np.float32(0.7) + np.float32(0.1) * noise
    elif kind == "weave":
        height = weave(size, 48) + np.float32(0.1) * fine
        shade = np.float32(0.65) + np.float32(0.35) * height + np.float32(0.1) * noise
        rough = np.float32(0.9) + np.float32(0.05) * fine
    else:  # rock
        height = noise + np.float32(0.5) * fine
        shade = np.float32(0.85) + np.float32(0.25) * noise + np.float32(0.1) * fine
        rough = np.float32(0.88) + np.float32(0.06) * fine
    albedo = np.clip(shade[..., None] * np.asarray(colour, np.float32), 0.0, 1.0)
    metal = np.zeros((size, size), np.float32)
    if banded:
        # bronze rings, the fittings of the asset's metal parts: three a
        # repeat along v, over 8% of each third
        v = _coords(size, 3)
        band = ((v - np.floor(v)) < np.float32(0.08))[:, None]
        band = np.broadcast_to(band, (size, size))
        metal = np.where(band, np.float32(1.0), metal)
        rough = np.where(band, np.float32(0.3) + np.float32(0.05) * fine, rough)
        height = np.where(band, np.float32(1.0), height)
        albedo = np.where(band[..., None], np.asarray(BRONZE, np.float32), albedo)
    mr = np.stack([np.ones((size, size), np.float32), np.clip(rough, 0.0, 1.0), metal],
                  axis=-1)
    return (albedo.astype(np.float32), normal_map(height.astype(np.float32), 0.004),
            mr.astype(np.float32))
