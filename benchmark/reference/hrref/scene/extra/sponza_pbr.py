"""The reference's copy of ``sponza_pbr``: the hall of ``scenes.sponza_scan``
(the same objects, seeds and order) with the 24 textured materials of the
public PBR Sponza (Khronos glTF-Sample-Models 2.0/Sponza), each a
base-colour, a tangent-space normal and a glTF-packed metallic-roughness
map (G roughness, B metallic), 72 maps of ``map_size``² made in numpy from
fixed seeds. UVs repeat a map about every 2 m; tangents follow them.

Plain numpy and PyTorch on the reference's own builder
(``hrref.scene.build``), atlas (``hrref.scene.textures``) and primitives;
it imports nothing of the program. The maps, triangles, UVs, tangents and
atlas equal the program's bit for bit
(``benchmark/tests/test_bench_reference.py``)."""
from __future__ import annotations

import dataclasses

import numpy as np

from hrref.scene import primitives as prim
from hrref.scene.build import (
    MaterialDef,
    SceneBuilder,
    rotation_x,
    rotation_y,
    scaling,
    translation,
)
from hrref.types import Light

# ---- the maps -------------------------------------------------------------

# (kind, base colour, metal bands) of each material, in the order of GROUPS
MATERIALS = (
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
BRONZE = (0.80, 0.55, 0.30)
SEED = 1000  # material k draws from seed SEED + k
F = np.float32


def _coords(size, repeats):
    """Texel centres in [0, repeats), float32."""
    return (np.arange(size, dtype=np.float32) + F(0.5)) * F(repeats / size)


def _fade(t):
    return t * t * (F(3.0) - F(2.0) * t)


def value_noise(size, cells, seed, octaves=4):
    """Tileable value noise: a wrapping lattice of `cells` a side, doubled
    each octave at half the amplitude; bilinear with a smoothstep fade,
    along x over the lattice's rows first, then along y."""
    rs = np.random.RandomState(seed)
    out = np.zeros((size, size), np.float32)
    amp = F(1.0)
    for _ in range(octaves):
        cells = min(cells, size)
        g = rs.uniform(-1.0, 1.0, (cells, cells)).astype(np.float32)
        x = _coords(size, cells)
        i0 = np.floor(x).astype(np.int64)
        f = _fade(x - i0.astype(np.float32))
        i0 %= cells
        i1 = (i0 + 1) % cells
        rows = g[:, i0] * (F(1.0) - f) + g[:, i1] * f
        out += amp * (rows[i0] * (F(1.0) - f)[:, None] + rows[i1] * f[:, None])
        amp = amp * F(0.5)
        cells *= 2
    return out


def blocks(size, rows, cols, mortar, seed):
    """Running bond (every other row half a block over): the joint mask
    and a value drawn for each block."""
    y = _coords(size, rows)[:, None]
    r = np.floor(y)
    x = _coords(size, cols)[None, :] + F(0.5) * (r % 2)
    c = np.floor(x)
    dy = np.minimum(y - r, F(1.0) - (y - r)) * F(size / rows)
    dx = np.minimum(x - c, F(1.0) - (x - c)) * F(size / cols)
    w = F(max(mortar * size / 1024.0, 0.75))
    joint = np.clip((w - np.minimum(dx, dy)) / w + F(0.5), 0.0, 1.0)
    table = np.random.RandomState(seed).uniform(0.0, 1.0, (rows, cols)).astype(np.float32)
    ids = table[r.astype(np.int64) % rows, c.astype(np.int64) % cols]
    return joint.astype(np.float32), ids


def weave(size, threads):
    t = _coords(size, threads)
    i = np.floor(t)
    bulge = F(4.0) * (t - i) * (F(1.0) - (t - i))
    over = ((i[:, None] + i[None, :]) % 2) == 0
    return np.where(over, bulge[None, :], bulge[:, None]).astype(np.float32)


def normal_map(height, relief):
    """Wrapped central differences of the height; +Z out of the surface,
    columns along +u, rows along +v; RGB in [0, 1]."""
    size = height.shape[0]
    k = F(relief * size / 2.0)
    dx = (np.roll(height, -1, axis=1) - np.roll(height, 1, axis=1)) * k
    dy = (np.roll(height, -1, axis=0) - np.roll(height, 1, axis=0)) * k
    inv = F(1.0) / np.sqrt(dx * dx + dy * dy + F(1.0))
    n = np.stack([-dx * inv, -dy * inv, inv], axis=-1)
    return (n * F(0.5) + F(0.5)).astype(np.float32)


def material_maps(index, size):
    """(base colour, normal, metallic-roughness) of material `index`."""
    kind, colour, banded = MATERIALS[index]
    seed = SEED + index
    one = F(1.0)
    noise = value_noise(size, 4, seed, octaves=5)
    fine = value_noise(size, 32, seed + 500, octaves=3)
    if kind in ("flagstones", "bricks", "blocks"):
        rows, cols, mortar = {"flagstones": (4, 3, 6.0), "bricks": (16, 6, 4.0),
                              "blocks": (4, 8, 5.0)}[kind]
        joint, ids = blocks(size, rows, cols, mortar, seed + 1)
        height = (one - joint) * F(0.8) + F(0.1) * (noise + fine)
        shade = (F(0.8) + F(0.3) * ids) * (one - F(0.35) * joint)
        rough = F(0.62) + F(0.1) * noise + F(0.25) * joint
    elif kind == "plaster":
        height = F(0.5) * noise + F(0.15) * fine
        shade = F(0.92) + F(0.12) * noise
        rough = F(0.85) + F(0.08) * fine
    elif kind == "column":
        u = _coords(size, 12)
        flute = (u - np.floor(u)) * (one - (u - np.floor(u))) * F(4.0)
        height = np.broadcast_to(flute[None, :], (size, size)) + F(0.1) * fine
        shade = F(0.9) + F(0.1) * noise + F(0.05) * flute[None, :]
        rough = F(0.7) + F(0.1) * noise
    elif kind == "weave":
        height = weave(size, 48) + F(0.1) * fine
        shade = F(0.65) + F(0.35) * height + F(0.1) * noise
        rough = F(0.9) + F(0.05) * fine
    else:  # rock
        height = noise + F(0.5) * fine
        shade = F(0.85) + F(0.25) * noise + F(0.1) * fine
        rough = F(0.88) + F(0.06) * fine
    albedo = np.clip(shade[..., None] * np.asarray(colour, np.float32), 0.0, 1.0)
    metal = np.zeros((size, size), np.float32)
    if banded:
        v = _coords(size, 3)
        band = np.broadcast_to(((v - np.floor(v)) < F(0.08))[:, None], (size, size))
        metal = np.where(band, F(1.0), metal)
        rough = np.where(band, F(0.3) + F(0.05) * fine, rough)
        height = np.where(band, F(1.0), height)
        albedo = np.where(band[..., None], np.asarray(BRONZE, np.float32), albedo)
    mr = np.stack([np.ones((size, size), np.float32), np.clip(rough, 0.0, 1.0), metal],
                  axis=-1)
    return (albedo.astype(np.float32), normal_map(height.astype(np.float32), 0.004),
            mr.astype(np.float32))


# ---- the hall -------------------------------------------------------------

def _compose(*ms):
    out = np.eye(4, dtype=np.float32)
    for m in ms:
        out = out @ m
    return out


def _hall():
    """``sponza_scan``'s objects in its order: (part, k, mesh, transform,
    UV repeats, two numbers or a pair a vertex)."""
    rx = rotation_x(np.pi / 2)
    yield ("floor", 0, prim.displace(prim.irregular_grid(24000, 36.0, 18.0, seed=21),
                                     0.06, seed=11), None, (18.0, 9.0))
    for k, (s, z, rot) in enumerate(((22, -9.0, rx), (23, 9.0, rotation_x(-np.pi / 2)))):
        wall = prim.displace(prim.irregular_grid(13000, 36.0, 8.0, seed=s), 0.1, seed=s + 10)
        yield "wall", k, wall, _compose(translation(0, 4.0, z), rot), (18.0, 4.0)
    for k, (s, x) in enumerate(((24, -18.0), (25, 18.0))):
        wall = prim.displace(prim.irregular_grid(3000, 18.0, 8.0, seed=s), 0.05, seed=s + 10)
        m = _compose(translation(x, 4.0, 0.0), _compose(rotation_y(np.pi / 2), rx))
        yield "end_wall", k, wall, m, (9.0, 4.0)
    for k, (z, i) in enumerate((z, i) for z in (-6.0, 6.0) for i in range(7)):
        x = -15.0 + i * 5.0
        col = prim.scanify(prim.displace(prim.cylinder(0.5, 6.0, 72, stacks=24), 0.04,
                                         seed=40 + k),
                           seed=60 + k, jitter=0.25, collapse_frac=0.04)
        yield "column", k, col, translation(x, 3.0, z), (2.0, 3.0)
    # a box face's repeats: +-z faces span x and y, +-x faces z and y, +-y x and z
    box_repeats = np.repeat(np.asarray([(18.0, 0.5), (18.0, 0.5), (1.0, 0.5), (1.0, 0.5),
                                        (18.0, 1.0), (18.0, 1.0)]), 4, axis=0)
    for k, z in enumerate((-6.0, 6.0)):
        yield "entablature", k, prim.box(36.0, 1.0, 2.0), translation(0, 6.5, z), box_repeats
    for k, x in enumerate((-8.0, 0.0, 8.0)):
        cloth = prim.scanify(prim.displace(prim.grid_mesh(96, 64, 3.0, 2.5), 0.22,
                                           seed=80 + k),
                             seed=90 + k, jitter=0.3, collapse_frac=0.05)
        yield "drape", k, cloth, _compose(translation(x, 4.5, -5.0), rx), (1.5, 1.25)
    rs = np.random.RandomState(7)
    for k in range(60):
        x = rs.uniform(-16.0, 16.0)
        z = rs.uniform(-4.5, 4.5)
        s = rs.uniform(0.3, 0.9)
        boulder = prim.scanify(prim.displace(prim.uv_sphere(1.0, 24, 40), 0.25, seed=100 + k),
                               seed=200 + k, jitter=0.35, collapse_frac=0.06)
        m = _compose(translation(x, s * 0.8, z), scaling(s),
                     rotation_y(rs.uniform(0, 2 * np.pi)))
        yield "boulder", k, boulder, m, (max(1.0, round(np.pi * s)), np.pi * s / 2.0)


# part -> (first material, materials): floor 1, long walls 2, end walls 2,
# 14 columns in 7 facing pairs, entablatures 2, drapes 3, 60 boulders in 7
GROUPS = {"floor": (0, 1), "wall": (1, 2), "end_wall": (3, 2), "column": (5, 7),
          "entablature": (12, 2), "drape": (14, 3), "boulder": (17, 7)}


def build(use_bvh=True, map_size=1024):
    b = SceneBuilder()
    for k in range(len(MATERIALS)):
        albedo, normal, mr = (b.add_texture(img) for img in material_maps(k, map_size))
        b.add_material(MaterialDef(albedo=(1.0, 1.0, 1.0), roughness=1.0, metallic=0.0,
                                   albedo_tex=albedo, normal_tex=normal, roughness_tex=mr,
                                   metallic_tex=mr, roughness_channel=1, metallic_channel=2))
    for part, k, mesh, m, repeats in _hall():
        first, n = GROUPS[part]
        mesh = dataclasses.replace(mesh, uvs=mesh.uvs * np.asarray(repeats, np.float32))
        b.add_instance(mesh, first + k % n, m)
    scene = b.build(use_bvh=use_bvh)
    light = Light.directional(direction=(0.15, 0.95, 0.1), color=(1.0, 0.97, 0.9),
                              intensity=3.5, radius=0.06)
    return scene, light, dict(eye=(-13.0, 3.0, 0.5), target=(10.0, 3.5, -0.5))
