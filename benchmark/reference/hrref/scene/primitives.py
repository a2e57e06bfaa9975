"""Procedural mesh primitives (numpy, host-side) — the same generators as
``hybrid_rendering_tpu/scene/primitives.py``, so both packages build
bit-identical scenes.

The reference loads binary meshes via Assimp (SURVEY §2.9 dw::Mesh) that are
NOT in the repo; the framework regenerates equivalent test geometry
procedurally (plane/box/sphere/cylinder/torus, and the displaced,
Delaunay and scanified tessellations of the hero scenes) so no external
assets are needed, mirroring how common.cpp:385-411 procedurally instances
the pillar grid.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray  # (V, 3)
    uvs: np.ndarray  # (V, 2)
    indices: np.ndarray  # (F, 3) int32

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


def _mesh(p, n, uv, idx) -> Mesh:
    return Mesh(
        positions=np.asarray(p, np.float32),
        normals=np.asarray(n, np.float32),
        uvs=np.asarray(uv, np.float32),
        indices=np.asarray(idx, np.int32),
    )


def plane(size_x: float = 1.0, size_z: float = 1.0) -> Mesh:
    """XZ ground plane centered at origin, +Y normal."""
    hx, hz = size_x / 2, size_z / 2
    p = [[-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz], [-hx, 0, hz]]
    n = [[0, 1, 0]] * 4
    uv = [[0, 0], [1, 0], [1, 1], [0, 1]]
    idx = [[0, 2, 1], [0, 3, 2]]
    return _mesh(p, n, uv, idx)


def box(sx: float = 1.0, sy: float = 1.0, sz: float = 1.0) -> Mesh:
    """Axis-aligned box centered at origin with flat-shaded faces."""
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    faces = [
        # normal, four corners (CCW viewed from outside)
        ((0, 0, 1), [(-hx, -hy, hz), (hx, -hy, hz), (hx, hy, hz), (-hx, hy, hz)]),
        ((0, 0, -1), [(hx, -hy, -hz), (-hx, -hy, -hz), (-hx, hy, -hz), (hx, hy, -hz)]),
        ((1, 0, 0), [(hx, -hy, hz), (hx, -hy, -hz), (hx, hy, -hz), (hx, hy, hz)]),
        ((-1, 0, 0), [(-hx, -hy, -hz), (-hx, -hy, hz), (-hx, hy, hz), (-hx, hy, -hz)]),
        ((0, 1, 0), [(-hx, hy, hz), (hx, hy, hz), (hx, hy, -hz), (-hx, hy, -hz)]),
        ((0, -1, 0), [(-hx, -hy, -hz), (hx, -hy, -hz), (hx, -hy, hz), (-hx, -hy, hz)]),
    ]
    p, n, uv, idx = [], [], [], []
    for fnormal, corners in faces:
        base = len(p)
        p.extend(corners)
        n.extend([fnormal] * 4)
        uv.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
        idx.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return _mesh(p, n, uv, idx)


def uv_sphere(radius: float = 0.5, stacks: int = 16, slices: int = 32) -> Mesh:
    p, n, uv, idx = [], [], [], []
    for i in range(stacks + 1):
        theta = np.pi * i / stacks
        for j in range(slices + 1):
            phi = 2 * np.pi * j / slices
            x = np.sin(theta) * np.cos(phi)
            y = np.cos(theta)
            z = np.sin(theta) * np.sin(phi)
            p.append([radius * x, radius * y, radius * z])
            n.append([x, y, z])
            uv.append([j / slices, i / stacks])
    for i in range(stacks):
        for j in range(slices):
            a = i * (slices + 1) + j
            b = a + slices + 1
            if i != 0:
                idx.append([a, a + 1, b])
            if i != stacks - 1:
                idx.append([a + 1, b + 1, b])
    return _mesh(p, n, uv, idx)


def cylinder(radius: float = 0.5, height: float = 1.0, slices: int = 24,
             stacks: int = 1) -> Mesh:
    """Y-axis cylinder with caps, centered at origin. `stacks` subdivides
    the side vertically (tessellation base for displaced/scanified hero
    columns)."""
    p, n, uv, idx = [], [], [], []
    hy = height / 2
    # side
    rows = stacks + 1
    for j in range(slices + 1):
        phi = 2 * np.pi * j / slices
        x, z = np.cos(phi), np.sin(phi)
        for r in range(rows):
            v = r / stacks
            p.append([radius * x, -hy + height * v, radius * z])
            n.append([x, 0, z])
            uv.append([j / slices, v])
    for j in range(slices):
        for r in range(stacks):
            a = rows * j + r
            b = a + rows
            idx.extend([[a, b, a + 1], [a + 1, b, b + 1]])
    # caps
    for sign, ny in ((1, 1.0), (-1, -1.0)):
        center = len(p)
        p.append([0, sign * hy, 0])
        n.append([0, ny, 0])
        uv.append([0.5, 0.5])
        ring = len(p)
        for j in range(slices + 1):
            phi = 2 * np.pi * j / slices
            x, z = np.cos(phi), np.sin(phi)
            p.append([radius * x, sign * hy, radius * z])
            n.append([0, ny, 0])
            uv.append([0.5 + 0.5 * x, 0.5 + 0.5 * z])
        for j in range(slices):
            if sign > 0:
                idx.append([center, ring + j + 1, ring + j])
            else:
                idx.append([center, ring + j, ring + j + 1])
    return _mesh(p, n, uv, idx)


def torus_knot_stand_in(radius: float = 0.4, tube: float = 0.18,
                        segments: int = 48, sides: int = 16) -> Mesh:
    """A torus — stand-in 'hero' object for the missing bunny asset."""
    p, n, uv, idx = [], [], [], []
    for i in range(segments + 1):
        u = 2 * np.pi * i / segments
        cu, su = np.cos(u), np.sin(u)
        center = np.array([radius * cu, 0.0, radius * su])
        for j in range(sides + 1):
            v = 2 * np.pi * j / sides
            cv, sv = np.cos(v), np.sin(v)
            normal = np.array([cu * cv, sv, su * cv])
            p.append(center + tube * normal)
            n.append(normal)
            uv.append([i / segments, j / sides])
    for i in range(segments):
        for j in range(sides):
            a = i * (sides + 1) + j
            b = a + sides + 1
            idx.extend([[a, b, a + 1], [a + 1, b, b + 1]])
    return _mesh(p, n, uv, idx)


def grid_mesh(nx: int = 64, nz: int = 64, size_x: float = 1.0,
              size_z: float = 1.0) -> Mesh:
    """Subdivided XZ plane (nx x nz cells), +Y normals, full [0,1] UVs —
    the tessellation base for displaced hero geometry (the reference's
    hero scenes are ~262k-triangle meshes, common.cpp:520-533)."""
    xs = np.linspace(-size_x / 2, size_x / 2, nx + 1, dtype=np.float32)
    zs = np.linspace(-size_z / 2, size_z / 2, nz + 1, dtype=np.float32)
    zz, xx = np.meshgrid(zs, xs, indexing="ij")
    p = np.stack([xx, np.zeros_like(xx), zz], -1).reshape(-1, 3)
    n = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (len(p), 1))
    uv = np.stack([(xx / size_x + 0.5), (zz / size_z + 0.5)], -1).reshape(-1, 2)
    j, i = np.meshgrid(np.arange(nz), np.arange(nx), indexing="ij")
    a = (j * (nx + 1) + i).reshape(-1)
    b = a + 1
    c = a + nx + 1
    d = c + 1
    idx = np.concatenate(
        [np.stack([a, c, b], -1), np.stack([b, c, d], -1)], axis=0
    ).astype(np.int32)
    return _mesh(p, n, uv, idx)


def _value_noise2(u, v, seed: int = 0, octaves: int = 4):
    """Tileable-ish value noise on (u,v) grids — displacement source."""
    out = np.zeros_like(u)
    amp = 1.0
    freq = 4.0
    rs = np.random.RandomState(seed)
    for _ in range(octaves):
        gx = int(freq) + 1
        g = rs.uniform(-1.0, 1.0, size=(gx + 1, gx + 1))
        x = np.clip(u, 0, 1) * freq
        y = np.clip(v, 0, 1) * freq
        x0 = np.floor(x).astype(np.int32)
        y0 = np.floor(y).astype(np.int32)
        fx = x - x0
        fy = y - y0
        fx = fx * fx * (3 - 2 * fx)
        fy = fy * fy * (3 - 2 * fy)
        v00 = g[y0, x0]
        v10 = g[y0, x0 + 1]
        v01 = g[y0 + 1, x0]
        v11 = g[y0 + 1, x0 + 1]
        out = out + amp * (
            v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
            + v01 * (1 - fx) * fy + v11 * fx * fy
        )
        amp *= 0.5
        freq *= 2.0
    return out


def recompute_normals(p: np.ndarray, idx: np.ndarray,
                      fallback: np.ndarray) -> np.ndarray:
    """Smooth vertex normals: area-weighted face-normal average."""
    e1 = p[idx[:, 1]] - p[idx[:, 0]]
    e2 = p[idx[:, 2]] - p[idx[:, 0]]
    fn = np.cross(e1, e2)  # area-weighted
    n = np.zeros_like(p)
    for k in range(3):
        np.add.at(n, idx[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return np.where(ln > 1e-12, n / np.maximum(ln, 1e-12), fallback)


def displace(mesh: Mesh, amplitude: float, seed: int = 0,
             octaves: int = 4) -> Mesh:
    """Displace vertices along their normals by UV-space value noise and
    recompute smooth vertex normals (area-weighted face-normal average)."""
    h = _value_noise2(mesh.uvs[:, 0], mesh.uvs[:, 1], seed, octaves)
    p = mesh.positions + mesh.normals * (h * amplitude)[:, None]
    return _mesh(p, recompute_normals(p, mesh.indices, mesh.normals),
                 mesh.uvs, mesh.indices)


def irregular_grid(n_points: int, size_x: float, size_z: float,
                   seed: int = 0) -> Mesh:
    """Scan-like XZ sheet: nonuniformly scattered interior points +
    boundary ring, Delaunay-triangulated (scipy). Unlike grid_mesh, the
    result has irregular vertex valences, non-repeating triangle shapes
    and a wide edge-length distribution — the topology profile of scanned
    assets (the reference's Sponza is a scanned ~262k-tri mesh,
    common.cpp:520-533) that a regular tessellation cannot stand in for
    when stressing BVH cluster overlap (VERDICT r3 missing #2)."""
    from scipy.spatial import Delaunay

    rs = np.random.RandomState(seed)
    # nonuniform interior density: jittered grid warped by value noise
    g = max(4, int(np.sqrt(n_points)))
    u, v = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g),
                       indexing="ij")
    u = u.ravel()
    v = v.ravel()
    keep_p = 0.55 + 0.45 * _value_noise2(u, v, seed + 1, octaves=3)
    keep = rs.uniform(size=u.shape) < np.clip(keep_p, 0.15, 1.0)
    u, v = u[keep], v[keep]
    jit = 0.45 / g
    u = np.clip(u + rs.uniform(-jit, jit, u.shape), 0.0, 1.0)
    v = np.clip(v + rs.uniform(-jit, jit, v.shape), 0.0, 1.0)
    # boundary ring keeps the rectangle outline exact
    nb = max(4, g // 2)
    t = np.linspace(0, 1, nb, endpoint=False)
    bu = np.concatenate([t, np.ones(nb), 1 - t, np.zeros(nb)])
    bv = np.concatenate([np.zeros(nb), t, np.ones(nb), 1 - t])
    u = np.concatenate([u, bu])
    v = np.concatenate([v, bv])
    xy = np.stack([u, v], -1)
    tri = Delaunay(xy)
    idx = tri.simplices.astype(np.int32)
    # orient CCW when viewed from +Y (x right, z down => flip winding)
    a = xy[idx[:, 0]]
    b = xy[idx[:, 1]]
    c = xy[idx[:, 2]]
    area2 = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
        b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    flip = area2 > 0
    idx[flip] = idx[flip][:, [0, 2, 1]]
    p = np.stack(
        [(u - 0.5) * size_x, np.zeros_like(u), (v - 0.5) * size_z], -1)
    n = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (len(p), 1))
    uv = xy
    return _mesh(p, n, uv, idx)


def scanify(mesh: Mesh, seed: int = 0, jitter: float = 0.30,
            collapse_frac: float = 0.05) -> Mesh:
    """Degrade a regular tessellation into scan-like topology: tangential
    vertex jitter (scaled by local edge length) plus random edge collapses
    that change valences and create the long-thin-triangle population real
    scans have. Every call with a distinct seed yields a topologically
    unique mesh — no two 'scanified' objects share vertex data, unlike
    instanced procedural repetition (VERDICT r3 missing #2)."""
    rs = np.random.RandomState(seed)
    p = mesh.positions.copy()
    idx = mesh.indices.copy()
    V = len(p)

    # average incident edge length per vertex
    edges = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]], idx[:, [2, 0]]])
    el = np.linalg.norm(p[edges[:, 0]] - p[edges[:, 1]], axis=1)
    esum = np.zeros(V)
    ecnt = np.zeros(V)
    np.add.at(esum, edges[:, 0], el)
    np.add.at(ecnt, edges[:, 0], 1.0)
    np.add.at(esum, edges[:, 1], el)
    np.add.at(ecnt, edges[:, 1], 1.0)
    lv = esum / np.maximum(ecnt, 1.0)

    # tangential jitter in the local tangent frame
    n = mesh.normals
    ref = np.where(np.abs(n[:, 1:2]) < 0.9,
                   np.tile([[0.0, 1.0, 0.0]], (V, 1)),
                   np.tile([[1.0, 0.0, 0.0]], (V, 1)))
    t1 = np.cross(n, ref)
    t1 /= np.maximum(np.linalg.norm(t1, axis=1, keepdims=True), 1e-12)
    t2 = np.cross(n, t1)
    a1 = rs.normal(0.0, jitter / 3.0, V).clip(-jitter, jitter) * lv
    a2 = rs.normal(0.0, jitter / 3.0, V).clip(-jitter, jitter) * lv
    p = p + t1 * a1[:, None] + t2 * a2[:, None]

    # random edge collapses (greedy, vertex-disjoint)
    ne = len(edges)
    order = rs.permutation(ne)[: int(ne * collapse_frac * 3)]
    used = np.zeros(V, bool)
    remap = np.arange(V)
    n_collapsed = 0
    target = int(V * collapse_frac)
    for e in order:
        va, vb = int(edges[e, 0]), int(edges[e, 1])
        if used[va] or used[vb] or va == vb:
            continue
        remap[vb] = va
        p[va] = 0.5 * (p[va] + p[vb])
        used[va] = used[vb] = True
        n_collapsed += 1
        if n_collapsed >= target:
            break
    idx = remap[idx]
    keep = ((idx[:, 0] != idx[:, 1]) & (idx[:, 1] != idx[:, 2])
            & (idx[:, 0] != idx[:, 2]))
    idx = idx[keep]

    return _mesh(p, recompute_normals(p, idx, mesh.normals),
                 mesh.uvs, idx)
