"""Hit-point surface fetch with the material maps (reference
scene_descriptor_set.glsl:95-228), as in
``hybrid_rendering_tpu/scene/fetch.py``.

``surface_from_attrs`` builds the Surface from K1's attribute rows (the
path the renderer takes): position = o + t*d, vertex attributes and the
tangent from the row, material constants by index. ``fetch_surface``
gathers from the scene arrays by triangle id instead; it is the JAX
package's CPU path and stays as the reference the attribute path is
checked against. Both sample the atlas for the albedo, normal,
roughness, metallic and emissive maps the scene's materials use; which
maps those are was decided on the host when the material table was made
(``Material.maps``), so no fetch reads a device value back.

Where the scene has an atlas, the maps a fetch samples are one
``sample_atlas`` call, the maps stacked ahead of the lanes, inside the span
``material`` (``utils/profiler.py``); every map adds its lanes to the
counter ``material_samples``. An untextured scene opens no span.
"""
from __future__ import annotations

import dataclasses

import torch

from hybrid_rendering_torch.ops.math3d import cross, dot3, normalize, normalize3
from hybrid_rendering_torch.scene.textures import sample_atlas
from hybrid_rendering_torch.types import MAP_COLUMNS, Hit, SceneArrays, Surface
from hybrid_rendering_torch.utils import profiler


def _maps_to_sample(scene: SceneArrays):
    """The map columns a fetch samples: those some material uses; the
    albedo's alone where the table has no normal-map column."""
    mats = scene.materials
    if scene.atlas is None:
        return ()
    names = MAP_COLUMNS if mats.normal_tex is not None else ("albedo_tex",)
    return tuple(n for n in names if n in mats.maps)


def _sample_maps(scene: SceneArrays, names, mat_id, uv, valid):
    """The maps `names` at each lane as one ``sample_atlas`` call over the
    maps stacked ahead of the lanes: {name: (texture index, texel (..., 4))}.
    Each map's lanes count as ``material_samples``."""
    mats = scene.materials
    idx = torch.stack([_mat_int_col(getattr(mats, n), mat_id) for n in names])
    profiler.count("material_samples", idx.numel())
    k = len(names)
    tex = sample_atlas(scene.atlas, idx, uv.expand(k, *uv.shape),
                       valid=valid.expand(k, *valid.shape))
    return {n: (idx[j], tex[j]) for j, n in enumerate(names)}


def _orient(normal, geo_n, direction):
    """Face-forward the geometric normal against the ray and keep the
    shading normal in its hemisphere. Returns (normal, geo_n, frontface)."""
    frontface = torch.sum(geo_n * direction, dim=-1) <= 0.0
    geo_n = torch.where(frontface[..., None], geo_n, -geo_n)
    flip = (torch.sum(normal * geo_n, dim=-1) < 0.0)[..., None]
    return torch.where(flip, -normal, normal), geo_n, frontface


def _materials(scene: SceneArrays, mat_id):
    m = scene.materials
    idx = mat_id.to(torch.int64)
    return m.albedo[idx], m.roughness[idx], m.metallic[idx], m.emissive[idx]


def surface_from_attrs(scene: SceneArrays, origin, direction, hit: Hit,
                       attrs) -> Surface:
    """Surface from the (..., 24) attribute rows (flashtrace ATTR layout)."""
    w = (1.0 - hit.u - hit.v)[..., None]
    u = hit.u[..., None]
    v = hit.v[..., None]
    normal = normalize(w * attrs[..., 0:3] + u * attrs[..., 3:6] + v * attrs[..., 6:9])
    uv = w * attrs[..., 9:11] + u * attrs[..., 11:13] + v * attrs[..., 13:15]
    valid = hit.valid
    mat_id = torch.where(valid, torch.round(attrs[..., 15]).to(torch.int32), 0)
    mesh_id = torch.round(attrs[..., 16]).to(torch.int32)
    normal, geo_n, frontface = _orient(normal, attrs[..., 17:20], direction)
    albedo, roughness, metallic, emissive = _materials(scene, mat_id)
    surf = Surface(
        position=origin + hit.t[..., None] * direction,
        normal=normal, geo_normal=geo_n, uv=uv, albedo=albedo,
        roughness=roughness, metallic=metallic, emissive=emissive,
        mesh_id=torch.where(valid, mesh_id, -1), mat_id=mat_id,
        frontface=frontface,
    )
    # the tangent travels in lanes 20:24 of the row
    return apply_material_maps(scene, surf, attrs[..., 20:24], valid)


def _mat_int_col(col, mat_id):
    """Per-hit lookup of an int column of the material table."""
    return col[mat_id.to(torch.int64)]


def _select_channel(tex, channel, mat_id):
    """Per-material texel channel (texture_indices1.zw,
    scene_descriptor_set.glsl:204-218); a selector outside 1..3 reads
    channel 0."""
    ch = _mat_int_col(channel, mat_id)
    out = tex[..., 0]
    for c in range(1, 4):
        out = torch.where(ch == c, tex[..., c], out)
    return out


def apply_material_maps(scene: SceneArrays, surf: Surface, tangent4, valid) -> Surface:
    """The material maps, inside the span ``material``: albedo *= the
    albedo map's texel (glTF factor x texture; reference fetch_albedo,
    scene_descriptor_set.glsl:180-196), the tangent-space normal map
    (fetch_normal + get_normal_from_map, :165-196), roughness and metallic
    from their selected channels with the 0.1 roughness floor (:200-218),
    and the emissive map times its factor (:222-228). tangent4: (..., 4)
    [tangent.xyz, bitangent sign]; valid: the hits. Returns `surf` itself
    when the scene has no atlas; a map no material uses is not sampled."""
    names = _maps_to_sample(scene)
    if not names:
        return surf
    with profiler.span("material"):
        return _apply_maps(scene, surf, tangent4, valid, names)


def _apply_maps(scene: SceneArrays, surf: Surface, tangent4, valid, names) -> Surface:
    mats = scene.materials
    mat_id = surf.mat_id
    albedo, normal, roughness = surf.albedo, surf.normal, surf.roughness
    metallic, emissive = surf.metallic, surf.emissive
    maps = _sample_maps(scene, names, mat_id, surf.uv, valid)

    if "albedo_tex" in maps:
        albedo = albedo * maps["albedo_tex"][1][..., :3]

    if "normal_tex" in maps:
        n_idx, tex = maps["normal_tex"]
        tn = tex[..., :3] * 2.0 - 1.0
        # re-orthogonalize the tangent against the interpolated normal
        t = tangent4[..., :3]
        t = normalize3(t - normal * dot3(t, normal)[..., None])
        b = tangent4[..., 3:4] * cross(normal, t)
        mapped = normalize3(tn[..., 0:1] * t + tn[..., 1:2] * b + tn[..., 2:3] * normal)
        normal = torch.where(((n_idx >= 0) & valid)[..., None], mapped, normal)

    if "roughness_tex" in maps:
        r_idx, tex = maps["roughness_tex"]
        r_tex = _select_channel(tex, mats.roughness_channel, mat_id)
        roughness = torch.where((r_idx >= 0) & valid, torch.clamp(r_tex, min=0.1), roughness)

    if "metallic_tex" in maps:
        m_idx, tex = maps["metallic_tex"]
        m_tex = _select_channel(tex, mats.metallic_channel, mat_id)
        metallic = torch.where((m_idx >= 0) & valid, m_tex, metallic)

    if "emissive_tex" in maps:
        e_idx, tex = maps["emissive_tex"]
        emissive = torch.where(((e_idx >= 0) & valid)[..., None], emissive * tex[..., :3],
                               emissive)

    return dataclasses.replace(surf, albedo=albedo, normal=normal, roughness=roughness,
                               metallic=metallic, emissive=emissive)


def fetch_surface(scene: SceneArrays, origin, direction, hit: Hit) -> Surface:
    """Interpolate surface attributes at hits by gathering the hit
    triangle's rows. Misses return safe dummy values (mask with
    hit.valid downstream)."""
    tid = torch.clamp(hit.tri_id, 0, scene.num_triangles - 1).to(torch.int64)
    w = (1.0 - hit.u - hit.v)[..., None]
    u = hit.u[..., None]
    v = hit.v[..., None]
    tp = scene.tri_pos[tid]
    tn = scene.tri_normal[tid]
    tuv = scene.tri_uv[tid]
    position = w * tp[..., 0, :] + u * tp[..., 1, :] + v * tp[..., 2, :]
    normal = normalize(w * tn[..., 0, :] + u * tn[..., 1, :] + v * tn[..., 2, :])
    uv = w * tuv[..., 0, :] + u * tuv[..., 1, :] + v * tuv[..., 2, :]
    geo_n = normalize(cross(tp[..., 1, :] - tp[..., 0, :], tp[..., 2, :] - tp[..., 0, :]))
    normal, geo_n, frontface = _orient(normal, geo_n, direction)
    mat_id = scene.tri_mat[tid]
    albedo, roughness, metallic, emissive = _materials(scene, mat_id)
    surf = Surface(
        position=position, normal=normal, geo_normal=geo_n, uv=uv,
        albedo=albedo, roughness=roughness, metallic=metallic,
        emissive=emissive, mesh_id=scene.tri_mesh_id[tid], mat_id=mat_id,
        frontface=frontface,
    )
    return apply_material_maps(scene, surf, scene.tri_tangent[tid], hit.valid)
