"""The reference's copy of ``sponza_pbr_small``: ``sponza_pbr`` with 64²
maps, the scene of the cell's small copy on the CPU."""
from hrref.scene.extra import sponza_pbr


def build(use_bvh=True):
    return sponza_pbr.build(use_bvh=use_bvh, map_size=64)
