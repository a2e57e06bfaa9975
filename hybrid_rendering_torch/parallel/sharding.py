"""The row layout of a multi-device frame.

Port of ``hybrid_rendering_tpu/parallel/sharding.py``. In the JAX package
``frame_shardings`` places the frame: every (H, W, ...) plane row-sharded
over the tiles axis, everything else replicated, and GSPMD inserts the
stencils' halo exchanges. PyTorch has no GSPMD, so in the port
``frame_shardings`` is a layout: it names the planes a multi-card run
would split. The frame itself runs on the mesh's first device, where
``shard_frame_state`` puts its state; only the tracers shard their rays
(``parallel/trace.py``).
"""
from __future__ import annotations

import torch

from hybrid_rendering_torch.parallel.mesh import (
    TILE_AXIS, Mesh, replicated, row_sharding, to_device, tree_map)


def _leaf_sharding(leaf, mesh: Mesh, heights):
    n = mesh.shape[TILE_AXIS]
    if isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 and leaf.shape[0] in heights \
            and leaf.shape[0] % n == 0:
        return row_sharding(mesh)
    return replicated(mesh)


def frame_shardings(tree, mesh: Mesh, height: int):
    """The tree's layout: the same tree with a ``Sharding`` for each leaf,
    row-sharded where a tensor has at least 2 dims, its leading dim is an
    image height (full, half or quarter res) and that dim divides by the
    mesh size; replicated otherwise (Python numbers such as
    ``frame_index`` included). A None stays None, as in a JAX pytree."""
    heights = {height, height // 2, height // 4}
    return tree_map(lambda leaf: None if leaf is None else _leaf_sharding(leaf, mesh, heights),
                    tree)


def shard_frame_state(state, mesh: Mesh, height: int):
    """`state` on ``mesh.devices[0]``, where the frame runs (a tensor
    already there is kept, not copied). ``frame_shardings(state, mesh,
    height)`` names the planes a multi-card run would split; this port
    places them all on the first device."""
    del height  # a layout places nothing in the port
    return to_device(state, mesh.devices[0])
