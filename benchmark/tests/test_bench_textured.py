"""The textured hall's cell, ``sponza_pbr-1080p.fly``, on the CPU:

- the atlas at the cell's height: 72 maps of 1,024 rows by 256 columns
  shelf-pack one a shelf, 73,728 rows high, as the cell's 1024² maps do,
  and the program's ``sample_atlas`` equals the reference's bit for bit on
  seeded UVs at rect edges and wraps, past row 65,536, where a float32
  texel coordinate moves in steps of 1/128 texel;
- the cell's own readers on a made-up record: the ``material`` spans and
  the ``material_samples`` counter summed over every path, and nothing
  where the record holds neither.

The cell's small copy runs through the parametrised sound-run, control
and traced tests of the other cells."""
import numpy as np
import pytest
import torch

from hrbench import cells
from hrref.scene import textures as ref_textures

MAPS, ROWS, COLS = 72, 1024, 256


def _uv(g, n):
    """Seeded UVs, each coordinate a wrap plus an offset at a rect's edge
    (0, just inside 0 and 1, half a texel either side) or anywhere."""
    edges = torch.tensor([0.0, 1e-7, 0.5 / ROWS, 0.5 / COLS, 0.5, 1 - 0.5 / ROWS,
                          1 - 0.5 / COLS, 1 - 1e-7])
    wraps = torch.randint(-3, 4, (n, 2), generator=g).float()
    at_edge = edges[torch.randint(0, len(edges), (n, 2), generator=g)]
    anywhere = torch.rand(n, 2, generator=g)
    pick = torch.rand(n, 2, generator=g) < 0.5
    return wraps + torch.where(pick, at_edge, anywhere)


def test_sample_atlas_on_73728_rows_equals_the_reference():
    from hybrid_rendering_torch.scene import textures

    rs = np.random.RandomState(2**31 % 4093)
    b = textures.AtlasBuilder()
    for _ in range(MAPS):
        b.add(rs.uniform(0.0, 1.0, (ROWS, COLS, 4)).astype(np.float32))
    atlas = b.build()
    assert tuple(atlas.image.shape) == (MAPS * ROWS, COLS, 4)
    assert torch.equal(atlas.rects[:, 1], torch.arange(MAPS).float() * ROWS)
    ref = ref_textures.TextureAtlas(image=atlas.image, rects=atlas.rects)

    g = torch.Generator().manual_seed(2**31 + 29)
    n = 200_000
    uv = _uv(g, n)
    tex = torch.randint(-1, MAPS, (n,), generator=g, dtype=torch.int32)
    tex[:1000] = MAPS - 1  # the last map, rows 72,704-73,727
    valid = torch.rand(n, generator=g) < 0.9
    got = textures.sample_atlas(atlas, tex, uv, valid=valid)
    want = ref_textures.sample_atlas(ref, tex, uv, valid=valid)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())
    # where a texel coordinate lies past 2^16 rows, float32 steps by 1/128
    y = torch.tensor([65535.0, 65536.0, float(MAPS * ROWS - 1)])
    assert (torch.nextafter(y, y + 1) - y).tolist() == [2.0**-8, 2.0**-7, 2.0**-7]
    # the taps reach the last rows
    last = tex == MAPS - 1
    assert bool((got[last & valid] != 1.0).any())


def _record(program):
    rec = {"frames": 4}
    if program is not None:
        rec["program"] = program
    return rec


def test_material_readers():
    """``span_ms.material`` sums the host wall of every span path ending in
    ``/material`` and ``material_samples_per_frame`` the counter at every
    path, a frame; an untextured scene's record, which holds neither, and a
    run without the program's record read nothing."""
    fetches = ("render_frame/gbuffer/closest", "render_frame/ddgi.update/trace/closest",
               "render_frame/reflections/ray_trace/closest")
    spans = {p: {"calls": 4, "host_s": 0.1, "self_s": 0.0} for p in fetches}
    spans.update({f"{p}/material": {"calls": 4, "host_s": 0.02 * (i + 1), "self_s": 0.02}
                  for i, p in enumerate(fetches)})
    samples = {f"{p}/material": 4 * n for p, n in zip(fetches, (1000, 300, 250))}
    got = _record({"spans": spans, "counters": {"rays": {}, "material_samples": samples}})
    assert cells.reader("span_ms.material")(got) == pytest.approx(30.0)
    assert cells.reader("material_samples_per_frame")(got) == 1550.0
    untextured = _record({"spans": {p: spans[p] for p in fetches}, "counters": {"rays": {}}})
    for name in ("span_ms.material", "material_samples_per_frame"):
        assert cells.reader(name)(untextured) is None
        assert cells.reader(name)(_record(None)) is None
