"""PyTorch port vs JAX package: the pieces of DDGI. The uint32 RNG (bit
for bit), the octahedral codec, the probe grid, the bridge's state
converters, the plain version of kernel K5 (``models/ddgi.sample_irradiance``) against the JAX exact
sampler on random atlases, and the K5 wrapper's device rules. Inputs come
from numpy with fixed seeds. ``ddgi_update`` itself is held to the JAX
package in test_torch_ddgi_update.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rendering_tpu import config as jcfg
from hybrid_rendering_tpu.models import ddgi as jddgi
from hybrid_rendering_tpu.models import reflections as jrefl
from hybrid_rendering_tpu.ops import octahedral as joct
from hybrid_rendering_tpu.ops import rng as jrng
from hybrid_rendering_torch import bridge
from hybrid_rendering_torch import config as tcfg
from hybrid_rendering_torch.models import ddgi as tddgi
from hybrid_rendering_torch.ops import ddgi_sample as tds
from hybrid_rendering_torch.ops import octahedral as toct
from hybrid_rendering_torch.ops import rng as trng

# float32 chains evaluated by XLA and by PyTorch's CPU kernels: a few ulp
K5_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _u32(rs, n):
    return rs.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def _unit(rs, n):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# RNG, octahedral codec, Fibonacci rays, rotation
# ---------------------------------------------------------------------------


def test_rng_hash_and_unit_float_equal_jax():
    rs = np.random.RandomState(0)
    seeds = _u32(rs, 100_000)
    got = trng.wang_hash(_t(seeds.astype(np.int64)))
    ref = np.asarray(jrng.wang_hash(jnp.asarray(seeds)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    f_got = trng.uint_to_unit_float(_t(seeds.astype(np.int64))).numpy()
    f_ref = np.asarray(jrng.uint_to_unit_float(jnp.asarray(seeds)))
    np.testing.assert_array_equal(f_got.view(np.uint32), f_ref.view(np.uint32))


def test_rng_streams_equal_jax():
    """rng_init + next_uint / next_float / next_vec2 on 10^5 pixels with
    frame indices up to 2^31: every draw equal to the bit."""
    rs = np.random.RandomState(1)
    n = 100_000
    x, y = _u32(rs, n), _u32(rs, n)
    frames = rs.randint(0, 2 ** 31, size=n).astype(np.uint32)
    jr = jrng.rng_init(jnp.asarray(x), jnp.asarray(y), jnp.asarray(frames))
    tr = trng.rng_init(_t(x.astype(np.int64)), _t(y.astype(np.int64)),
                       _t(frames.astype(np.int64)))
    for _ in range(3):
        jr, ju = jrng.next_uint(jr)
        tr, tu = trng.next_uint(tr)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju).astype(np.int64))
        jr, jf = jrng.next_float(jr)
        tr, tf = trng.next_float(tr)
        np.testing.assert_array_equal(tf.numpy().view(np.uint32), np.asarray(jf).view(np.uint32))
        jr, jv = jrng.next_vec2(jr)
        tr, tv = trng.next_vec2(tr)
        np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv).view(np.uint32))
    # a Python-int frame index broadcasts like the JAX scalar
    jr = jrng.rng_init(jnp.asarray(x[:64]), jnp.asarray(y[:64]), 2 ** 31 - 1)
    tr = trng.rng_init(_t(x[:64].astype(np.int64)), _t(y[:64].astype(np.int64)), 2 ** 31 - 1)
    np.testing.assert_array_equal(tr.s0.numpy(), np.asarray(jr.s0).astype(np.int64))
    np.testing.assert_array_equal(tr.s1.numpy(), np.asarray(jr.s1).astype(np.int64))


def test_random_rotation_matches_jax():
    for f in range(64):
        got = tddgi._random_rotation(f).numpy()
        np.testing.assert_allclose(got, np.asarray(jddgi._random_rotation(f)), atol=1e-6,
                                   err_msg=f"frame {f}")
        np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-5)


def test_octahedral_and_fibonacci_match_jax():
    rs = np.random.RandomState(2)
    d = np.concatenate([_unit(rs, 4096), np.eye(3, dtype=np.float32),
                        -np.eye(3, dtype=np.float32)])
    np.testing.assert_allclose(toct.direction_to_octahedral(_t(d)).numpy(),
                               np.asarray(joct.direction_to_octahedral(jnp.asarray(d))),
                               atol=1e-6)
    e = rs.uniform(-1, 1, size=(4096, 2)).astype(np.float32)
    np.testing.assert_allclose(toct.octahedral_to_direction(_t(e)).numpy(),
                               np.asarray(joct.octahedral_to_direction(jnp.asarray(e))),
                               atol=1e-6)
    for n in (64, 128, 256):
        np.testing.assert_allclose(tddgi._spherical_fibonacci(n),
                                   jddgi._spherical_fibonacci(n), atol=1e-6)
    for side in (8, 16):
        np.testing.assert_allclose(tddgi._texel_directions(side).numpy(),
                                   np.asarray(jddgi._texel_directions(side)), atol=1e-6)


@pytest.mark.parametrize("layout", ["padded", "interior"])
def test_probe_grid_matches_jax(layout):
    lo, hi = [-6.0, -0.5, -5.0], [7.5, 10.0, 6.0]
    jg = jddgi.make_probe_grid(lo, hi, jcfg.DDGIConfig(grid_layout=layout, probe_distance=1.5))
    tg = tddgi.make_probe_grid(lo, hi, tcfg.DDGIConfig(grid_layout=layout, probe_distance=1.5))
    assert tg.counts == tuple(jg.counts) and tg.num_probes == jg.num_probes
    np.testing.assert_array_equal(tg.start, np.asarray(jg.start))
    np.testing.assert_array_equal(tg.step, np.asarray(jg.step))
    assert tg.max_distance == pytest.approx(float(jg.max_distance))
    np.testing.assert_array_equal(tddgi.probe_positions(tg).numpy(),
                                  np.asarray(jddgi.probe_positions(jg)))
    _assert_same_grid(bridge.probe_grid_from_jax(jg), tg)


def test_state_converters_carry_jax_state():
    """The bridge copies the JAX DDGI and reflections state exactly, so a
    test can seed both packages with the same state; a DDGIState without
    accum_frames counts as no accumulated frames, as in ddgi_update."""
    rs = np.random.RandomState(7)

    def arr(*shape):
        return jnp.asarray(rs.uniform(size=shape), jnp.float32)

    jdd = jddgi.DDGIState(irradiance=arr(5, 8, 8, 3), depth=arr(5, 16, 16, 2),
                          first_frame=jnp.int32(0), accum_frames=jnp.int32(9))
    tdd = bridge.ddgi_state_from_jax(jdd)
    for plane in ("irradiance", "depth"):
        np.testing.assert_array_equal(getattr(tdd, plane).numpy(),
                                      np.asarray(getattr(jdd, plane)))
    assert (tdd.first_frame, tdd.accum_frames) == (0, 9)
    assert bridge.ddgi_state_from_jax(jdd.replace(accum_frames=None)).accum_frames == 0
    jrs = jrefl.ReflectionsState(history=arr(6, 8, 3), moments=arr(6, 8, 2),
                                 history_length=arr(6, 8))
    trs = bridge.reflections_state_from_jax(jrs)
    for field in ("history", "moments", "history_length"):
        np.testing.assert_array_equal(getattr(trs, field).numpy(),
                                      np.asarray(getattr(jrs, field)))


def _assert_same_grid(a, b):
    assert a.counts == b.counts and a.max_distance == pytest.approx(b.max_distance)
    np.testing.assert_array_equal(a.start, b.start)
    np.testing.assert_array_equal(a.step, b.step)


# ---------------------------------------------------------------------------
# Plain K5 vs the JAX exact sampler
# ---------------------------------------------------------------------------

# normals on the octahedral seams: the fold (z = 0), the axes and the
# corners of the map, where taps wrap
SEAM_DIRS = np.asarray(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
     [1, 1, 0], [1, -1, 0], [-1, 1, 0], [0, 1, -1], [1, 0, -1], [-1, -1, -1],
     [1, 1, -1e-7], [0.5, -0.5, -0.7071]], np.float32)


def _points(grid, rs, n):
    """Points over the grid's bounds widened by 30% on each side (some
    fall outside the cage and take the clamped cell), normals random or on
    the octahedral seams, view directions random."""
    hi = grid.start + (np.asarray(grid.counts) - 1) * grid.step
    ext = hi - grid.start
    p = rs.uniform(grid.start - 0.3 * ext, hi + 0.3 * ext, size=(n, 3)).astype(np.float32)
    nrm = _unit(rs, n)
    seams = SEAM_DIRS / np.linalg.norm(SEAM_DIRS, axis=1, keepdims=True)
    k = n // 4
    nrm[:k] = seams[rs.randint(0, len(seams), k)]
    return p, nrm, _unit(rs, n)


def _jax_sample(jgrid, jstate, cfg, p, n, wo):
    return np.asarray(jddgi.sample_irradiance(jgrid, jstate, cfg, jnp.asarray(p),
                                              jnp.asarray(n), jnp.asarray(wo)))


@pytest.mark.parametrize("visibility", [True, False])
def test_plain_k5_matches_jax_on_random_atlases(visibility):
    rs = np.random.RandomState(3)
    kw = dict(probe_distance=1.0, normal_bias=0.25, visibility_test=visibility)
    jc, tc = jcfg.DDGIConfig(**kw), tcfg.DDGIConfig(**kw)
    jgrid = jddgi.make_probe_grid([-5.0, -0.1, -5.0], [5.0, 10.0, 5.0], jc)
    P = jgrid.num_probes
    mean = rs.uniform(0.2, 1.5 * jgrid.max_distance, size=(P, 16, 16)).astype(np.float32)
    jstate = jddgi.DDGIState(
        irradiance=jnp.asarray(rs.uniform(0.0, 2.0, size=(P, 8, 8, 3)), jnp.float32),
        depth=jnp.asarray(np.stack([mean, mean * mean + rs.uniform(0, 2, mean.shape)], -1),
                          jnp.float32),
        first_frame=jnp.int32(0), accum_frames=jnp.int32(7))
    p, n, wo = _points(jgrid, rs, 8192)
    got = tddgi.sample_irradiance(bridge.probe_grid_from_jax(jgrid),
                                  bridge.ddgi_state_from_jax(jstate), tc, _t(p), _t(n), _t(wo))
    ref = _jax_sample(jgrid, jstate, jc, p, n, wo)
    assert np.isfinite(ref).all() and ref.std() > 0.01
    np.testing.assert_allclose(got.numpy(), ref, atol=K5_TOL, rtol=K5_TOL)


# ---------------------------------------------------------------------------
# K5 wrapper: CPU tensors take the plain version, other devices are refused
# ---------------------------------------------------------------------------


def _small_grid_state():
    cfg = tcfg.DDGIConfig(probe_distance=2.0)
    grid = tddgi.make_probe_grid([-2.0, 0.0, -2.0], [2.0, 2.0, 2.0], cfg)
    state = tddgi.DDGIState.create(grid.num_probes, cfg)
    state.irradiance += 0.5
    state.depth[..., 0] = 1.0
    state.depth[..., 1] = 1.5
    return cfg, grid, state


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    cfg, grid, state = _small_grid_state()
    p, n, wo = (_t(a) for a in _points(grid, np.random.RandomState(5), 64))
    sampler = tds.make_irradiance_sampler(grid, cfg)
    got = sampler(state, p.reshape(8, 8, 3), n.reshape(8, 8, 3), wo.reshape(8, 8, 3),
                  valid=torch.ones(8, 8, dtype=torch.bool))
    assert got.shape == (8, 8, 3)
    ref = tddgi.sample_irradiance(grid, state, cfg, p, n, wo)
    torch.testing.assert_close(got.reshape(64, 3), ref, rtol=0, atol=0)
    assert tds.sample_irradiance.launches == 0


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on the card is
    refused, never silently sampled by the plain version."""
    cfg, grid, state = _small_grid_state()
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        tds.sample_irradiance(grid, state, cfg, x, x, x)
    assert tds.sample_irradiance.launches == 0


# ---------------------------------------------------------------------------
# K5's arithmetic where it departs from the plain version's shape
# ---------------------------------------------------------------------------


def _hoisted_taps(dirs, S):
    """What K5 computes once a point from the normal: the four tap offsets
    inside a probe's tile (the wrap passes skipped where all four taps lie
    inside the tile) and the bilinear fractions."""
    oct_ = toct.direction_to_octahedral(dirs)
    tx = (oct_[..., 0] * 0.5 + 0.5) * S - 0.5
    ty = (oct_[..., 1] * 0.5 + 0.5) * S - 0.5
    fx, fy = tx - torch.floor(tx), ty - torch.floor(ty)
    x0 = tddgi._finite_floor(tx).to(torch.int64)
    y0 = tddgi._finite_floor(ty).to(torch.int64)
    inside = (x0 >= 0) & (x0 < S - 1) & (y0 >= 0) & (y0 < S - 1)
    offsets = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xw, yw = tddgi._wrap_oct_coords(x0 + dx, y0 + dy, S)
        offsets.append(torch.where(inside, (y0 + dy) * S + (x0 + dx), yw * S + xw))
    return offsets, (fx[..., None], fy[..., None])


def _hoisted_blend(atlas, probe_idx, offsets, fracs):
    """The blend of one probe's tile at hoisted taps, each product taken
    left to right as ``oct_bilinear_sample`` takes it."""
    P, S, _, C = atlas.shape
    flat = atlas.reshape(P * S * S, C)
    fx, fy = fracs
    t00, t10, t01, t11 = (flat[probe_idx * (S * S) + o] for o in offsets)
    return (t00 * (1 - fx) * (1 - fy) + t10 * fx * (1 - fy)
            + t01 * (1 - fx) * fy + t11 * fx * fy)


@pytest.mark.parametrize("side,channels", [(8, 3), (16, 2)])
def test_hoisted_k5_taps_equal_oct_bilinear_sample(side, channels):
    """K5 takes the normal's taps and fractions once a point and reuses
    them for the eight probes of the cage: bit for bit what
    ``oct_bilinear_sample`` gives probe by probe, on random directions, on
    the octahedral seams (where taps wrap) and on a zero vector."""
    rs = np.random.RandomState(21)
    n = 4096
    dirs = _unit(rs, n)
    seams = SEAM_DIRS / np.linalg.norm(SEAM_DIRS, axis=1, keepdims=True)
    dirs[:1024] = seams[rs.randint(0, len(seams), 1024)]
    dirs[1024:1032] = 0.0
    P = 40
    atlas = _t(rs.uniform(0.0, 2.0, size=(P, side, side, channels)).astype(np.float32))
    probes = _t(rs.randint(0, P, size=(n, 8)))
    offsets, fracs = _hoisted_taps(_t(dirs), side)
    wrapped = sum(int((o != offsets[0] + k).sum()) for o, k in
                  zip(offsets, (0, 1, side, side + 1)))
    assert wrapped > 100  # both address paths are taken
    for c in range(8):
        ref = tddgi.oct_bilinear_sample(atlas, probes[:, c], _t(dirs))
        got = _hoisted_blend(atlas, probes[:, c], offsets, fracs)
        assert torch.equal(got, ref), f"corner {c}"


def test_k5_shared_square_root_equals_the_two_of_the_plain_version():
    """K5 takes one square root for ``normalize3(-probe_to_point)`` and the
    distance: the plain version's two clamps (1e-20, 1e-12) differ only
    below 1e-12, where the distance is the clamp's own root."""
    rs = np.random.RandomState(22)
    v = rs.normal(size=(4096, 3)).astype(np.float32)
    v[:512] *= np.float32(1e-7)  # squared lengths around and below 1e-12
    v[512:520] = 0.0
    v = _t(v)
    dd = v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
    length = torch.sqrt(torch.clamp(dd, min=1e-20))
    dist = torch.where(dd >= 1e-12, length, torch.sqrt(torch.tensor(1e-12)))
    assert torch.equal(dist, torch.sqrt(torch.clamp(dd, min=1e-12)))
    assert ((dd < 1e-12).sum() > 8) and ((dd >= 1e-12).sum() > 3000)
    # -normalize3(-v) is v / length: negation is exact
    from hybrid_rendering_torch.ops.math3d import normalize3
    assert torch.equal(-normalize3(-v), v / length[:, None])


def test_sampler_keeps_its_scalars_and_matches_a_direct_call():
    """``make_irradiance_sampler`` works the kernel's scalar arguments out
    once; they are what a direct call works out, in the C signature's
    order."""
    cfg, grid, state = _small_grid_state()
    scalars = tds._scalars(grid, cfg)
    assert scalars[:5] == (cfg.irradiance_oct_size, cfg.depth_oct_size) + tuple(grid.counts)
    assert scalars[5:11] == tuple(float(v) for v in grid.start) + tuple(float(v) for v in grid.step)
    assert scalars[11:] == (cfg.normal_bias, cfg.energy_preservation, int(cfg.visibility_test))
    assert len(scalars) == 14 and all(isinstance(v, (int, float)) for v in scalars)
