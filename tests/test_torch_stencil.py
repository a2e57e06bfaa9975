"""PyTorch port vs JAX package: the denoiser stencils, i.e. the plain
versions of kernels K3 (SVGF à-trous chain) and K4 (separable bilateral
blur), against the JAX filters (the JAX package's CPU path) and against
the Pallas kernels themselves in interpret mode."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rendering_tpu.ops import filters as jfilters
from hybrid_rendering_tpu.ops.pallas import stencil as jstencil
from hybrid_rendering_torch.ops import stencil as tstencil

# float32 sums of 9 (K3) or 9x9 (K4) weighted taps, reordered between XLA
# and PyTorch, over four chained iterations
ATOL = 2e-5


def _inputs(H, W, C=1, seed=0):
    """Random planes with piecewise-flat normals and depth, so the edge
    stops have real structure, and a masked-out corner."""
    rs = np.random.RandomState(seed)
    shape = (H, W) if C == 1 else (H, W, C)
    color = rs.uniform(0, 1, shape).astype(np.float32)
    if C == 3:
        color[H // 3:H // 2, : W // 4] = 0.0  # luma below the 1e-4 floor
    var = rs.uniform(0, 0.1, (H, W)).astype(np.float32)
    n = rs.normal(size=(H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:, : W // 2] = [0, 1, 0]
    depth = rs.uniform(1, 10, (H, W)).astype(np.float32)
    depth[: H // 2] = 2.0
    mask = np.ones((H, W), bool)
    mask[:4, :4] = False
    return color, var, n, depth, mask


@functools.partial(jax.jit, static_argnames=("steps", "feedback_iteration", "radius",
                                             "phi_color", "phi_normal", "sigma_depth"))
def _jax_chain_jit(c, v, n, depth, mask, steps, feedback_iteration=1, **kw):
    fb = c
    for i, s in enumerate(steps):
        c, v = jfilters.atrous_iteration(c, v, n, depth, step=s, mask=mask, **kw)
        if i == feedback_iteration:
            fb = c
    return c, fb, v


def _jax_chain(*arrays, steps, **kw):
    out = _jax_chain_jit(*(jnp.asarray(a) for a in arrays), steps=steps, **kw)
    return [np.asarray(o) for o in out]


def _port_chain(color, var, n, depth, mask, steps, **kw):
    out = tstencil.atrous_chain(*(torch.from_numpy(a) for a in (color, var, n, depth, mask)),
                                steps=steps, **kw)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("steps", [(1, 2), (1, 2, 4, 8)])
def test_plain_k3_matches_jax_filters_chain(C, steps):
    inp = _inputs(48, 64, C, seed=C)
    ref = _jax_chain(*inp, steps=steps)
    got = _port_chain(*inp, steps)
    for name, g, r in zip(("final", "feedback", "variance"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=ATOL, err_msg=name)


def test_plain_k3_options_match_jax():
    """Radius 2, other weights, and a feedback iteration past the chain's
    end (history keeps the unfiltered input, as in the JAX chains)."""
    inp = _inputs(40, 56, 1, seed=5)
    kw = dict(radius=2, phi_color=4.0, phi_normal=16.0, sigma_depth=0.5)
    ref = _jax_chain(*inp, steps=(1, 2), feedback_iteration=5, **kw)
    got = _port_chain(*inp, (1, 2), feedback_iteration=5, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL)
    np.testing.assert_array_equal(got[1], inp[0])


@pytest.mark.parametrize("C", [1, 3])
def test_plain_k3_matches_pallas_interpret(C):
    inp = _inputs(16, 24, C, seed=11)
    steps = (1, 2, 4, 8)
    ref = jstencil.atrous_chain(*(jnp.asarray(a) for a in inp), steps=steps, interpret=True)
    got = _port_chain(*inp, steps)
    for name, g, r in zip(("final", "feedback", "variance"), got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("radius", [2, 4])
def test_plain_k4_matches_jax_bilateral(radius):
    img, _, n, depth, mask = _inputs(48, 64, 1, seed=radius)
    blur = jax.jit(jfilters.bilateral_blur_separable, static_argnames=("radius",))
    ref = blur(jnp.asarray(img), jnp.asarray(n), jnp.asarray(depth), radius=radius,
               mask=jnp.asarray(mask))
    got = tstencil.bilateral_blur(*(torch.from_numpy(a) for a in (img, n, depth, mask)),
                                  radius=radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(got.numpy()[~mask], img[~mask])


def test_plain_k4_matches_pallas_interpret():
    img, _, n, depth, mask = _inputs(16, 24, 1, seed=9)
    ref = jstencil.bilateral_blur(*(jnp.asarray(a) for a in (img, n, depth, mask)),
                                  radius=4, interpret=True)
    got = tstencil.bilateral_blur(*(torch.from_numpy(a) for a in (img, n, depth, mask)),
                                  radius=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    color, var, n, depth, mask = (torch.from_numpy(a) for a in _inputs(16, 24))
    tstencil.atrous_chain(color, var, n, depth, mask, steps=(1, 2))
    tstencil.bilateral_blur(color, n, depth, mask, radius=4)
    assert tstencil.atrous_chain.launches == 0
    assert tstencil.bilateral_blur.launches == 0


def test_wrappers_refuse_other_devices():
    x = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="meta"):
        tstencil.bilateral_blur(x, torch.zeros((8, 8, 3), device="meta"), x,
                                torch.ones((8, 8), dtype=torch.bool, device="meta"))


# ---------------------------------------------------------------------------
# K3 on the card: the folded weights and the launch plan, as far as the CPU
# can hold them
# ---------------------------------------------------------------------------

LOG2E = np.float32(1.4426950408889634)
K3_TOL = 1e-4  # chip_smoke.py K3_TOL: the kernel against the plain version


def _folded_iteration(color, variance, normal, depth, mask, step, radius, phi_color,
                      phi_normal, sigma_depth):
    """One à-trous iteration with the weights as csrc/stencil.cu forms them,
    in float32: w = k n^phi_n exp2(-|dz| rz - |dl| rl) with reciprocal
    multiplies; n^32 by five squarings, any other power as phi_n log2(n) +
    log2(k) inside the exponential."""
    from hybrid_rendering_torch.ops import filters
    from hybrid_rendering_torch.ops.math3d import luminance

    single = color.ndim == 2
    cimg = color[..., None] if single else color
    luma = color if single else luminance(cimg)
    vb = filters.box_filter_sum(variance, 1) / 9.0
    phi_l = torch.clamp(phi_color * torch.sqrt(torch.clamp(vb, min=1e-10)), min=1e-6)
    rl = float(LOG2E) / phi_l
    rz = float(LOG2E / np.float32(filters.depth_phi(sigma_depth, step)))
    sum_c, sum_v, sum_w = torch.zeros_like(cimg), torch.zeros_like(variance), torch.zeros_like(variance)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            k = filters._ATROUS_KERNEL[abs(dy)] * filters._ATROUS_KERNEL[abs(dx)]
            sh = lambda x: filters.shift2d(x, dy * step, dx * step)
            nd = torch.clamp((normal * sh(normal)).sum(-1), 0.0, 1.0)
            e = -torch.abs(depth - sh(depth)) * rz - torch.abs(luma - sh(luma)) * rl
            if phi_normal == 32.0:
                n32 = nd
                for _ in range(5):
                    n32 = n32 * n32
                w = np.float32(k) * n32 * torch.exp2(e)
            else:
                e = e + float(np.float32(np.log2(k)))
                if phi_normal != 0.0:
                    e = e + phi_normal * torch.log2(nd)  # log2(0) = -inf: weight 0
                w = torch.exp2(e)
            sum_c = sum_c + sh(cimg) * w[..., None]
            sum_v = sum_v + sh(variance) * w * w
            sum_w = sum_w + w
    inv = 1.0 / torch.clamp(sum_w, min=1e-8)
    out_c = torch.where(mask[..., None], sum_c * inv[..., None], cimg)
    out_v = torch.where(mask, sum_v / torch.clamp(sum_w * sum_w, min=1e-8), variance)
    return (out_c[..., 0] if single else out_c), out_v


def _hard_inputs(C, seed):
    """_inputs plus what stresses the folded weights: zero normals (a
    normal dot of exactly 0), opposed normals, a patch of zero variance
    (phi_l at its 1e-6 floor) and, for C=3, black pixels."""
    color, var, n, depth, mask = _inputs(40, 56, C, seed=seed)
    n[5:9, 30:40] = 0.0
    n[20:24, 30:40] = -n[20:24, 29:30]
    var[25:, 20:] = 0.0
    mask[30, :] = False
    return tuple(torch.from_numpy(a) for a in (color, var, n, depth, mask))


@pytest.mark.parametrize("phi_normal", [32.0, 8.0])
@pytest.mark.parametrize("C", [1, 3])
def test_folded_k3_weights_match_plain_chain(C, phi_normal):
    color, var, n, depth, mask = _hard_inputs(C, seed=20 + C)
    steps = (1, 2, 4, 8)
    kw = dict(radius=1, phi_color=10.0, phi_normal=phi_normal, sigma_depth=1.0)
    ref = tstencil.atrous_chain_plain(color, var, n, depth, mask, steps=steps, **kw)
    c, v, fb = color, var, color
    for i, step in enumerate(steps):
        c, v = _folded_iteration(c, v, n, depth, mask, step, **kw)
        if i == 1:
            fb = c
    for name, got, want in zip(("final", "feedback", "variance"), (c, fb, v), ref):
        assert torch.isfinite(got).all(), name
        assert (got - want).abs().max().item() <= K3_TOL, name
    # what the stress patches are there for
    assert (var[25:, 20:] == 0).all() and (n[5:9, 30:40] == 0).all()


def test_folded_k3_weights_other_powers():
    """phi_normal that is no 32 (and 0: pow(x, 0) = 1 even at x = 0) goes
    through log2 inside the exponential."""
    color, var, n, depth, mask = _hard_inputs(1, seed=31)
    for phi_n in (16.0, 5.5, 0.0):
        kw = dict(radius=2, phi_color=4.0, phi_normal=phi_n, sigma_depth=0.5)
        ref = tstencil.atrous_chain_plain(color, var, n, depth, mask, steps=(2,),
                                          feedback_iteration=0, **kw)
        c, v = _folded_iteration(color, var, n, depth, mask, 2, **kw)
        assert (c - ref[0]).abs().max().item() <= K3_TOL, phi_n
        assert (v - ref[2]).abs().max().item() <= K3_TOL, phi_n


@pytest.mark.parametrize("steps,radius,want", [
    ((1, 2, 4, 8), 1, [[0, 1], [2], [3]]),
    ((8, 4, 2, 1), 1, [[0], [1], [2, 3]]),
    ((1, 1, 2), 1, [[0, 1], [2]]),
    ((1, 2), 2, [[0], [1]]),
    ((1, 2, 4), 0, [[0, 1, 2]]),
    ((1,) * 6, 1, [[0, 1, 2], [3, 4, 5]]),
    ((1,) * 5, 0, [[0, 1, 2], [3, 4]]),
    ((), 1, []),
])
def test_k3_launch_plan(steps, radius, want):
    """Consecutive iterations fuse while their summed reach (taps, and at
    least the 3x3 variance box) fits; every iteration is in one launch."""
    groups = tstencil._plan(steps, radius)
    assert groups == want
    assert [i for g in groups for i in g] == list(range(len(steps)))
    assert all(len(g) <= 4 for g in groups)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("halo,fused", [(1, 1), (3, 2), (8, 1), (12, 2), (15, 4), (30, 2)])
def test_k3_tile_fits_shared_memory(C, halo, fused):
    tile_w, tile_h, threads = tstencil._tile_for(halo, C, fused)
    assert tile_w >= 1 and tile_h >= 1 and threads % 32 == 0 and threads <= 512
    assert tstencil._smem_bytes(tile_w, tile_h, halo, C, fused) <= tstencil.SMEM_LIMIT
    # a launch of one iteration keeps one colour + variance buffer, not two
    assert (tstencil._smem_bytes(32, 16, halo, C, 1)
            < tstencil._smem_bytes(32, 16, halo, C, 2))


@pytest.mark.parametrize("feedback_iteration,want", [
    (1, [(2, -1, True), (1, -1, False), (1, -1, False)]),   # the pair's own output
    (0, [(2, 0, False), (1, -1, False), (1, -1, False)]),   # inside the pair: a plane of its own
    (3, [(2, -1, False), (1, -1, False), (1, -1, True)]),
    (7, [(2, -1, False), (1, -1, False), (1, -1, False)]),  # past the chain: the input
])
def test_k3_launch_list_places_the_feedback_plane(feedback_iteration, want):
    launches = tstencil._launches((1, 2, 4, 8), 1, 1.0, feedback_iteration, 1)
    assert [(n, fb_at, is_fb) for n, _, _, _, _, _, fb_at, is_fb in launches] == want
    steps = [list(s) for _, s, *_ in launches]
    assert steps == [[1, 2], [4], [8]]
    phis = [float(p) for _, _, ps, *_ in launches for p in ps]
    np.testing.assert_allclose(phis, [1.0001, 2.0001, 4.0001, 8.0001], rtol=1e-6)
