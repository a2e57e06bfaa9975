"""What K6′'s redesign (csrc/flashtrace.cu k6p_scan) relies on, held
on the CPU in float32:

  - the pre-tests without the reciprocal, with the window fixed at each
    ray's (t_min, t_max) and modelled as the source states them, never
    reject a pair that the plain version's exact test accepts: on seeded
    random rays and triangles, and on adversarial pairs (t within a few ulp
    of t_min and of t_max, t_max = inf, |det| just above 1e-9, u or v at
    +0 or -0, u + v at 1);
  - where the proof does not reach, the bounds are set open directly and
    give the plain answer: t_min = 0, a negative t_min, t_max <= 0 with a
    negative t_min, and rays whose |d|_1 times the scene's det_bound
    exceeds 2^99;
  - each slack is needed: set to 0, the pre-tests reject accepted pairs;
  - the whole scan (compaction in any visiting order, groups of rays, the
    triangles split into parts scanned in any order, the blocked flag over
    the parts) equals the plain version bit for bit, and the grid holds
    every split the card can choose;
  - the plain version agrees with the JAX package's kernel (interpret
    mode) at t_max = inf and at a negative t_min.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hybrid_rendering_tpu.ops.pallas import flashtrace as jflash
from hybrid_rendering_torch.ops import flashtrace as tflash

f32 = np.float32
T_MIN = f32(1e-3)
SLACK_HI = f32(1.0 + 2.0 ** -20)  # csrc/flashtrace.cu K6_SLACK_HI
MARGIN = f32(2.0 ** -60)
BLOCK = 128  # csrc/flashtrace.cu K6_BLOCK
# the slacks of the pre-tests, as the source states them
SLACKS = dict(lo=f32(tflash.SLACK_LO), hi=SLACK_HI, margin=MARGIN, cap=SLACK_HI)
# each slack set to 0
NO_SLACK = dict(lo=f32(1.0), hi=f32(1.0), margin=f32(0.0), cap=f32(1.0))


def exact_accept(det, tn, un, vn, t_max, t_min=T_MIN):
    """The plain version's acceptance of pairs (ops/flashtrace.py
    pair_tests), in float32."""
    with np.errstate(all="ignore"):
        det_ok = np.abs(det) > f32(1e-9)
        inv = np.where(det_ok, f32(1.0) / det, f32(0.0)).astype(f32)
        t, u, v = tn * inv, un * inv, vn * inv
        return (det_ok & (u >= 0) & (v >= 0) & (u + v <= f32(1.0)) & (t > f32(t_min))
                & (t < t_max))


def pretest_pass(det, tn, un, vn, t_max, t_min=T_MIN, open_=None, slack=SLACKS):
    """K6′'s pre-tests in its own arithmetic. `open_`: the block's bounds
    are open (by default: t_min outside PRE_T_MIN, or |det| > 2^100, which
    a ray of a closed block cannot meet)."""
    t_min = f32(t_min)
    with np.errstate(all="ignore"):
        ad = np.abs(det)
        if open_ is None:
            open_ = ~(tflash.PRE_T_MIN[0] <= t_min <= tflash.PRE_T_MIN[1]) | (ad > f32(2.0 ** 100))
        inf = f32(np.inf)
        # set directly where open: never t_max times an infinite factor
        klo = np.where(open_, -inf, t_min * slack["lo"]).astype(f32)
        thi = np.where(open_, inf, (t_max * slack["hi"]).astype(f32)).astype(f32)
        mrg = np.where(open_, inf, slack["margin"]).astype(f32)
        cap = np.where(open_, inf, slack["cap"]).astype(f32)
        neg = det < 0
        st, su, sv = (np.where(neg, -x, x).astype(f32) for x in (tn, un, vn))
        margin = (-ad * mrg).astype(f32)
        return ((st > (klo * ad).astype(f32)) & (st < (thi * ad).astype(f32))
                & (su >= margin) & (sv >= margin)
                & ((su + sv).astype(f32) <= (ad * cap).astype(f32)))


def _missed(det, tn, un, vn, t_max, t_min=T_MIN, slack=SLACKS):
    det, tn, un, vn, t_max = (np.asarray(x, f32) for x in (det, tn, un, vn, t_max))
    acc = exact_accept(det, tn, un, vn, t_max, t_min)
    passed = pretest_pass(det, tn, un, vn, t_max, t_min, slack=slack)
    return acc, passed, acc & ~passed


def _ulps(x, k):
    """x moved by k ulps (k may be negative), elementwise, in float32."""
    x = np.asarray(x, f32).copy()
    k = np.asarray(k).copy()
    toward = np.where(k >= 0, f32(np.inf), f32(-np.inf))
    for _ in range(int(np.abs(k).max())):
        step = np.abs(k) > 0
        x = np.where(step, np.nextafter(x, toward), x).astype(f32)
        k = np.where(step, k - np.sign(k), k)
    return x


def _scene(seed, n_tris):
    rs = np.random.RandomState(seed)
    base = rs.uniform(-3, 3, size=(n_tris, 1, 3))
    tri = (base + rs.uniform(-0.4, 0.4, size=(n_tris, 3, 3))).astype(f32)
    tri[: n_tris // 10, :, 1] = tri[: n_tris // 10, :1, 1]  # flat in y: grazing rays
    return tri


def _rays(seed, tri, n):
    """Rays from a box around the scene, half aimed at centroids (some
    grazing the flat triangles); t_max mixes inf (sun shadows), short
    (AO) and masked (0) rays."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-5, 5, size=(n, 3)).astype(f32)
    d = rs.normal(size=(n, 3)).astype(f32)
    k = n // 2
    d[:k] = tri.mean(axis=1)[rs.randint(0, tri.shape[0], k)] + rs.normal(scale=0.05, size=(k, 3)) - o[:k]
    d[k: k + n // 8, 1] = rs.uniform(-1e-6, 1e-6, n // 8)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.uniform(size=n) < 0.4, np.inf, rs.uniform(0.3, 8.0, n)).astype(f32)
    t_max[rs.uniform(size=n) < 0.1] = 0.0
    return o, d.astype(f32), t_max


def _pairs(fs, o, d):
    """Every (ray, row of the padded table) pair's det, t_num, u_num, v_num
    as the plain version and the kernel form them."""
    feats = tflash.features(torch.from_numpy(o), torch.from_numpy(d), fs.center)
    coef_t = fs.coef.T.contiguous()
    return tuple(tflash._affine(feats, coef_t, q).numpy() for q in range(4))


@pytest.mark.parametrize("seed", [0, 1])
def test_pretest_never_rejects_an_accepted_pair_on_random_rays(seed):
    tri = _scene(seed, 300)
    o, d, t_max = _rays(seed + 10, tri, 256)
    fs = tflash.make_flash_scene(torch.from_numpy(tri))
    det, tn, un, vn = _pairs(fs, o, d)
    live = t_max > T_MIN
    tm = np.broadcast_to(t_max[:, None], det.shape)
    acc, passed, missed = _missed(det[live], tn[live], un[live], vn[live], tm[live])
    assert not missed.any()
    assert acc.sum() > 50
    # and it is worth having: most pairs stop before the reciprocal, fewer
    # for the rays of unbounded t (every plane in front of them passes t)
    assert passed.mean() < 0.1
    short = np.isfinite(t_max[live])
    assert passed[short].mean() < passed[~short].mean()


def _adversarial(seed, n=40_000):
    """Pairs built around the pre-tests' edges: t within a few ulp of t_min
    and of t_max (t_max = inf too), |det| just above 1e-9 and across
    magnitudes, u or v at +0, -0 and a few ulp around, u + v at 1, and
    u_num products that underflow to -0 under a large det."""
    rs = np.random.RandomState(seed)
    sign = np.where(rs.uniform(size=n) < 0.5, f32(-1), f32(1))
    mag = (10.0 ** rs.uniform(-9, 4, n)).astype(f32)
    mag[: n // 8] = _ulps(np.full(n // 8, f32(1e-9)), rs.randint(1, 6, n // 8))
    mag[n // 8: n // 4] = (10.0 ** rs.uniform(25, 37, n // 8)).astype(f32)  # around 2^100
    det = (sign * mag).astype(f32)
    t_max = np.where(rs.uniform(size=n) < 0.3, f32(np.inf),
                     (10.0 ** rs.uniform(-2.9, 5, n)).astype(f32)).astype(f32)
    kind = rs.randint(0, 5, n)
    t_target = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [np.full(n, T_MIN), np.where(np.isinf(t_max), f32(1e3), t_max),
         (10.0 ** rs.uniform(20, 37, n)).astype(f32), (10.0 ** rs.uniform(-30, -3, n)).astype(f32)],
        default=-(10.0 ** rs.uniform(-3, 3, n))).astype(f32)
    with np.errstate(all="ignore"):
        tn = _ulps((t_target * det).astype(f32), rs.randint(-6, 7, n))
        u_target = np.select([rs.uniform(size=n) < 0.3, rs.uniform(size=n) < 0.5],
                             [np.zeros(n, f32), rs.uniform(0, 1, n).astype(f32)],
                             default=rs.uniform(-1, 2, n)).astype(f32)
        v_target = np.where(rs.uniform(size=n) < 0.4, (f32(1) - u_target).astype(f32),
                            rs.uniform(-0.1, 1.0, n).astype(f32)).astype(f32)
        un = _ulps((u_target * det).astype(f32), rs.randint(-4, 5, n))
        vn = _ulps((v_target * det).astype(f32), rs.randint(-4, 5, n))
        un[rs.uniform(size=n) < 0.05] = -f32(0.0)
        vn[rs.uniform(size=n) < 0.05] = -f32(0.0)
        tiny = rs.uniform(size=n) < 0.05
        un[tiny] = -(10.0 ** rs.uniform(-45, -38, tiny.sum())).astype(f32)
    return det, tn, un, vn, t_max


@pytest.mark.parametrize("seed", [7, 8])
def test_pretest_never_rejects_adversarial_pairs(seed):
    det, tn, un, vn, t_max = _adversarial(seed)
    acc, passed, missed = _missed(det, tn, un, vn, t_max)
    assert not missed.any(), (det[missed][:5], tn[missed][:5], t_max[missed][:5])
    assert acc.sum() > 1000 and (~passed).sum() > 1000
    # the edges are reached: accepted pairs with t one ulp inside t_min and
    # inside a finite t_max
    with np.errstate(all="ignore"):
        t = (tn * (f32(1.0) / det)).astype(f32)
    assert (acc & (t == np.nextafter(T_MIN, f32(1)))).any()
    assert (acc & np.isfinite(t_max) & (t == np.nextafter(t_max, f32(0)))).any()


@pytest.mark.parametrize("slack", sorted(SLACKS))
def test_a_slack_set_to_zero_breaks_the_pretest(slack):
    """Each slack of the source is needed: without it the pre-tests reject
    pairs that the exact test accepts."""
    zeroed = dict(SLACKS, **{slack: NO_SLACK[slack]})
    missed = 0
    for seed in (7, 8):
        missed += int(_missed(*_adversarial(seed), slack=zeroed)[2].sum())
    assert missed > 0


def _model_pairs_blocked(fs, o, d, t_max, t_min, open_, rows):
    """The kernel's verdict on each ray against `rows` of the padded table:
    a pair passes the pre-tests and then the exact test."""
    det, tn, un, vn = (x[:, rows] for x in _pairs(fs, o, d))
    tm = np.broadcast_to(t_max[:, None], det.shape)
    op = np.broadcast_to(open_[:, None], det.shape)
    acc = exact_accept(det, tn, un, vn, tm, t_min)
    return (pretest_pass(det, tn, un, vn, tm, t_min, op) & acc).any(axis=1)


def kernel_model(fs, o, d, t_max, t_min, rays_per_thread, parts, rng, order=None):
    """K6′ on the CPU: the compaction (live rays listed in the visiting
    `order`, by default the rays' own, 1.0 for them and 0.0 for the dead),
    groups of BLOCK * rays_per_thread listed
    rays, each group's bounds closed only if the proof holds for all its
    rays, the triangles split into `parts` parts of whole tiles; the
    (group, part) blocks run in a shuffled order, each part's tiles in a
    shuffled order, and a ray stops when its flag reads 0."""
    n_tiles = fs.coef.shape[0] // tflash.TILE
    parts = min(parts, n_tiles)
    live = t_max > f32(t_min)
    vis = np.where(live, f32(1.0), f32(0.0))
    order = np.arange(len(t_max)) if order is None else order
    listed = order[live[order]]
    _, pre = tflash._pre_bounds(t_min)
    l1 = (np.abs(d[:, 0]) + np.abs(d[:, 1])).astype(f32) + np.abs(d[:, 2])
    bounded = (l1.astype(f32) * f32(fs.det_bound)).astype(f32) <= f32(2.0 ** 99)
    size = BLOCK * rays_per_thread
    groups = [listed[s:s + size] for s in range(0, len(listed), size)]
    work = [(g, p) for g in range(len(groups)) for p in range(parts)]
    for w in rng.permutation(len(work)):
        g, p = work[w]
        rays = groups[g]
        open_ = np.full(len(rays), not (pre and bounded[rays].all()))
        tiles = np.arange(p * n_tiles // parts, (p + 1) * n_tiles // parts)
        for tile in rng.permutation(tiles):
            searching = vis[rays] != 0
            if not searching.any():
                break
            r = rays[searching]
            rows = np.arange(tile * tflash.TILE, (tile + 1) * tflash.TILE)
            blocked = _model_pairs_blocked(fs, o[r], d[r], t_max[r], t_min, open_[searching],
                                           rows)
            vis[r[blocked]] = 0.0
    return vis


@pytest.mark.parametrize("ntri", [1, 127, 128, 129, 300])
def test_split_scan_with_the_flag_matches_the_plain_version(ntri):
    rng = np.random.default_rng(ntri)
    tri = _scene(ntri, ntri)
    o, d, t_max = _rays(ntri + 1, tri, 300)
    fs = tflash.make_flash_scene(torch.from_numpy(tri))
    assert (fs.coef[ntri:] == 0).all()  # the padding rows
    want = tflash.flash_visibility_plain(fs, *(torch.from_numpy(x) for x in (o, d, t_max)))
    want = want.numpy()
    assert (want == 0).any()
    if ntri > 1:
        assert (want[t_max > T_MIN] == 1).any() and (want[t_max > T_MIN] == 0).any()
    # the rays listed in their own order and in others: which rays share a
    # group changes no result
    for rpt, parts, order in ((1, 1, None), (1, 3, rng.permutation(300)), (2, 2, None),
                              (1, 8, rng.permutation(300))):
        got = kernel_model(fs, o, d, t_max, T_MIN, rpt, parts, rng, order)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=f"{rpt} ray(s) a thread, {parts} part(s)")


@pytest.mark.parametrize("case", ["t_min = 0", "t_min < 0", "t_max <= 0 < -t_min",
                                  "beyond 2^99", "t_min > 2^20"])
def test_open_bounds_give_the_plain_answer(case):
    """Where the pre-tests' proof does not reach, the bounds are set open
    directly (-inf, +inf), and the scan gives the plain version's answer,
    for t_max <= 0 too (t_max times an infinite factor would be NaN or
    -inf there)."""
    rng = np.random.default_rng(3)
    tri = _scene(5, 200)
    o, d, t_max = _rays(6, tri, 256)
    t_min = {"t_min = 0": 0.0, "t_min < 0": -1.0, "t_max <= 0 < -t_min": -2.0,
             "beyond 2^99": 1e-3, "t_min > 2^20": 2.0 ** 21}[case]
    if case == "t_max <= 0 < -t_min":
        t_max = np.where(np.arange(256) % 2 == 0, -rng.uniform(0.0, 1.9, 256),
                         t_max).astype(f32)
    if case == "beyond 2^99":
        d[::3] *= f32(2.0 ** 95)  # |d|_1 det_bound > 2^99: the ray's group is open
    if case == "t_min > 2^20":
        o = (o - 3e6 * d).astype(f32)  # the scene lies ~3e6 along the rays
        t_max = np.where(t_max > 0, np.inf, 0.0).astype(f32)
    fs = tflash.make_flash_scene(torch.from_numpy(tri))
    want = tflash.flash_visibility_plain(fs, *(torch.from_numpy(x) for x in (o, d, t_max)),
                                         t_min).numpy()
    live = t_max > f32(t_min)
    assert live.sum() > 100 and (want[live] == 0).sum() > 5
    assert not tflash._pre_bounds(t_min)[1] or case == "beyond 2^99"
    for rpt, parts in ((1, 1), (2, 3)):
        got = kernel_model(fs, o, d, t_max, t_min, rpt, parts, rng)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if case == "t_max <= 0 < -t_min":
        # what setting the bounds directly guards against: t_max * inf
        with np.errstate(all="ignore"):
            assert np.isnan(f32(0.0) * f32(np.inf)) and f32(-0.5) * f32(np.inf) == -np.inf


def test_grid_holds_every_split():
    """launch_k6p's block count (csrc/flashtrace.cu) covers groups x parts
    for every live count the card may find, with the parts of
    split_parts's rule, and the forced plans."""
    for R in (1, 127, 129, 5_000, 66_383, 147_968, 518_400, 2_592_000):
        for rpt in (1, 2):
            size = BLOCK * rpt
            g_max = -(-R // size)
            for max_parts, resident in ((8, 1_584), (8, 2_112), (8, 264), (1, 1 << 30),
                                        (8, 1 << 30), (3, 1 << 30)):
                blocks = max(g_max, min(g_max * max_parts, resident + g_max))
                for n in {0, 1, size - 1, size, size + 1, R // 7, R // 2, R - 1, R}:
                    if not 0 <= n <= R:
                        continue
                    groups = -(-n // size)
                    parts = tflash.split_parts(n, rpt, 20, resident, max_parts) if n else 0
                    assert groups * parts <= blocks, (R, rpt, max_parts, resident, n)
                    if resident == 1 << 30:
                        assert parts in (0, min(max_parts, 20))


@pytest.mark.parametrize("case", ["t_max = inf", "t_min < 0"])
def test_plain_version_matches_jax(case):
    """The plain version against the JAX package's K6′ (interpret mode) on
    a small seeded scene. Tolerance: equal on >= 99.9% of live rays (XLA's
    dot order against the port's left-to-right sums can flip a pair at a
    shared edge; measured: every ray equal), and every masked ray blocked
    on both sides."""
    tri = _scene(11, 150)
    o, d, t_max = _rays(12, tri, 384)
    t_min = 1e-3
    if case == "t_max = inf":
        t_max = np.where(t_max > 0, np.inf, 0.0).astype(f32)
    else:
        t_min = -0.5
    jfs = jflash.make_flash_scene(jnp.asarray(tri))
    ref = np.asarray(jflash.flash_visibility(jfs, jnp.asarray(o), jnp.asarray(d),
                                             jnp.asarray(t_max), t_min=t_min, interpret=True))
    fs = tflash.make_flash_scene(torch.from_numpy(tri))
    vis = tflash.flash_visibility(fs, *(torch.from_numpy(x) for x in (o, d, t_max)),
                                  t_min).numpy()
    live = t_max > f32(t_min)
    assert (vis[live] == ref[live]).mean() >= 0.999
    assert 0.1 < vis[live].mean() < 0.95
    assert (vis[~live] == 0).all() and (ref[~live] == 0).all()
