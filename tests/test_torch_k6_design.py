"""What K6's redesign (csrc/flashtrace.cu k6_closest_kernel) relies on, held
on the CPU in float32:

  - the pre-tests without the reciprocal, modelled as the source states
    them, never reject a pair that the plain version's exact test accepts:
    on seeded random rays and triangles, and on adversarial pairs (t within
    a few ulp of t_min and of the running best, |det| just above 1e-9,
    huge and tiny t, grazing rays, u or v at 0 or -0, u + v at 1);
  - the 64-bit merge key of a split scan orders hits as the plain version
    does (t first, the lower triangle index on a tie), with t_max = inf and
    the miss sentinel;
  - the zero rows that pad the table to whole tiles, and the split of the
    triangles into parts merged by that key, leave every result as the
    plain version's.
"""
import numpy as np
import pytest
import torch

from hybrid_rendering_torch.ops import flashtrace as tflash

f32 = np.float32
T_MIN = f32(1e-3)
SLACK_HI = f32(1.0 + 2.0 ** -20)  # csrc/flashtrace.cu K6_SLACK_HI
MARGIN = f32(2.0 ** -60)
BIG = f32(2.0 ** 100)


def exact_accept(det, tn, un, vn, best, t_min=T_MIN):
    """The plain version's acceptance of pairs (ops/flashtrace.py
    pair_tests), in float32: |det| > 1e-9, inv = 1/det, t, u, v = num *
    inv, and the tests against t_min and the running best."""
    with np.errstate(all="ignore"):
        det_ok = np.abs(det) > f32(1e-9)
        inv = np.where(det_ok, f32(1.0) / det, f32(0.0)).astype(f32)
        t, u, v = tn * inv, un * inv, vn * inv
        return (det_ok & (u >= 0) & (v >= 0) & (u + v <= f32(1.0)) & (t > t_min)
                & (t < best))


def pretest_pass(det, tn, un, vn, best, t_min=T_MIN):
    """The kernel's pre-tests in its own arithmetic: a pair goes on to the
    exact test only where these hold."""
    with np.errstate(all="ignore"):
        ad = np.abs(det)
        # the block's factors are infinite (its bounds open) where the
        # proof does not reach: t_min outside PRE_T_MIN, or |det| > 2^100
        open_ = ~(tflash.PRE_T_MIN[0] <= t_min <= tflash.PRE_T_MIN[1]) | (ad > BIG)
        inf = f32(np.inf)
        klo = np.where(open_, -inf, f32(t_min * f32(tflash.SLACK_LO))).astype(f32)
        mrg = np.where(open_, inf, MARGIN).astype(f32)
        cap = np.where(open_, inf, SLACK_HI).astype(f32)
        bhi = (best * cap).astype(f32)
        neg = det < 0
        st, su, sv = (np.where(neg, -x, x).astype(f32) for x in (tn, un, vn))
        margin = (-ad * mrg).astype(f32)
        # |det| > 1e-9 is the exact test's: the pre-tests leave it out
        return ((st > (klo * ad).astype(f32)) & (st < (bhi * ad).astype(f32))
                & (su >= margin) & (sv >= margin)
                & ((su + sv).astype(f32) <= (ad * cap).astype(f32)))


def _check_never_rejects(det, tn, un, vn, best, t_min=T_MIN):
    det, tn, un, vn, best = (np.asarray(x, f32) for x in (det, tn, un, vn, best))
    acc = exact_accept(det, tn, un, vn, best, t_min)
    passed = pretest_pass(det, tn, un, vn, best, t_min)
    missed = acc & ~passed
    assert not missed.any(), (det[missed][:5], tn[missed][:5], un[missed][:5],
                              vn[missed][:5], best[missed][:5])
    return acc, passed


def _ulps(x, k):
    """x moved by k ulps (k may be negative), elementwise, in float32."""
    x = np.asarray(x, f32).copy()
    toward = np.where(np.asarray(k) >= 0, f32(np.inf), f32(-np.inf))
    for _ in range(int(np.abs(k).max())):
        step = np.abs(k) > 0
        x = np.where(step, np.nextafter(x, toward), x).astype(f32)
        k = np.where(step, k - np.sign(k), k)
    return x


def _random_scene_pairs(seed, n_rays=256, n_tris=300):
    """Every (ray, triangle) pair's det, t_num, u_num, v_num as the plain
    version forms them, on random triangles and rays half aimed at
    centroids (some grazing), with the t_max of each ray."""
    rs = np.random.RandomState(seed)
    base = rs.uniform(-3, 3, size=(n_tris, 1, 3))
    tri = (base + rs.uniform(-0.4, 0.4, size=(n_tris, 3, 3))).astype(f32)
    tri[: n_tris // 10, :, 1] = tri[: n_tris // 10, :1, 1]  # flat in y: grazing rays
    o = rs.uniform(-5, 5, size=(n_rays, 3)).astype(f32)
    d = rs.normal(size=(n_rays, 3)).astype(f32)
    k = n_rays // 2
    cent = tri.mean(axis=1)
    d[:k] = cent[rs.randint(0, n_tris, k)] + rs.normal(scale=0.05, size=(k, 3)) - o[:k]
    d[k: k + n_rays // 8, 1] = rs.uniform(-1e-6, 1e-6, n_rays // 8)  # grazing the flat ones
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.uniform(size=n_rays) < 0.5, np.inf, rs.uniform(0.5, 8.0, n_rays))
    fs = tflash.make_flash_scene(torch.from_numpy(tri))
    feats = tflash.features(torch.from_numpy(o), torch.from_numpy(d.astype(f32)), fs.center)
    coef_t = fs.coef[:fs.num_tris].T.contiguous()
    det, tn, un, vn = (tflash._affine(feats, coef_t, q).numpy() for q in range(4))
    return det, tn, un, vn, np.broadcast_to(t_max.astype(f32)[:, None], det.shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_pretest_never_rejects_an_accepted_pair_on_random_rays(seed):
    det, tn, un, vn, t_max = _random_scene_pairs(seed)
    acc, passed = _check_never_rejects(det, tn, un, vn, t_max)
    assert acc.sum() > 50
    # and it is worth having: most pairs stop before the reciprocal
    assert passed.mean() < 0.05
    # with the running best of the closest hit (each ray's nearest hit so
    # far in index order), the pre-test still lets every winner through
    with np.errstate(all="ignore"):
        t = np.where(acc, tn * (f32(1.0) / det), np.inf).astype(f32)
    run = np.minimum.accumulate(t, axis=1)
    best = np.minimum(np.concatenate([t_max[:, :1], run[:, :-1]], axis=1), t_max)
    _check_never_rejects(det, tn, un, vn, best.astype(f32))


def test_pretest_never_rejects_adversarial_pairs():
    rs = np.random.RandomState(7)
    n = 40_000
    sign = np.where(rs.uniform(size=n) < 0.5, f32(-1), f32(1))
    mag = (10.0 ** rs.uniform(-9, 4, n)).astype(f32)
    mag[: n // 8] = _ulps(np.full(n // 8, f32(1e-9)), rs.randint(1, 6, n // 8))
    mag[n // 8: n // 4] = (10.0 ** rs.uniform(25, 37, n // 8)).astype(f32)  # around 2^100
    det = (sign * mag).astype(f32)
    # t: near t_min, near the best, huge, tiny, negative
    best = np.where(rs.uniform(size=n) < 0.3, f32(np.inf),
                    (10.0 ** rs.uniform(-2.9, 5, n)).astype(f32)).astype(f32)
    kind = rs.randint(0, 5, n)
    t_target = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [np.full(n, T_MIN), np.where(np.isinf(best), f32(1e3), best),
         (10.0 ** rs.uniform(20, 37, n)).astype(f32), (10.0 ** rs.uniform(-30, -3, n)).astype(f32)],
        default=-(10.0 ** rs.uniform(-3, 3, n))).astype(f32)
    with np.errstate(all="ignore"):
        tn = _ulps((t_target * det).astype(f32), rs.randint(-6, 7, n))
        # u, v: at 0 (both signs of zero and a few ulp of it), inside, and
        # with u + v at 1
        u_target = np.select([rs.uniform(size=n) < 0.3, rs.uniform(size=n) < 0.5],
                             [np.zeros(n, f32), rs.uniform(0, 1, n).astype(f32)],
                             default=rs.uniform(-1, 2, n)).astype(f32)
        v_target = np.where(rs.uniform(size=n) < 0.4, (f32(1) - u_target).astype(f32),
                            rs.uniform(-0.1, 1.0, n).astype(f32)).astype(f32)
        un = _ulps((u_target * det).astype(f32), rs.randint(-4, 5, n))
        vn = _ulps((v_target * det).astype(f32), rs.randint(-4, 5, n))
        un[rs.uniform(size=n) < 0.05] = -f32(0.0)
        # products that underflow to -0 under the reciprocal of a large det
        tiny = rs.uniform(size=n) < 0.05
        un[tiny] = -(10.0 ** rs.uniform(-45, -38, tiny.sum())).astype(f32)
    acc, passed = _check_never_rejects(det, tn, un, vn, best)
    assert acc.sum() > 1000 and (~passed).sum() > 1000


@pytest.mark.parametrize("t_min", [0.0, 1e-30, 2.0 ** -90, 1e-3, 1.0, 2.0 ** 20, 2.0 ** 21])
def test_pretest_holds_for_any_t_min(t_min):
    """For every t_min the launch takes (t_min >= 0): outside the range of
    the proof the bounds are open, and in it they hold at its ends. Only
    live rays (t_max > t_min) are scanned."""
    det, tn, un, vn, t_max = _random_scene_pairs(3, n_rays=64, n_tris=200)
    t_min = f32(t_min)
    with np.errstate(all="ignore"):
        near = (t_min * det * f32(1.0000002)).astype(f32)
    tn = np.where(np.random.RandomState(0).uniform(size=tn.shape) < 0.3, near, tn).astype(f32)
    live = t_max[:, 0] > t_min
    assert live.sum() > 10
    _check_never_rejects(det[live], tn[live], un[live], vn[live], t_max[live], t_min)


@pytest.mark.parametrize("t_min", [-1e-3, -1.0, float("nan")])
def test_closest_launch_refuses_a_negative_t_min(t_min):
    """With t_min < 0 a live ray's best, or an accepted t, may be <= 0:
    best * inf is then NaN or -inf and the open bounds reject pairs the
    exact test accepts, and the merge key misorders negative t. So the
    kernel's launch refuses such a t_min (before it touches the card)."""
    fs = tflash.make_flash_scene(torch.ones((1, 3, 3)))
    rays = torch.zeros((4, 3)), torch.ones((4, 3)), torch.full((4,), 2.0)
    with pytest.raises(ValueError, match="t_min"):
        tflash._launch_closest(fs, *rays, t_min, with_attrs=False)
    # what the refusal guards against: a ray whose only hits lie behind it
    det = np.full(4, f32(-2.0))
    tn = np.array([1.0, 0.5, 1.0, 1.0], f32)  # t = -0.5, -0.25, ...
    un = vn = np.full(4, f32(-0.5))
    best = np.full(4, f32(-0.1))  # t_max in (t_min, 0]
    if t_min < -0.3:
        assert exact_accept(det, tn, un, vn, best, f32(t_min)).any()
        assert not pretest_pass(det, tn, un, vn, best, f32(t_min)).any()


def merge_key(t, tri_id):
    """The split scan's 64-bit key: the float bits of t (t > 0) above the
    triangle index."""
    return (np.asarray(t, f32).view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(tri_id, np.int32).view(np.uint32).astype(np.uint64)


MISS = np.uint64(0xFFFFFFFFFFFFFFFF)  # a key left at all ones: no part hit


def test_merge_key_orders_as_the_plain_version():
    rs = np.random.RandomState(1)
    n = 20_000
    t = (10.0 ** rs.uniform(-3, 38, n)).astype(f32)
    t[rs.uniform(size=n) < 0.2] = f32(np.inf)  # t_max = inf
    t[: n // 4] = rs.choice(t[n // 4: n // 4 + 50], n // 4)  # many ties
    ids = rs.randint(0, 2**31 - 1, n).astype(np.int32)
    ids[:10] = 2**31 - 1
    keys = merge_key(t, ids)
    by_key = np.argsort(keys, kind="stable")
    by_plain = np.lexsort((ids, t))  # t first, then the lower index
    np.testing.assert_array_equal(keys[by_key], keys[by_plain])
    # a miss: larger than every hit, t_max = inf and the largest index included
    assert (keys < MISS).all() and merge_key(np.inf, 2**31 - 1) < MISS


def _closest_by_parts(fs, o, d, t_max, parts):
    """K6's split scan on the CPU: each part of the triangles (whole tiles of
    the padded table) scanned alone by the plain version, the parts merged
    by the minimum key, a miss where no part hit."""
    coef = fs.coef
    n_tiles = coef.shape[0] // tflash.TILE
    R = o.shape[0]
    keys = np.full(R, MISS, np.uint64)
    for p in range(parts):
        t0, t1 = p * n_tiles // parts * tflash.TILE, (p + 1) * n_tiles // parts * tflash.TILE
        sub = tflash.FlashScene(coef=coef[t0:t1], center=fs.center, attrs=None,
                                num_tris=t1 - t0, det_bound=tflash.det_bound(coef[t0:t1]))
        hit = tflash.flash_closest_hit_plain(sub, o, d, t_max)
        got = hit.tri_id.numpy() >= 0
        k = merge_key(hit.t.numpy(), hit.tri_id.numpy() + t0)
        keys = np.where(got, np.minimum(keys, k), keys)
    return keys


@pytest.mark.parametrize("ntri,parts", [(1, 1), (127, 1), (300, 3), (600, 5)])
def test_padding_and_split_scan_match_the_plain_version(ntri, parts):
    rs = np.random.RandomState(ntri)
    base = rs.uniform(-3, 3, size=(ntri, 1, 3))
    tri = torch.from_numpy((base + rs.uniform(-0.4, 0.4, size=(ntri, 3, 3))).astype(f32))
    fs = tflash.make_flash_scene(tri)
    assert fs.coef.shape[0] % tflash.TILE == 0 and fs.coef.shape[0] >= ntri
    assert (fs.coef[ntri:] == 0).all()
    n = 512
    o = torch.from_numpy(rs.uniform(-5, 5, size=(n, 3)).astype(f32))
    cent = tri.mean(dim=1)[torch.from_numpy(rs.randint(0, ntri, n))]
    d = cent - o
    d[::3] = torch.from_numpy(rs.normal(size=(d[::3].shape[0], 3)).astype(f32))
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    t_max = torch.from_numpy(np.where(rs.uniform(size=n) < 0.5, np.inf,
                                      rs.uniform(0.5, 8, n)).astype(f32))
    ref = tflash.flash_closest_hit_plain(fs, o, d, t_max)
    assert (ref.tri_id >= 0).sum() > 20
    keys = _closest_by_parts(fs, o, d, t_max, parts)
    hit = keys != MISS
    np.testing.assert_array_equal(hit, ref.tri_id.numpy() >= 0)
    ids = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(ids[hit], ref.tri_id.numpy()[hit])
    t = (keys >> np.uint64(32)).astype(np.uint32).view(f32)
    np.testing.assert_array_equal(t[hit].view(np.uint32), ref.t.numpy()[hit].view(np.uint32))
