"""The temporal stage of the three denoisers, in the structure of its
kernel K8 (``csrc/temporal.cu``, ``ops/temporal.py``; the kernel runs only
on the card, where ``chip_smoke.py --temporal-only`` holds it to the plain
functions bit for bit):

- ``k8_model`` computes each pass's temporal stage pixel by pixel as K8
  does: each column tap of the bilinear warp blends two rows with that
  column's own reprojected y (the separable order of ``ops/warp.py``), the
  nearest tap takes its row offset at its own column, the disocclusion
  tests, the rescue and the blends follow, and the 17x17 box sums read a
  32 x 8 tile whose 8-pixel halo is loaded at clamped image coordinates.
  It equals ``temporal_accumulation_plain`` of the shadows, the AO and the
  reflections bit for bit on G-buffers made to reach every branch (each
  disocclusion test failing alone, offsets of -7, -6, 5 and 6 on both
  axes, clamped taps at the frame's borders, neighbouring columns with
  different row offsets, rescued pixels, virtual-point and surface
  reprojection with curvature != 0, a still and a moving camera, histories
  at their caps, sky pixels);
- on CPU tensors each ``temporal_accumulation`` is the plain function:
  the kernel library is not loaded, nothing is launched and the counter
  ``temporal_px`` stays absent."""
import dataclasses

import numpy as np
import pytest
import torch

from hybrid_rendering_torch.config import AOConfig, ReflectionsConfig, ShadowsConfig
from hybrid_rendering_torch.models import ao, reflections, shadows
from hybrid_rendering_torch.ops import kernels, temporal
from hybrid_rendering_torch.ops.math3d import luminance
from hybrid_rendering_torch.ops.reprojection import _disocclusion_valid, virtual_point_coords
from hybrid_rendering_torch.ops.warp import MAX_RESIDUAL as M
from hybrid_rendering_torch.types import GBuffer
from hybrid_rendering_torch.utils import camera as camera_utils
from hybrid_rendering_torch.utils import profiler

TILE_X, TILE_Y, R = 32, 8, 8  # csrc/temporal.cu
SIZES = ((37, 70), (9, 5))  # tiles cut by the frame on both axes; a frame smaller than the halo


def _gbuffer(position, normal, mesh_id, motion, curvature):
    H, W = mesh_id.shape
    z = torch.zeros((H, W))
    return GBuffer(albedo=torch.zeros((H, W, 3)), metallic=z, normal=normal, motion=motion,
                   roughness=z, curvature=curvature, mesh_id=mesh_id, linear_z=z, depth=z,
                   position=position)


def frame_inputs(H, W, seed, camera_delta=0.3, device="cpu"):
    """A frame and its previous frame for the three temporal stages, made
    from `seed`: a camera over the plane z = 0 (every pixel sees it, so a
    virtual point lands a few pixels from its pixel) whose previous view
    moved; mesh ids in blocks with sky pixels; motion vectors of integer
    offsets in [-8, 8] (some beyond the frame) with fractions of 0, 0.25,
    0.5, 0.75 or any; the previous G-buffer the same but for single pixels
    whose mesh id, plane or normal fails its test; histories with lengths
    up to 40 and moments; reflections' ray lengths (-1 for no hit) and
    curvatures. Returns a dict of the arguments, on `device`."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g)

    eye = (0.3, 0.2, 4.0)
    cam = camera_utils.make_camera(eye, (0.0, 0.0, 0.0), width=W, height=H)
    prev = camera_utils.make_camera((0.36, 0.17, 4.05), (0.0, 0.0, 0.0), width=W, height=H)
    cam = dataclasses.replace(cam, prev_view_proj=prev.view_proj)
    o, d = camera_utils.camera_rays(cam, W, H)
    position = o + d * (-o[..., 2:3] / d[..., 2:3])
    position = position + torch.stack([torch.zeros(H, W), torch.zeros(H, W),
                                       (rand(H, W) - 0.5) * 1e-3], -1)
    normal = torch.nn.functional.normalize(
        torch.tensor([0.0, 0.0, 1.0]) + (rand(H, W, 3) - 0.5) * 0.1, dim=-1)
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    mesh_id = ((xx // 11 + yy // 7) % 3).to(torch.int32)
    sky = (rand(H, W) < 0.06) | ((xx < 4) & (yy < 3))
    mesh_id = torch.where(sky, -1, mesh_id)
    position = torch.where(sky[..., None], 0.0, position)
    normal = torch.where(sky[..., None], 0.0, normal)

    frac = torch.tensor([0.0, 0.25, 0.5, 0.75])[randint(0, 4, H, W, 2)]
    frac = torch.where(rand(H, W, 2) < 0.3, rand(H, W, 2), frac)
    offset = randint(-8, 9, H, W, 2).float()
    offset = torch.where(rand(H, W, 2) < 0.04, offset * 6.0, offset)  # beyond the window
    motion = (offset + frac) / torch.tensor([float(W), float(H)])
    curvature = torch.where(rand(H, W) < 0.3, rand(H, W), 0.0)
    gb = _gbuffer(position, normal, mesh_id, motion, curvature)

    prev_mesh = torch.where(rand(H, W) < 0.05, (mesh_id + 1) % 3, mesh_id).to(torch.int32)
    prev_position = torch.where((rand(H, W) < 0.05)[..., None], position + 8.0 * normal,
                                position)
    flip = torch.stack([normal[..., 1], -normal[..., 0], normal[..., 2] * 0.1], -1)
    prev_normal = torch.where((rand(H, W) < 0.05)[..., None], flip, normal)
    prev_gb = _gbuffer(prev_position, prev_normal, prev_mesh, motion, curvature)

    history_length = randint(0, 41, H, W).float()
    shadow_state = shadows.ShadowsState(
        history=rand(H, W), moments=rand(H, W, 2), history_length=history_length)
    ao_state = ao.AOState(history=rand(H, W), history_length=history_length)
    refl_state = reflections.ReflectionsState(
        history=rand(H, W, 3) * 2.0, moments=rand(H, W, 2), history_length=history_length)
    raw_binary = (rand(H, W) < 0.6).float()
    raw_color = rand(H, W, 3) * torch.where(rand(H, W, 1) < 0.1, 5.0, 1.0)  # some fireflies
    ray_length = torch.where(rand(H, W) < 0.6, rand(H, W) * 0.3 + 1e-3, -1.0)
    args = dict(gb=gb, prev_gb=prev_gb, camera=cam, camera_delta=torch.tensor(camera_delta),
                shadow_state=shadow_state, ao_state=ao_state, refl_state=refl_state,
                raw_binary=raw_binary, raw_ao=rand(H, W), raw_color=raw_color,
                ray_length=ray_length)

    def to(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: to(getattr(v, f.name))
                                             for f in dataclasses.fields(v) if f.init})
        return v

    return {k: to(v) for k, v in args.items()}


def site_calls(a, cfgs=None):
    """The three temporal_accumulation calls of `frame_inputs`' frame:
    {site: (args tuple)}."""
    cfgs = cfgs or {"shadows": ShadowsConfig(), "ao": AOConfig(),
                    "reflections": ReflectionsConfig()}
    return {"shadows": (a["raw_binary"], a["gb"], a["prev_gb"], a["shadow_state"],
                        cfgs["shadows"]),
            "ao": (a["raw_ao"], a["gb"], a["prev_gb"], a["ao_state"], cfgs["ao"]),
            "reflections": (a["raw_color"], a["ray_length"], a["gb"], a["prev_gb"],
                            a["camera"], a["camera_delta"], a["refl_state"],
                            cfgs["reflections"])}


# ---------------------------------------------------------------------------
# K8 pixel by pixel
# ---------------------------------------------------------------------------


def _window(k, lo, hi):
    return (k >= lo) & (k <= hi)


def coord_planes(gb, camera=None, ray_length=None):
    """(hx, hy) of each pixel: its reprojected coordinates, a function of
    the pixel alone (K8 evaluates them wherever a tap needs them)."""
    H, W = gb.depth.shape
    yy, xx = camera_utils.pixel_grid(H, W)
    hx, hy = xx + gb.motion[..., 0] * W, yy + gb.motion[..., 1] * H
    if ray_length is not None:
        vx, vy = virtual_point_coords(gb, camera, torch.clamp(ray_length, min=0.0))
        use = (ray_length > 0.0) & (gb.curvature == 0.0)
        hx, hy = torch.where(use, vx, hx), torch.where(use, vy, hy)
    return hx, hy


def reproject_px(gb, prev_gb, hist, mom, hlen, hx, hy):
    """K8's reprojection core at every pixel. Returns (history, moments,
    length, valid, stats) with `stats` the branches each pixel took."""
    H, W = hx.shape
    y = torch.arange(H)[:, None].expand(H, W)
    x = torch.arange(W)[None, :].expand(H, W)
    yf, xf = y.float(), x.float()
    cont = (hist, mom, prev_gb.normal)

    # bilinear: two column taps, each a row blend with its own (ky, fy)
    flx, fly = torch.floor(hx), torch.floor(hy)
    fx = hx - flx
    kx, ky = (flx - xf).to(torch.int64), (fly - yf).to(torch.int64)
    ok_b = (_window(kx, -M, M - 1) & _window(ky, -M, M - 1) & (hx >= 0.0) & (hx <= W - 1.0)
            & (hy >= 0.0) & (hy <= H - 1.0))
    wx0 = torch.where(_window(kx, -M, M), 1.0 - fx, 0.0)
    wx1 = torch.where(_window(kx, -M - 1, M - 1), fx, 0.0)

    def row_blend(xc):
        hyc = hy[y, xc]
        fl = torch.floor(hyc)
        f = hyc - fl
        k = (fl - yf).to(torch.int64)
        w0 = torch.where(_window(k, -M, M), 1.0 - f, 0.0)[..., None]
        w1 = torch.where(_window(k, -M - 1, M - 1), f, 0.0)[..., None]
        r0, r1 = torch.clamp(y + k, 0, H - 1), torch.clamp(y + k + 1, 0, H - 1)
        return [p[r0, xc] * w0 + p[r1, xc] * w1 for p in cont], k

    xc0, xc1 = torch.clamp(x + kx, 0, W - 1), torch.clamp(x + kx + 1, 0, W - 1)
    (v0, k0), (v1, k1) = row_blend(xc0), row_blend(xc1)
    bil = [a * wx0[..., None] + b * wx1[..., None] for a, b in zip(v0, v1)]

    # nearest: the row offset taken at the tap's own column
    rx, ry = torch.round(hx), torch.round(hy)
    nkx, nky = (rx - xf).to(torch.int64), (ry - yf).to(torch.int64)
    ok_n = (_window(nkx, -M, M) & _window(nky, -M, M) & (rx >= 0) & (rx <= W - 1)
            & (ry >= 0) & (ry <= H - 1))
    xn = torch.clamp(x + nkx, 0, W - 1)
    cky = (torch.round(hy[y, xn]) - yf).to(torch.int64)
    take = _window(nkx, -M, M) & _window(cky, -M, M)
    j = (torch.clamp(y + cky, 0, H - 1), xn)
    near = [torch.where(take[..., None], p[j], 0.0)
            for p in (hist, mom, hlen[..., None], prev_gb.normal, prev_gb.position)]
    prev_mesh = torch.where(take, prev_gb.mesh_id[j], 0)

    def valid(n, in_frame):
        return _disocclusion_valid(gb.position, gb.normal, gb.mesh_id, near[4], n, prev_mesh,
                                   in_frame)

    valid_b, valid_n = valid(bil[2], ok_b), valid(near[3], ok_n)
    use_near = ~valid_b & valid_n
    ok = valid_b | valid_n

    def pick(n, b):
        return torch.where(ok[..., None], torch.where(use_near[..., None], n, b), 0.0)

    # the four tests of the bilinear tap, for the coverage checks
    d = gb.position - near[4]
    tests = {"in_frame": ok_b, "mesh": gb.mesh_id == prev_mesh,
             "plane": torch.abs(torch.sum(d * gb.normal, -1)) <= 5.0,
             "normal": torch.abs(torch.sum(gb.normal * bil[2], -1)) ** 2 > 0.1}
    stats = dict(tests=tests, kx=kx, ky=ky, nkx=nkx, nky=nky, k0=k0, k1=k1, rescued=use_near,
                 clamped=(x + kx < 0) | (x + kx + 1 > W - 1) | (y + ky < 0) | (y + ky > H - 2))
    return (pick(near[0], bil[0]), pick(near[1], bil[1]), torch.where(ok, near[2][..., 0], 0.0),
            ok, stats)


def box_sum_tiled(img):
    """filters.box_filter_sum(img, 8) as K8 sums it: the tile's rows j
    hold image rows clamp(tile_y - R + j), its columns likewise; the row
    sums (total + up + down, o = 1..8) over the tile's rows, then the
    column sums over them."""
    H, W = img.shape[:2]
    y, x = torch.arange(H), torch.arange(W)
    ty0, tx0 = y // TILE_Y * TILE_Y, x // TILE_X * TILE_X

    def rows(j):  # tile row j of each pixel's tile -> image row
        return torch.clamp(ty0 - R + j, 0, H - 1)

    def cols(j):
        return torch.clamp(tx0 - R + j, 0, W - 1)

    ty, tx = y - ty0, x - tx0
    s = img[rows(ty + R)]
    for o in range(1, R + 1):
        s = (s + img[rows(ty + R - o)]) + img[rows(ty + R + o)]
    t = s[:, cols(tx + R)]
    for o in range(1, R + 1):
        t = (t + s[:, cols(tx + R - o)]) + s[:, cols(tx + R + o)]
    return t


def k8_model(site, args):
    """The temporal stage of `site` ("shadows", "ao", "reflections") as K8
    computes it, from the arguments of its temporal_accumulation. Returns
    (outputs, stats)."""
    if site == "reflections":
        raw, ray_length, gb, prev_gb, camera, camera_delta, state, cfg = args
        hx, hy = coord_planes(gb, camera, ray_length)
    else:
        raw, gb, prev_gb, state, cfg = args
        hx, hy = coord_planes(gb)
    H, W = hx.shape
    C = 3 if site == "reflections" else 1
    hist = state.history.reshape(H, W, C)
    mom = torch.zeros((H, W, 2)) if site == "ao" else state.moments
    rep_h, rep_m, rep_len, valid, stats = reproject_px(gb, prev_gb, hist, mom,
                                                       state.history_length, hx, hy)
    geom = gb.mesh_id >= 0
    success = valid & geom
    grown = torch.where(success, rep_len + 1.0, 1.0)
    if site == "reflections":
        cap = torch.where(camera_delta > 1e-5, cfg.accumulation_cap_moving, cfg.history_cap)
        length = torch.minimum(cap, grown)
    else:
        length = torch.clamp(grown, max=cfg.history_cap)
    inv = 1.0 / length
    alpha = torch.where(success, torch.clamp(inv, min=cfg.alpha), 1.0)
    stats["capped"] = success & (rep_len + 1.0 > length)
    raw_c = raw.reshape(H, W, C)
    if site == "ao":
        h = torch.where(success, rep_h[..., 0], 0.0)
        return (torch.where(geom, h + (raw - h) * alpha, 1.0), length), stats
    if site == "shadows":
        mean = box_sum_tiled(raw) / (17.0 * 17.0)
        sd = torch.sqrt(torch.clamp(mean - mean * mean, min=0.0))
        ks = sd * cfg.clamp_std_factor
        h = torch.where(success, torch.clamp(rep_h[..., 0], mean - ks, mean + ks), 0.0)[..., None]
        cur0, cur1 = raw, raw * raw
    else:
        m1 = box_sum_tiled(raw_c) / (17.0 * 17.0)
        m2 = box_sum_tiled(raw_c * raw_c) / (17.0 * 17.0)
        sigma = torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0))
        lo, hi = m1 - sigma, m1 + sigma
        center, extent = 0.5 * (hi + lo), 0.5 * (hi - lo) + 1e-5
        vc = rep_h - center
        ma = torch.amax(torch.abs(vc / extent), dim=-1, keepdim=True)
        h = torch.where(ma > 1.0, center + vc / torch.clamp(ma, min=1e-6), rep_h)
        h = torch.where(success[..., None], h, 0.0)
        cur0 = luminance(raw_c)
        cur1 = cur0 * cur0
    alpha_m = torch.where(success, torch.clamp(inv, min=cfg.moments_alpha), 1.0)
    p0 = torch.where(success, rep_m[..., 0], 0.0)
    p1 = torch.where(success, rep_m[..., 1], 0.0)
    m0, m1 = p0 + (cur0 - p0) * alpha_m, p1 + (cur1 - p1) * alpha_m
    variance = torch.clamp(m1 - m0 * m0, min=0.0)
    out = torch.where(geom[..., None], h + (raw_c - h) * alpha[..., None], 0.0)
    keep = torch.ones_like(geom) if site == "reflections" else geom
    outs = (out if C == 3 else out[..., 0], torch.where(keep, variance, 0.0),
            torch.where(keep[..., None], torch.stack([m0, m1], -1), 0.0),
            torch.where(geom, length, 0.0))
    return outs, stats


PLAIN = {"shadows": shadows.temporal_accumulation_plain, "ao": ao.temporal_accumulation_plain,
         "reflections": reflections.temporal_accumulation_plain}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bits_equal(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        off = _bits(g) != _bits(w)
        assert not off.any(), (f"{what}: output {i} differs at {int(off.sum())} of {g.numel()} "
                               f"values, max |d| {float((g - w).abs()[off].max())}")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("camera_delta", [0.0, 1e-5, 0.3])
@pytest.mark.parametrize("site", ["shadows", "ao", "reflections"])
def test_k8_model_equals_the_plain_stage(site, camera_delta, size):
    """Every output of each site bit for bit, on two frame sizes and with
    the camera still, at the cap's threshold and moving."""
    H, W = size
    for seed in (3, 11):
        call = site_calls(frame_inputs(H, W, seed, camera_delta))[site]
        got, _ = k8_model(site, call)
        _assert_bits_equal(got, PLAIN[site](*call), f"{site} {size} seed {seed}")


def test_the_frames_reach_every_branch():
    """The model's inputs take each branch the kernel has: each of the four
    disocclusion tests failing alone, the offsets at either end of the
    windows on both axes, clamped taps, neighbouring column taps with
    different row offsets, rescued pixels, histories at their cap, sky
    pixels; and the reflections reproject both virtual points (some valid)
    and surfaces where the ray hit a curved surface."""
    a = frame_inputs(*SIZES[0], seed=3)
    calls = site_calls(a)
    _, st = k8_model("shadows", calls["shadows"])
    t = st["tests"]
    for name in t:
        alone = t[name].logical_not()
        for other in t:
            if other != name:
                alone &= t[other]
        assert int(alone.sum()) > 0, f"no pixel fails only the {name} test"
    for k in (-7, -6, 5, 6):
        for key in ("kx", "ky", "nkx", "nky"):
            assert int((st[key] == k).sum()) > 0, (key, k)
    assert int(st["clamped"].sum()) > 0
    assert int((st["k0"] != st["k1"]).sum()) > 0, "no two column taps with different row offsets"
    assert int(st["rescued"].sum()) > 0, "no pixel rescued by the nearest tap"
    assert int(st["capped"].sum()) > 0
    assert int((a["gb"].mesh_id < 0).sum()) > 0

    _, rs = k8_model("reflections", calls["reflections"])
    gb, rl = a["gb"], a["ray_length"]
    virtual = (rl > 0.0) & (gb.curvature == 0.0)
    valid_b = rs["tests"]["in_frame"]
    assert int((virtual & valid_b).sum()) > 0, "no virtual point inside the window"
    assert int(((rl > 0.0) & (gb.curvature != 0.0)).sum()) > 0
    assert int((~virtual & valid_b).sum()) > 0


def test_the_cap_follows_the_camera():
    """The reflections' history length is capped at accumulation_cap_moving
    only while the camera moves (camera_delta > 1e-5)."""
    cfg = ReflectionsConfig()
    caps = {}
    for delta in (0.0, 0.3):
        call = site_calls(frame_inputs(*SIZES[0], seed=3, camera_delta=delta))["reflections"]
        caps[delta] = float(reflections.temporal_accumulation(*call)[3].max())
    assert caps == {0.0: cfg.history_cap, 0.3: cfg.accumulation_cap_moving}


@pytest.mark.parametrize("site", ["shadows", "ao", "reflections"])
def test_cpu_tensors_take_the_plain_stage(site, monkeypatch):
    """On CPU tensors temporal_accumulation is the plain function: the
    kernel library is never loaded, no K8 launch is counted and the
    counter temporal_px stays absent while tracing is on."""
    def no_library():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(kernels, "lib", no_library)
    mod = {"shadows": shadows, "ao": ao, "reflections": reflections}[site]
    call = site_calls(frame_inputs(*SIZES[1], seed=5))[site]
    before = getattr(temporal, site).launches
    profiler.collect()
    profiler.enable()
    try:
        got = mod.temporal_accumulation(*call)
    finally:
        profiler.disable()
    rec = profiler.collect()
    _assert_bits_equal(got, PLAIN[site](*call), site)
    assert getattr(temporal, site).launches == before
    assert "temporal_px" not in rec["counters"]


def test_a_tensor_on_another_device_is_refused():
    """Neither the kernel nor the plain stage serves a device that is not
    the CPU or a CUDA card."""
    call = site_calls(frame_inputs(*SIZES[1], seed=5))["ao"]
    with pytest.raises(ValueError):
        ao.temporal_accumulation(call[0].to("meta"), *call[1:])


def test_k8_operand_bytes():
    """The bytes K8 must move a pixel, as chip_smoke.py bounds it: the
    G-buffer planes of both frames (64), the pass's own inputs and outputs."""
    import chip_smoke

    assert [chip_smoke.k8_bytes(s, 1) for s in ("shadows", "ao", "reflections")] == [104, 84, 136]
    assert np.isclose(chip_smoke.k8_bytes("shadows", 2_073_600) / 3.35e12 * 1e3, 0.0644, atol=1e-4)
