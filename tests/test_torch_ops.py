"""PyTorch port vs JAX package, module by module, on identical inputs:
camera, blue noise, sky + SH fallbacks, lighting, BRDF, filters, warp,
reprojection, G-buffer helpers, shadows (K3's caller), AO (K4's caller),
deferred shading, TAA and tone map. Inputs come from numpy with fixed seeds
or from a JAX G-buffer of shadows_test at 64x48 carried across as numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rendering_tpu import config as jcfg
from hybrid_rendering_tpu import types as jtypes
from hybrid_rendering_tpu.models import ao as jao
from hybrid_rendering_tpu.models import deferred as jdeferred
from hybrid_rendering_tpu.models import gbuffer as jgbuffer
from hybrid_rendering_tpu.models import shadows as jshadows
from hybrid_rendering_tpu.models import taa as jtaa
from hybrid_rendering_tpu.models import tonemap as jtonemap
from hybrid_rendering_tpu.ops import bluenoise as jbluenoise
from hybrid_rendering_tpu.ops import brdf as jbrdf
from hybrid_rendering_tpu.ops import bvh as jbvh
from hybrid_rendering_tpu.ops import filters as jfilters
from hybrid_rendering_tpu.ops import lighting as jlighting
from hybrid_rendering_tpu.ops import reprojection as jreprojection
from hybrid_rendering_tpu.ops import sh as jsh
from hybrid_rendering_tpu.ops import sky as jsky
from hybrid_rendering_tpu.ops import warp as jwarp
from hybrid_rendering_tpu.scene import scenes as jscenes
from hybrid_rendering_tpu.utils import camera as jcamera
from hybrid_rendering_torch import bridge
from hybrid_rendering_torch import config as tcfg
from hybrid_rendering_torch import types as ttypes
from hybrid_rendering_torch.models import ao as tao
from hybrid_rendering_torch.models import deferred as tdeferred
from hybrid_rendering_torch.models import gbuffer as tgbuffer
from hybrid_rendering_torch.models import shadows as tshadows
from hybrid_rendering_torch.models import taa as ttaa
from hybrid_rendering_torch.models import tonemap as ttonemap
from hybrid_rendering_torch.ops import bluenoise as tbluenoise
from hybrid_rendering_torch.ops import brdf as tbrdf
from hybrid_rendering_torch.ops import filters as tfilters
from hybrid_rendering_torch.ops import lighting as tlighting
from hybrid_rendering_torch.ops import reprojection as treprojection
from hybrid_rendering_torch.ops import sh as tsh
from hybrid_rendering_torch.ops import sky as tsky
from hybrid_rendering_torch.ops import warp as twarp
from hybrid_rendering_torch.utils import camera as tcamera

W, H = 64, 48
# float32 elementwise chains evaluated by XLA (with its own fusion and
# transcendental approximations) vs PyTorch's CPU kernels: a few ulp
RTOL = ATOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _port_gb(jgb) -> ttypes.GBuffer:
    return ttypes.GBuffer(**{f.name: _t(getattr(jgb, f.name))
                             for f in dataclasses.fields(ttypes.GBuffer)})


def _unit_rows(rs, n):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def frames():
    """Two JAX G-buffers of shadows_test (the eye moves 0.2 units) and the
    cameras they were rendered with, in both packages' types."""
    scene, light, camkw = jscenes.load_scene("shadows_test")
    surf = jbvh.make_surface_tracer(scene)
    cams, gbs = [], []
    prev = None
    for f in range(2):
        eye = tuple(np.asarray(camkw["eye"]) + [0.2 * f, 0.0, 0.0])
        cam = jcamera.make_camera(eye=eye, target=camkw["target"], width=W, height=H,
                                  prev_view_proj=prev)
        prev = np.asarray(cam.view_proj)
        cams.append(cam)
        gbs.append(jgbuffer.render_gbuffer(scene, surf, cam, W, H))
    return dict(jgb=gbs, tgb=[_port_gb(g) for g in gbs], jcam=cams,
                tcam=[bridge.camera_from_jax(c) for c in cams], jlight=light,
                tlight=bridge.light_from_jax(light))


def test_camera_matrices_and_rays():
    kw = dict(eye=(14.0, 6.0, 16.0), target=(0.0, 2.0, 0.0), width=W, height=H,
              jitter=jtaa.halton_jitter(3, W, H), prev_view_proj=np.eye(4, dtype=np.float32))
    jc = jcamera.make_camera(**kw)
    tc = tcamera.make_camera(**kw)
    assert ttaa.halton_jitter(3, W, H) == jtaa.halton_jitter(3, W, H)
    for f in ("view", "proj", "view_inverse", "proj_inverse", "view_proj",
              "view_proj_inverse", "prev_view_proj", "position"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), f)
    assert (tc.near, tc.far) == (1.0, 1000.0)
    jo, jd = jcamera.camera_rays(jc, W, H)
    to, td = tcamera.camera_rays(tc, W, H)
    _close(to, jo)
    _close(td, jd)


@pytest.mark.parametrize("frame,dim", [(0, 0), (5, 1), (37, 0)])
def test_bluenoise_bn_r2(frame, dim):
    ju, jv = jbluenoise.sample2d_grid(H, 150, frame, dim)
    tu, tv = tbluenoise.sample2d_grid(H, 150, frame, dim)
    _close(tu, ju, rtol=0, atol=1e-6)
    _close(tv, jv, rtol=0, atol=1e-6)


def test_sky_and_env_fallbacks():
    sun = (0.35, 0.9, 0.25)
    js, ts = jsky.ProceduralSky.create(sun_direction=sun), tsky.ProceduralSky.create(sun)
    rs = np.random.RandomState(0)
    d = _unit_rows(rs, 2048)
    d[0] = np.asarray(sun) / np.linalg.norm(sun)  # the sun disc
    _close(ts.radiance(_t(d)), js.radiance(jnp.asarray(d)))
    jirr, jpref = jsh.make_env_fallbacks(js.radiance, num_samples=1024)
    tirr, tpref = tsh.make_env_fallbacks(ts.radiance, num_samples=1024)
    rough = rs.uniform(0, 1, 2048).astype(np.float32)
    # SH-9 projection: a 1024-sample Monte-Carlo sum reordered
    _close(tirr(_t(d)), jax.jit(jirr)(jnp.asarray(d)), rtol=1e-4, atol=1e-5)
    _close(tpref(_t(d), _t(rough)), jax.jit(jpref)(jnp.asarray(d), jnp.asarray(rough)),
           rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["directional", "point", "spot"])
def test_light_properties(kind):
    make = {"directional": lambda m: m.Light.directional((0.35, 0.9, 0.25), radius=0.05),
            "point": lambda m: m.Light.point((1.0, 6.0, -2.0), intensity=40.0, radius=0.3),
            "spot": lambda m: m.Light.spot((0.0, 9.0, 0.0), (0.0, -1.0, 0.1), intensity=250.0,
                                           radius=0.3, inner_angle_deg=35.0,
                                           outer_angle_deg=55.0)}[kind]
    jl, tl = make(jtypes), make(ttypes)
    bl = bridge.light_from_jax(jl)
    for f in ("intensity", "radius", "type", "cos_theta_outer", "cos_theta_inner"):
        assert getattr(tl, f) == getattr(bl, f), f
    rs = np.random.RandomState(1)
    p = rs.uniform(-5, 5, (512, 3)).astype(np.float32)
    n = _unit_rows(rs, 512)
    r2 = rs.uniform(0, 1, (512, 2)).astype(np.float32)
    for soft in (False, True):
        ref = jlighting.fetch_light_properties(jl, jnp.asarray(p), jnp.asarray(n),
                                               rng2=jnp.asarray(r2), soft_shadows=soft)
        got = tlighting.fetch_light_properties(tl, _t(p), _t(n), rng2=_t(r2), soft_shadows=soft)
        for name, g, r in zip(("li", "wi", "t_max", "att"), got, ref):
            _close(g, np.broadcast_to(np.asarray(r), g.shape), msg=f"{name} soft={soft}")


def test_brdf_pieces():
    rs = np.random.RandomState(2)
    n, wo, wi = (_unit_rows(rs, 1024) for _ in range(3))
    wh = (wo + wi) / np.linalg.norm(wo + wi, axis=-1, keepdims=True)
    rough = rs.uniform(0.05, 1, 1024).astype(np.float32)
    metal = rs.uniform(0, 1, 1024).astype(np.float32)
    albedo = rs.uniform(0, 1, (1024, 3)).astype(np.float32)
    r2 = rs.uniform(0, 1, (1024, 2)).astype(np.float32)
    j = lambda *a: [jnp.asarray(x) for x in a]  # noqa: E731
    t = lambda *a: [_t(x) for x in a]  # noqa: E731
    _close(tbrdf.sample_cosine_lobe(*t(n, r2)), jbrdf.sample_cosine_lobe(*j(n, r2)))
    f0j = jbrdf.f0_from_metallic(*j(albedo, metal))
    f0t = tbrdf.f0_from_metallic(*t(albedo, metal))
    _close(f0t, f0j)
    _close(tbrdf.evaluate_uber_brdf(*t(albedo, rough, n), f0t, *t(wo, wh, wi)),
           jbrdf.evaluate_uber_brdf(*j(albedo, rough, n), f0j, *j(wo, wh, wi)))
    ndotv = np.clip(np.sum(n * wo, -1), 0, 1).astype(np.float32)
    _close(tbrdf.fresnel_schlick_roughness(_t(ndotv), f0t, _t(rough)),
           jbrdf.fresnel_schlick_roughness(jnp.asarray(ndotv), f0j, jnp.asarray(rough)))
    for g, r in zip(tbrdf.env_brdf_approx(*t(rough, ndotv)), jbrdf.env_brdf_approx(*j(rough, ndotv))):
        _close(g, r)


def test_filters_shift_box_upsample():
    rs = np.random.RandomState(3)
    img = rs.uniform(0, 1, (H, W, 3)).astype(np.float32)
    for dy, dx in ((0, 0), (2, -3), (-5, 1)):
        np.testing.assert_array_equal(tfilters.shift2d(_t(img), dy, dx).numpy(),
                                      np.asarray(jfilters.shift2d(jnp.asarray(img), dy, dx)))
    _close(tfilters.box_filter_sum(_t(img[..., 0]), 8),
           jax.jit(jfilters.box_filter_sum, static_argnums=1)(jnp.asarray(img[..., 0]), 8),
           rtol=1e-6, atol=1e-4)
    upsample = jax.jit(jfilters.upsample_edge_aware, static_argnums=5)
    for scale in (1, 2):
        s = 1 << scale
        low = rs.uniform(0, 1, (H // s, W // s, 3)).astype(np.float32)
        ln = _unit_rows(rs, (H // s) * (W // s)).reshape(H // s, W // s, 3)
        lz = rs.uniform(1, 3, (H // s, W // s)).astype(np.float32)
        hn = _unit_rows(rs, H * W).reshape(H, W, 3)
        hz = rs.uniform(1, 3, (H, W)).astype(np.float32)
        for sig in (low, low[..., 0]):
            _close(tfilters.upsample_edge_aware(*(_t(a) for a in (sig, ln, lz, hn, hz)), scale),
                   upsample(*(jnp.asarray(a) for a in (sig, ln, lz, hn, hz)), scale))


@pytest.mark.parametrize("spread", [0.7, 4.0, 12.0])
def test_warp_matches_static_window_select(spread):
    """The port's gathers equal the JAX static-window select, the ±6 px
    invalidation exactly, the values to an ulp (XLA fuses the select's
    multiply-adds)."""
    rs = np.random.RandomState(4)
    planes = rs.uniform(0, 1, (H, W, 4)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    hx = (xx + rs.normal(0, spread, (H, W))).astype(np.float32)
    hy = (yy + rs.normal(0, spread, (H, W))).astype(np.float32)
    for tf, jf in ((twarp.warp_bilinear, jax.jit(jwarp.warp_bilinear)),
                   (twarp.warp_nearest, jax.jit(jwarp.warp_nearest))):
        gv, gok = tf(_t(planes), _t(hx), _t(hy))
        rv, rok = jf(jnp.asarray(planes), jnp.asarray(hx), jnp.asarray(hy))
        np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
        ok = gok.numpy()
        assert 0 < ok.sum() and (spread < 6 or not ok.all())
        np.testing.assert_allclose(gv.numpy()[ok], np.asarray(rv)[ok], rtol=0, atol=1e-6)


def test_gbuffer_downsample_and_curvature(frames):
    jgb, tgb = frames["jgb"][1], frames["tgb"][1]
    for scale in (1, 2):
        jd = jgbuffer.downsample_gbuffer(jgb, scale)
        td = tgbuffer.downsample_gbuffer(tgb, scale)
        for f in dataclasses.fields(ttypes.GBuffer):
            np.testing.assert_array_equal(getattr(td, f.name).numpy(),
                                          np.asarray(getattr(jd, f.name)), f.name)
    mask = jgb.mesh_id >= 0
    _close(tgbuffer.screen_curvature(tgb.normal, tgb.mesh_id >= 0),
           jgbuffer.screen_curvature(jgb.normal, mask))


def test_reproject(frames):
    jgb0, jgb1 = frames["jgb"]
    tgb0, tgb1 = frames["tgb"]
    rs = np.random.RandomState(5)
    hist = rs.uniform(0, 1, (H, W)).astype(np.float32)
    mom = rs.uniform(0, 1, (H, W, 2)).astype(np.float32)
    hlen = rs.randint(0, 30, (H, W)).astype(np.float32)
    ref = jax.jit(jreprojection.reproject)(jgb1, jgb0, jnp.asarray(hist), jnp.asarray(mom),
                                           jnp.asarray(hlen))
    got = treprojection.reproject(tgb1, tgb0, _t(hist), _t(mom), _t(hlen))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert 0.2 < got.valid.numpy().mean() < 1.0
    for f in ("history", "history_moments", "history_length"):
        _close(getattr(got, f), getattr(ref, f), msg=f)


def _shadow_state(rs, h, w, module):
    return module.ShadowsState(
        history=rs.uniform(0, 1, (h, w)).astype(np.float32),
        moments=rs.uniform(0, 1, (h, w, 2)).astype(np.float32),
        history_length=rs.randint(0, 20, (h, w)).astype(np.float32))


def test_shadows_pass(frames):
    """Temporal accumulation + the à-trous chain (plain K3) on a shared raw
    plane and state, at full resolution as in the bench frame (the
    upsample is held to JAX's in test_filters_shift_box_upsample)."""
    scale = 0
    jgb0, jgb1 = frames["jgb"]
    tgb0, tgb1 = frames["tgb"]
    jg, jp = jgbuffer.downsample_gbuffer(jgb1, scale), jgbuffer.downsample_gbuffer(jgb0, scale)
    tg, tp = tgbuffer.downsample_gbuffer(tgb1, scale), tgbuffer.downsample_gbuffer(tgb0, scale)
    h, w = jg.depth.shape
    rs = np.random.RandomState(6)
    raw = (rs.uniform(0, 1, (h, w)) > 0.4).astype(np.float32)
    st = _shadow_state(rs, h, w, jshadows)
    jst = jshadows.ShadowsState(*(jnp.asarray(a) for a in dataclasses.astuple(st)))
    tst = tshadows.ShadowsState(*(_t(a) for a in dataclasses.astuple(st)))
    jc = jcfg.ShadowsConfig(scale=jcfg.RayTraceScale(scale))
    tc = tcfg.ShadowsConfig(scale=tcfg.RayTraceScale(scale))
    run = jax.jit(lambda *a: jshadows.shadows_pass(None, *a[:4], jst, 3, jc, raw=a[4]))
    jout, jnew = run(jg, jp, jgb1, frames["jlight"], jnp.asarray(raw))
    tout, tnew = tshadows.shadows_pass(None, tg, tp, tgb1, frames["tlight"], tst, 3, tc,
                                       raw=_t(raw))
    for name, g, r in zip(tout._fields, tout, jout):
        _close(g, r, atol=2e-5, msg=name)
    for f in ("history", "moments", "history_length"):
        _close(getattr(tnew, f), getattr(jnew, f), atol=2e-5, msg=f)


def test_shadow_and_ao_rays(frames):
    """Ray generation of both passes (what the batched K2 launch traces)."""
    jg, tg = frames["jgb"][1], frames["tgb"][1]
    jr = jshadows.make_rays(jg, frames["jlight"], 4, jcfg.ShadowsConfig())
    tr = tshadows.make_rays(tg, frames["tlight"], 4, tcfg.ShadowsConfig())
    for g, r in zip(tr, jr):
        _close(g, r)
    jr = jao.make_rays(jg, 4, jcfg.AOConfig())
    tr = tao.make_rays(tg, 4, tcfg.AOConfig())
    for g, r in zip(tr, jr):
        _close(g, r)


def test_ao_pass(frames):
    """Temporal accumulation + the bilateral blur (plain K4) + upsample +
    pow on a shared raw plane and state, at half resolution."""
    jgb0, jgb1 = frames["jgb"]
    tgb0, tgb1 = frames["tgb"]
    jg, jp = jgbuffer.downsample_gbuffer(jgb1, 1), jgbuffer.downsample_gbuffer(jgb0, 1)
    tg, tp = tgbuffer.downsample_gbuffer(tgb1, 1), tgbuffer.downsample_gbuffer(tgb0, 1)
    h, w = jg.depth.shape
    rs = np.random.RandomState(7)
    raw = (rs.uniform(0, 1, (h, w)) > 0.3).astype(np.float32)
    hist = rs.uniform(0, 1, (h, w)).astype(np.float32)
    hlen = rs.randint(0, 20, (h, w)).astype(np.float32)
    jst = jao.AOState(history=jnp.asarray(hist), history_length=jnp.asarray(hlen))
    tst = tao.AOState(history=_t(hist), history_length=_t(hlen))
    jc, tc = jcfg.AOConfig(), tcfg.AOConfig()
    run = jax.jit(lambda *a: jao.ao_pass(None, *a[:3], jst, 2, jc, raw=a[3]))
    jout, jnew = run(jg, jp, jgb1, jnp.asarray(raw))
    tout, tnew = tao.ao_pass(None, tg, tp, tgb1, tst, 2, tc, raw=_t(raw))
    for name, g, r in zip(tout._fields, tout, jout):
        _close(g, r, atol=2e-5, msg=name)
    _close(tnew.history, jnew.history, atol=2e-5)
    _close(tnew.history_length, jnew.history_length)


def test_deferred_and_tonemap(frames):
    jgb, tgb = frames["jgb"][1], frames["tgb"][1]
    jcam, tcam = frames["jcam"][1], frames["tcam"][1]
    rs = np.random.RandomState(8)
    vis = rs.uniform(0, 1, (H, W)).astype(np.float32)
    ao = rs.uniform(0, 1, (H, W)).astype(np.float32)
    js = jsky.ProceduralSky.create(sun_direction=np.asarray(frames["jlight"].direction))
    ts = tsky.ProceduralSky.create(frames["tlight"].direction.numpy())
    jirr, jpref = jsh.make_env_fallbacks(js.radiance, num_samples=512)
    tirr, tpref = tsh.make_env_fallbacks(ts.radiance, num_samples=512)
    jcomp, tcomp = {}, {}
    ref = jdeferred.deferred_shading(jgb, jcam, frames["jlight"], js.radiance, W, H,
                                     shadow_visibility=jnp.asarray(vis), ao=jnp.asarray(ao),
                                     env_irradiance_fn=jirr, env_prefiltered_fn=jpref,
                                     components_out=jcomp)
    got = tdeferred.deferred_shading(tgb, tcam, frames["tlight"], ts.radiance, W, H,
                                     shadow_visibility=_t(vis), ao=_t(ao),
                                     env_irradiance_fn=tirr, env_prefiltered_fn=tpref,
                                     components_out=tcomp)
    _close(got, ref, rtol=1e-4)
    assert sorted(tcomp) == sorted(jcomp)
    for k in jcomp:
        _close(tcomp[k], jcomp[k], rtol=1e-4, msg=k)
    cfg_j, cfg_t = jcfg.ToneMapConfig(), tcfg.ToneMapConfig()
    hdr = np.asarray(ref)
    _close(ttonemap.tonemap(_t(hdr), cfg_t), jtonemap.tonemap(jnp.asarray(hdr), cfg_j))


@pytest.mark.parametrize("initialized", [0, 1])
def test_taa_resolve(frames, initialized):
    """Same inputs, same resolve: velocity dilation, warp, clip, feedback
    and sharpen follow the JAX code op for op."""
    jgb, tgb = frames["jgb"][1], frames["tgb"][1]
    rs = np.random.RandomState(9)
    color = rs.uniform(0, 2, (H, W, 3)).astype(np.float32)
    hist = rs.uniform(0, 2, (H, W, 3)).astype(np.float32)
    for sharpen in (False, True):
        jc = jcfg.TAAConfig(sharpen=sharpen)
        tc = tcfg.TAAConfig(sharpen=sharpen)
        resolve = jax.jit(lambda c, g, s, _cfg=jc: jtaa.taa_resolve(c, g, s, _cfg))
        ref, jst = resolve(jnp.asarray(color), jgb,
                           jtaa.TAAState(jnp.asarray(hist), jnp.int32(initialized)))
        got, tst = ttaa.taa_resolve(_t(color), tgb, ttaa.TAAState(_t(hist), bool(initialized)),
                                    tc)
        _close(got, ref, msg=f"sharpen={sharpen}")
        _close(tst.history, jst.history)
        assert tst.initialized


def test_port_blue_noise_mask_is_its_own_copy(monkeypatch):
    """The port ships its own blue-noise mask, byte for byte the JAX
    package's, and ``get_mask`` opens nothing under the JAX package."""
    import os

    import hybrid_rendering_tpu
    import hybrid_rendering_torch

    jdir = os.path.dirname(os.path.abspath(hybrid_rendering_tpu.__file__))
    tdir = os.path.dirname(os.path.abspath(hybrid_rendering_torch.__file__))
    with open(os.path.join(jdir, "data", "blue_noise_128.npy"), "rb") as f:
        jbytes = f.read()
    with open(os.path.join(tdir, "data", "blue_noise_128.npy"), "rb") as f:
        assert f.read() == jbytes
    assert os.path.abspath(tbluenoise._DATA) == os.path.join(tdir, "data", "blue_noise_128.npy")

    real_exists, real_load = os.path.exists, np.load

    def refuse(path):
        if os.path.abspath(os.fspath(path)).startswith(jdir + os.sep):
            raise AssertionError(f"the port opened {path}")

    def exists(path):
        refuse(path)
        return real_exists(path)

    def load(path, *args, **kw):
        refuse(path)
        return real_load(path, *args, **kw)

    monkeypatch.setattr(os.path, "exists", exists)
    monkeypatch.setattr(np, "load", load)
    tbluenoise.get_mask.cache_clear()
    try:
        mask = tbluenoise.get_mask()
        assert mask.shape == (128, 128, 2) and mask.dtype == np.float32
        np.testing.assert_array_equal(mask, jbluenoise.get_mask())
    finally:
        tbluenoise.get_mask.cache_clear()


@pytest.mark.parametrize("helper", ["make_camera", "pixel_grid", "sample2d_grid",
                                    "make_env_fallbacks"])
def test_helpers_with_a_device_argument_build_there(helper):
    """The helpers whose `device` defaults to None (the CPU) put every
    tensor on the device they are given; the renderer and the passes hand
    them their own device, so none leaves a CPU tensor on a frame's path.
    The meta device stands in for the card."""
    from hybrid_rendering_torch.ops import bluenoise, sh
    from hybrid_rendering_torch.ops.sky import ProceduralSky
    from hybrid_rendering_torch.utils import camera

    if helper == "make_camera":
        cam = camera.make_camera((0.0, 1.0, 5.0), (0.0, 0.0, 0.0), width=8, height=4,
                                 device="meta")
        made = [getattr(cam, f.name) for f in dataclasses.fields(cam)]
    elif helper == "pixel_grid":
        made = list(camera.pixel_grid(4, 8, "meta"))
    elif helper == "sample2d_grid":
        made = list(bluenoise.sample2d_grid(4, 8, 3, dim=1, device="meta"))
    else:
        sky = ProceduralSky.create(np.asarray([0.3, 0.8, 0.2], np.float32)).to("meta")
        irradiance, prefiltered = sh.make_env_fallbacks(sky.radiance, device="meta")
        d = torch.zeros((4, 3), device="meta")
        made = [irradiance(d), prefiltered(d, torch.zeros(4, device="meta"))]
    tensors = [t for t in made if isinstance(t, torch.Tensor)]
    assert tensors and all(t.device.type == "meta" for t in tensors)
