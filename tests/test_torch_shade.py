"""Direct light in two stages around one visibility call
(``ops/lighting.direct_lighting``; its kernel K7, ``ops/shade.py``, is
checked against the same stages on the card by ``chip_smoke.py``):

- the two stages equal the one-pass function they replaced bit for bit,
  for every light type, with and without soft shadows, a sky sample, a
  throughput and a validity mask, on flat and image-shaped batches;
- the visibility function sees one call: 2N rays with a sky sample, N
  without, with t_max = 0 exactly where the point is not valid or, for
  the shadow ray, where the light's attenuation is 0;
- the result matches the JAX package's direct_lighting;
- the span ``direct_light`` and the ``sky_fn_points`` counter, and which
  skies K7 evaluates itself."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rendering_tpu import types as jtypes
from hybrid_rendering_tpu.ops import brdf as jbrdf
from hybrid_rendering_tpu.ops import lighting as jlighting
from hybrid_rendering_tpu.ops import sky as jsky
from hybrid_rendering_torch import types as ttypes
from hybrid_rendering_torch.ops import brdf as tbrdf
from hybrid_rendering_torch.ops import lighting as tlighting
from hybrid_rendering_torch.ops import shade as tshade
from hybrid_rendering_torch.ops import sky as tsky
from hybrid_rendering_torch.ops.math3d import normalize
from hybrid_rendering_torch.utils import profiler

LIGHTS = {
    "directional": lambda m: m.Light.directional((0.35, 0.9, 0.25), radius=0.05),
    "point": lambda m: m.Light.point((1.0, 6.0, -2.0), intensity=40.0, radius=0.3),
    "spot": lambda m: m.Light.spot((0.0, 9.0, 0.0), (0.0, -1.0, 0.1), intensity=250.0,
                                   radius=0.3, inner_angle_deg=35.0, outer_angle_deg=55.0),
}
SUN = np.asarray([0.3, 0.8, 0.2])


def _one_pass(light, wo, n, p, f0, diffuse_color, roughness, *, visibility_fn=None,
              throughput=None, rng_shadow=None, rng_sky=None, sky_radiance_fn=None,
              ray_origin_bias=0.1):
    """direct_lighting as it was before its two stages: one visibility call
    for the light, one more for the sky ray."""

    def weighted(val):
        return val if throughput is None else throughput * val

    ray_origin = p + n * ray_origin_bias
    li, wi, t_max, att = tlighting.fetch_light_properties(
        light, p, n, rng2=rng_shadow, soft_shadows=rng_shadow is not None)
    if visibility_fn is not None:
        vis = visibility_fn(ray_origin, wi, t_max)
        att = att * torch.where(att > 0.0, vis, 0.0)
    wh = normalize(wo + wi)
    val = tbrdf.evaluate_uber_brdf(diffuse_color, roughness, n, f0, wo, wh, wi)
    lo = weighted(val) * att[..., None] * li
    if sky_radiance_fn is not None and rng_sky is not None:
        wi_s = tbrdf.sample_cosine_lobe(n, rng_sky)
        li_s = sky_radiance_fn(wi_s)
        if visibility_fn is not None:
            t_sky = torch.full(p.shape[:-1], 1e4, dtype=p.dtype, device=p.device)
            li_s = li_s * visibility_fn(ray_origin, wi_s, t_sky)[..., None]
        wh_s = normalize(wo + wi_s)
        val_s = tbrdf.evaluate_uber_brdf(diffuse_color, roughness, n, f0, wo, wh_s, wi_s)
        lo = lo + weighted(val_s) * li_s
    return lo


def _unit(rs, lead):
    v = rs.normal(size=lead + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _inputs(lead, seed=1):
    """Points around the lights, a third of them facing away (att = 0),
    as numpy float32: p, n, wo, albedo, metallic, roughness, throughput,
    rng_shadow, rng_sky, valid."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(-5, 5, lead + (3,)).astype(np.float32)
    n = _unit(rs, lead)
    n[..., 1] = np.where(rs.uniform(size=lead) < 0.67, np.abs(n[..., 1]), -np.abs(n[..., 1]))
    wo = _unit(rs, lead)
    albedo = rs.uniform(0, 1, lead + (3,)).astype(np.float32)
    metal = rs.uniform(0, 1, lead).astype(np.float32)
    rough = rs.uniform(0.05, 1, lead).astype(np.float32)
    tp = rs.uniform(0, 2, lead + (3,)).astype(np.float32)
    r_sh, r_sky = (rs.uniform(0, 1, lead + (2,)).astype(np.float32) for _ in range(2))
    valid = rs.uniform(size=lead) < 0.7
    return p, n, wo, albedo, metal, rough, tp, r_sh, r_sky, valid


def _fake_visibility(module, calls=None):
    """Blocked where the ray heads down or where t_max is 0; `calls`
    collects (origin, direction, t_max) of each call."""
    def vis(o, d, t_max):
        if calls is not None:
            calls.append((o, d, t_max))
        return module.where((d[..., 1] > -0.2) & (t_max > 0.0), 1.0, 0.0)
    return vis


def _torch_args(kind, lead, seed=1):
    p, n, wo, albedo, metal, rough, tp, r_sh, r_sky, valid = (
        torch.from_numpy(np.asarray(a)) for a in _inputs(lead, seed))
    f0 = tbrdf.f0_from_metallic(albedo, metal)
    return LIGHTS[kind](ttypes), (wo, n, p, f0, albedo, rough), tp, r_sh, r_sky, valid


@pytest.mark.parametrize("lead", [(157,), (6, 11)], ids=["flat", "image"])
@pytest.mark.parametrize("valid", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("throughput", [False, True], ids=["no_T", "T"])
@pytest.mark.parametrize("sky", [False, True], ids=["no_sky", "sky"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("kind", sorted(LIGHTS))
def test_two_stages_equal_one_pass_bit_for_bit(kind, soft, sky, throughput, valid, lead):
    light, args, tp, r_sh, r_sky, vmask = _torch_args(kind, lead)
    sky_fn = tsky.ProceduralSky.create(SUN).radiance
    kw = dict(throughput=tp if throughput else None, rng_shadow=r_sh if soft else None,
              rng_sky=r_sky if sky else None, sky_radiance_fn=sky_fn if sky else None)
    vis = _fake_visibility(torch)
    if valid:
        # the callers' closures before the mask moved into direct_lighting
        def old_vis(o, d, t_max):
            return vis(o, d, torch.where(vmask, t_max, 0.0))
    else:
        old_vis = vis
    want = _one_pass(light, *args, visibility_fn=old_vis, **kw)
    got = tlighting.direct_lighting(light, *args, visibility_fn=vis,
                                    valid=vmask if valid else None, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0.01
    # and without a visibility function
    assert torch.equal(tlighting.direct_lighting(light, *args, **kw),
                       _one_pass(light, *args, **kw))


@pytest.mark.parametrize("valid", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("sky", [False, True], ids=["no_sky", "sky"])
@pytest.mark.parametrize("kind", sorted(LIGHTS))
def test_one_visibility_call_masks_t_max(kind, sky, valid):
    lead = (203,)
    light, args, tp, r_sh, r_sky, vmask = _torch_args(kind, lead, seed=2)
    wo, n, p = args[:3]
    calls = []
    tlighting.direct_lighting(
        light, *args, visibility_fn=_fake_visibility(torch, calls), throughput=tp,
        rng_shadow=r_sh, rng_sky=r_sky if sky else None,
        sky_radiance_fn=tsky.ProceduralSky.create(SUN).radiance if sky else None,
        valid=vmask if valid else None)
    assert len(calls) == 1
    o, d, t_max = calls[0]
    N = lead[0]
    k = 2 if sky else 1
    assert o.shape == d.shape == (k * N, 3) and t_max.shape == (k * N,)
    _, wi, t_light, att = tlighting.fetch_light_properties(light, p, n, rng2=r_sh)
    live = vmask if valid else torch.ones(lead, dtype=torch.bool)
    masked = ~live | (att == 0.0)
    assert bool(masked.any()) and bool((~masked).any())
    assert torch.equal(t_max[:N] == 0.0, masked)
    assert torch.equal(t_max[:N][~masked], t_light[~masked])
    assert torch.equal(d[:N], wi)
    assert torch.equal(o[:N], p + n * 0.1)
    if sky:
        assert torch.equal(t_max[N:] == 0.0, ~live)
        assert bool((t_max[N:][live] == 1e4).all())
        assert torch.equal(o[N:], o[:N])
        assert torch.equal(d[N:], tbrdf.sample_cosine_lobe(n, r_sky))


@pytest.mark.parametrize("kind", sorted(LIGHTS))
def test_matches_jax(kind):
    """Against the JAX package, with a throughput, a sky sample and the
    mask as a JAX-side visibility wrapper (rtol = atol = 1e-5, as the
    other port-versus-JAX lighting tests)."""
    lead = (256,)
    p, n, wo, albedo, metal, rough, tp, r_sh, r_sky, valid = _inputs(lead, seed=3)
    jl, tl = LIGHTS[kind](jtypes), LIGHTS[kind](ttypes)
    jvis = _fake_visibility(jnp)
    jmask = jnp.asarray(valid)

    def jvis_valid(o, d, t_max):
        return jvis(o, d, jnp.where(jmask, t_max, 0.0))

    jf0 = jbrdf.f0_from_metallic(jnp.asarray(albedo), jnp.asarray(metal))
    ref = jlighting.direct_lighting(
        jl, jnp.asarray(wo), jnp.asarray(n), jnp.asarray(p), jf0, jnp.asarray(albedo),
        jnp.asarray(rough), visibility_fn=jvis_valid, throughput=jnp.asarray(tp),
        rng_shadow=jnp.asarray(r_sh), rng_sky=jnp.asarray(r_sky),
        sky_radiance_fn=jsky.ProceduralSky.create(sun_direction=SUN).radiance)
    t = torch.from_numpy
    got = tlighting.direct_lighting(
        tl, t(wo), t(n), t(p), tbrdf.f0_from_metallic(t(albedo), t(metal)), t(albedo),
        t(rough), visibility_fn=_fake_visibility(torch), throughput=t(tp), rng_shadow=t(r_sh),
        rng_sky=t(r_sky), sky_radiance_fn=tsky.ProceduralSky.create(SUN).radiance,
        valid=t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert float(np.asarray(ref).max()) > 0.01


def test_span_and_sky_counter():
    """On the CPU every sky sample goes through the sky's callable, counted
    at the span ``direct_light``; ``shaded`` counts K7's points alone."""
    light, args, tp, r_sh, r_sky, _ = _torch_args("point", (40,))
    profiler.collect()
    profiler.enable()
    try:
        with profiler.span("site"):
            tlighting.direct_lighting(light, *args, visibility_fn=_fake_visibility(torch),
                                      rng_shadow=r_sh, rng_sky=r_sky,
                                      sky_radiance_fn=tsky.ProceduralSky.create(SUN).radiance)
            tlighting.direct_lighting(light, *args, rng_shadow=r_sh)
    finally:
        profiler.disable()
    rec = profiler.collect()
    assert rec["spans"]["site/direct_light"]["calls"] == 2
    assert rec["counters"] == {"sky_fn_points": {"site/direct_light": 40}}
    assert "sky_fn_points" in profiler.table(rec)


def test_which_sky_the_kernel_evaluates():
    sky = tsky.ProceduralSky.create(SUN)
    assert tshade.procedural_sky(sky.radiance) is sky

    class Brighter(tsky.ProceduralSky):
        def radiance(self, dirs):
            return 2.0 * super().radiance(dirs)

    others = (Brighter(sky.sun_direction, sky.sun_intensity, sky.turbidity).radiance,
              tsky.PreethamSky.create(SUN).radiance,
              tsky.ConstantSky(torch.ones(3)).radiance, lambda d: sky.radiance(d))
    assert all(tshade.procedural_sky(fn) is None for fn in others)
