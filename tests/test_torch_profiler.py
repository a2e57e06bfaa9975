"""The port's tracing (``hybrid_rendering_torch/utils/profiler.py``) on the
CPU, at 32x24 on the tiny scene of ``entry_torch``:

- a hybrid frame and a path-traced sample with tracing on give the span
  tree of every pass and stage, self time never above inclusive time, and
  rays by site that add up to what a counting wrapper of the renderer's
  tracers counts on the same frame (a sample: 3 requests of W x H and 3
  of 2 W x H);
- off, no span opens a ``torch.profiler.record_function`` range and
  nothing is recorded; under a torch.profiler session the spans are on;
- spans nest per thread, and a sharded tracer counts a ray once;
- on a textured scene the maps are sampled inside a span ``material``
  under each surface fetch (the G-buffer's, DDGI's probe hits, the
  reflection hits), whose counter ``material_samples`` holds four samples
  a lane fetched; an untextured frame has neither."""
import threading

import pytest
import torch

import entry_torch
from hybrid_rendering_torch import config as tcfg
from hybrid_rendering_torch.models import path_tracer
from hybrid_rendering_torch.models.renderer import HybridRenderer
from hybrid_rendering_torch.parallel import mesh as tmesh
from hybrid_rendering_torch.parallel import trace as ttrace
from hybrid_rendering_torch.utils import profiler

W, H = 32, 24
RAYS_PER_PROBE = 8

FRAME_TREE = {
    "render_frame": {
        "gbuffer": {"closest": {}},
        "mips": {},
        "shadows_ao.rays": {"visibility": {}},
        "shadows": {"temporal": {}, "atrous": {}},
        "ao": {"mips": {}, "temporal": {}, "blur": {}, "upsample": {}},
        "ddgi.update": {"rays": {}, "trace": {"closest": {}},
                        "shade": {"direct_light": {"visibility": {}}}, "update": {}},
        "ddgi.sample": {},
        "ddgi.upsample": {},
        "reflections": {"ray_trace": {"closest": {}, "direct_light": {"visibility": {}}},
                        "temporal": {}, "atrous": {}, "upsample": {}},
        "deferred": {}, "taa": {}, "tonemap": {},
    },
    "camera": {},
}
SAMPLE_TREE = {
    "trace_sample": {"pt.rays": {}, "pt.closest": {"closest": {}}, "pt.env": {},
                     "pt.direct": {"direct_light": {"visibility": {}}}, "pt.scatter": {}},
    "accumulate": {},
}


def _paths(tree, prefix=""):
    out = set()
    for name, children in tree.items():
        path = prefix + name
        out |= {path} | _paths(children, path + "/")
    return out


class _Counting:
    """A tracer with its rays counted, ``.many`` counting every request,
    as the benchmark's wrapper of the renderer's tracers counts them."""

    def __init__(self, fn, counts):
        self.fn, self.counts = fn, counts

    def __call__(self, origin, direction, t_max):
        self.counts.append(origin.numel() // 3)
        return self.fn(origin, direction, t_max)

    def many(self, reqs):
        self.counts.append(sum(r[0].numel() // 3 for r in reqs))
        return self.fn.many(reqs)


@pytest.fixture(scope="module")
def tiny():
    """The renderer at 32x24 with the benchmark frame's scales (shadows
    full, AO and reflections half, DDGI quarter), DDGI at 8 rays a probe,
    and one frame rendered with tracing off."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    scene, light, sky, _, _ = entry_torch._tiny_setup(W, H, "cpu")
    cfg = entry_torch._tiny_config(W, H)
    cfg = cfg.replace(ddgi=tcfg.DDGIConfig(probe_distance=4.0, rays_per_probe=RAYS_PER_PROBE,
                                           scale=tcfg.RayTraceScale.QUARTER),
                      shadows=tcfg.ShadowsConfig(scale=tcfg.RayTraceScale.FULL))
    r = HybridRenderer(scene, cfg, sky.radiance, device="cpu")
    state = r.create_state()
    _, state = r.render_frame(state, r.make_camera((4.0, 3.0, 6.0), (0.0, 0.5, 0.0), 0), light)
    yield r, state, light
    torch.set_num_threads(threads)


@pytest.fixture
def tracing():
    """Tracing on for the test, and the record empty before and after."""
    profiler.collect()
    profiler.enable()
    yield
    profiler.disable()
    profiler.collect()


def test_frame_and_sample_span_trees_and_rays(tiny, tracing):
    r, state, light = tiny
    counts = []
    closest, vis = r.closest_surface_fn, r.visibility_fn
    r.closest_surface_fn, r.visibility_fn = _Counting(closest, counts), _Counting(vis, counts)
    try:
        cam = r.make_camera((4.2, 3.0, 6.0), (0.0, 0.5, 0.0), 1, prev_view_proj=None)
        r.render_frame(state, cam, light)
        rec = profiler.collect()
        frame_counts, counts[:] = list(counts), []
        gt = path_tracer.GroundTruthState.create(H, W, "cpu")
        sample = path_tracer.trace_sample(r.scene, r.closest_surface_fn, r.visibility_fn, cam,
                                          light, r.sky_radiance_fn, W, H, 0,
                                          tcfg.PathTracerConfig(max_ray_bounces=3))
        path_tracer.accumulate(gt, sample)
        pt_rec = profiler.collect()
    finally:
        r.closest_surface_fn, r.visibility_fn = closest, vis

    spans, rays = rec["spans"], rec["counters"]["rays"]
    assert set(spans) == _paths(FRAME_TREE)
    # parents before children, in the order they first ran
    assert list(spans)[:3] == ["camera", "render_frame", "render_frame/gbuffer"]
    for table in (spans, pt_rec["spans"]):
        for path, row in table.items():
            assert 0.0 <= row["self_s"] <= row["host_s"], path
            children = [p for p in table if p.rsplit("/", 1)[0] == path and p != path]
            assert sum(table[c]["host_s"] for c in children) <= row["host_s"] + 1e-9, path
    assert spans["render_frame/mips"]["calls"] == 2  # half and quarter of this frame
    probe_rays = r.probe_grid.num_probes * RAYS_PER_PROBE
    assert rays == {
        "render_frame/gbuffer/closest": W * H,
        "render_frame/shadows_ao.rays/visibility": W * H + (W // 2) * (H // 2),
        "render_frame/ddgi.update/trace/closest": probe_rays,
        # the sun's and the sky's rays in one call
        "render_frame/ddgi.update/shade/direct_light/visibility": 2 * probe_rays,
        "render_frame/reflections/ray_trace/closest": (W // 2) * (H // 2),
        "render_frame/reflections/ray_trace/direct_light/visibility": (W // 2) * (H // 2),
    }
    assert spans["render_frame/ddgi.update/shade/direct_light/visibility"]["calls"] == 1
    assert sum(rays.values()) == sum(frame_counts)
    # an untextured scene samples no map: no span, no counter
    assert "material_samples" not in rec["counters"]
    assert "material_samples" not in pt_rec["counters"]

    pt_spans, pt_rays = pt_rec["spans"], pt_rec["counters"]["rays"]
    assert set(pt_spans) == _paths(SAMPLE_TREE)
    assert pt_spans["trace_sample/pt.closest"]["calls"] == 3  # one a bounce
    assert pt_spans["trace_sample/pt.scatter"]["calls"] == 2
    assert pt_spans["trace_sample/pt.closest/closest"]["calls"] == 3
    # a bounce's shadow and sky rays in one call
    assert pt_spans["trace_sample/pt.direct/direct_light/visibility"]["calls"] == 3
    assert counts == [W * H, 2 * W * H] * 3
    assert sum(pt_rays.values()) == 9 * W * H
    text = profiler.table(rec)
    assert "reflections" in text and f"{W * H:10.0f}" in text


@pytest.fixture(scope="module")
def textured(tiny):
    """The tiny scene's renderer settings on a textured plane and box: two
    materials of ``sponza_pbr``'s maps at 16², with one frame rendered
    with tracing off."""
    from hybrid_rendering_torch.scene import pbr_maps
    from hybrid_rendering_torch.scene import primitives as prim
    from hybrid_rendering_torch.scene.build import MaterialDef, SceneBuilder, translation

    r0, _, light = tiny
    b = SceneBuilder()
    mats = []
    for k in (0, 6):  # flagstones; a column with bronze bands
        albedo, normal, mr = (b.add_texture(img) for img in pbr_maps.material_maps(k, 16))
        mats.append(b.add_material(MaterialDef(albedo_tex=albedo, normal_tex=normal,
                                               roughness_tex=mr, metallic_tex=mr)))
    b.add_instance(prim.plane(20.0, 20.0), mats[0])
    b.add_instance(prim.box(1.0, 1.0, 1.0), mats[1], translation(0, 0.5, 0))
    r = HybridRenderer(b.build(use_bvh=True), r0.config, r0.sky_radiance_fn, device="cpu")
    state = r.create_state()
    _, state = r.render_frame(state, r.make_camera((4.0, 3.0, 6.0), (0.0, 0.5, 0.0), 0), light)
    return r, state, light


def test_material_span_and_samples_at_every_fetch(textured, tracing):
    r, state, light = textured
    cam = r.make_camera((4.2, 3.0, 6.0), (0.0, 0.5, 0.0), 1)
    r.render_frame(state, cam, light)
    rec = profiler.collect()
    fetches = ("render_frame/gbuffer/closest", "render_frame/ddgi.update/trace/closest",
               "render_frame/reflections/ray_trace/closest")
    material = {p for p in rec["spans"] if p.endswith("/material")}
    assert material == {f"{p}/material" for p in fetches}
    assert set(rec["spans"]) - material == _paths(FRAME_TREE)
    for p in fetches:
        assert rec["spans"][f"{p}/material"]["calls"] == 1
        assert rec["spans"][f"{p}/material"]["host_s"] <= rec["spans"][p]["host_s"]
    # albedo, normal, roughness and metallic: four samples a lane fetched
    rays = rec["counters"]["rays"]
    assert rec["counters"]["material_samples"] == {f"{p}/material": 4 * rays[p] for p in fetches}
    sample = path_tracer.trace_sample(r.scene, r.closest_surface_fn, r.visibility_fn, cam,
                                      light, r.sky_radiance_fn, W, H, 0,
                                      tcfg.PathTracerConfig(max_ray_bounces=2))
    assert bool(torch.isfinite(sample).all())
    pt = profiler.collect()
    assert pt["counters"]["material_samples"] == {
        "trace_sample/pt.closest/closest/material": 4 * 2 * W * H}


def test_tracing_off_opens_no_range(tiny, monkeypatch):
    r, state, light = tiny
    profiler.disable()
    profiler.collect()

    def refuse(name, *a, **kw):
        raise AssertionError(f"record_function({name!r}) while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cam = r.make_camera((4.0, 3.0, 6.0), (0.0, 0.5, 0.0), 2)
    r.render_frame(state, cam, light)
    path_tracer.trace_sample(r.scene, r.closest_surface_fn, r.visibility_fn, cam, light,
                             r.sky_radiance_fn, 8, 8, 0, tcfg.PathTracerConfig(max_ray_bounces=1))
    assert profiler.span("x") is profiler.span("y")  # one shared no-op
    assert profiler.collect() == {"spans": {}, "counters": {}}


def test_spans_follow_a_profiler_session():
    """Without ``enable()``, a torch.profiler session turns the spans on:
    each is an ``hr::<path>`` range of the session."""
    profiler.collect()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.span("outer"):
            with profiler.span("inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"hr::outer", "hr::outer/inner"} <= names
    assert set(profiler.collect()["spans"]) == {"outer", "outer/inner"}
    with profiler.span("after"):
        pass
    assert profiler.collect()["spans"] == {}


def test_spans_nest_per_thread(tracing):
    """Two threads open spans in turns, each inside its own root: every
    path is its own thread's."""
    barrier = threading.Barrier(2, timeout=10)

    def work(root):
        with profiler.span(root):
            for _ in range(20):
                barrier.wait()
                with profiler.span("step"):
                    barrier.wait()

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = profiler.collect()["spans"]
    assert set(spans) == {"a", "a/step", "b", "b/step"}
    assert spans["a/step"]["calls"] == spans["b/step"]["calls"] == 20


def test_sharded_tracer_counts_a_ray_once(tiny, tracing):
    """A flat batch of 7 rays over 3 shards is padded to 9; the span
    counts 7 rays, once, and its shards open no span of their own."""
    r = tiny[0]
    sharded = ttrace.shard_ray_fn(tmesh.make_mesh(devices=["cpu"] * 3), r.visibility_fn)
    o = torch.tensor([[0.0, 2.0, 0.0]]).repeat(7, 1)
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(7, 1)
    with profiler.span("site"):
        sharded(o, d, 10.0)
        sharded.many([(o, d, 10.0), (o[:2], d[:2], 10.0)])
    rec = profiler.collect()
    assert set(rec["spans"]) == {"site", "site/visibility"}
    assert rec["spans"]["site/visibility"]["calls"] == 2
    assert rec["counters"]["rays"] == {"site/visibility": 7 + 9}
