"""The benchmark harness of ``hybrid_rendering_torch``: cells found by
name in ``BENCHMARK.json``, configurations in ``benchmark/configs``,
traffic mixes in ``benchmark/traffic``, the kinds of frame they name in
``benchmark/frames``, per-layer metric readers in ``benchmark/metrics``
and comparison limits in ``benchmark/limits``."""
