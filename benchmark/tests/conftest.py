"""The benchmark's own tests: ``python3 -m pytest benchmark/tests``.

Tests that need a CUDA card carry the ``card`` marker and decide inside
the test whether there is one."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (os.path.dirname(BENCH), os.path.join(BENCH, "reference"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
