"""PyTorch port vs JAX package: the blue-noise grid sampler in both of its
modes ("bn_r2", "sobol_bn"), bit for bit, and the choice between them by
``HR_SAMPLER``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hybrid_rendering_tpu.ops import bluenoise as jbluenoise
from hybrid_rendering_torch.ops import bluenoise as tbluenoise

GRID = (130, 257)  # not a multiple of the 128-pixel tile on either axis
FRAMES = (0, 1, 7, 31, 2**20 + 3)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(port, ref):
    """Bit-for-bit equality of the port's (u, v) with the reference's."""
    for t, j in zip(port, ref):
        j = np.asarray(j)
        assert t.dtype == torch.float32 and j.dtype == np.float32
        np.testing.assert_array_equal(t.numpy().view(np.uint32), j.view(np.uint32))


@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("frame", FRAMES)
def test_sobol_bn_grid_equals_reference(frame, dim):
    _equal(tbluenoise.sample2d_grid(*GRID, frame, dim, mode="sobol_bn"),
           jbluenoise._sample2d_grid_sobol(*GRID, frame, dim))


@pytest.mark.parametrize("frame,dim", [(0, 0), (7, 1), (2**20 + 3, 2)])
def test_bn_r2_grid_equals_reference(frame, dim, monkeypatch):
    monkeypatch.setattr(jbluenoise, "SAMPLER", "bn_r2")
    _equal(tbluenoise.sample2d_grid(*GRID, frame, dim, mode="bn_r2"),
           jbluenoise.sample2d_grid(*GRID, frame, dim))


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_scramble_tables_equal_reference(dim):
    mask = tbluenoise.get_mask()
    for t, j in zip(tbluenoise._scramble_tables(mask, dim),
                    jbluenoise._scramble_tables(jbluenoise.get_mask(), dim)):
        assert t.dtype == j.dtype == np.uint32
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("sampler", ["bn_r2", "sobol_bn"])
def test_default_mode_follows_module_setting(sampler, monkeypatch):
    """With no `mode`, the grid is the one ``SAMPLER`` names, as in the
    reference."""
    monkeypatch.setattr(tbluenoise, "SAMPLER", sampler)
    monkeypatch.setattr(jbluenoise, "SAMPLER", sampler)
    _equal(tbluenoise.sample2d_grid(*GRID, 7, 1), jbluenoise.sample2d_grid(*GRID, 7, 1))


def test_hr_sampler_read_as_the_reference_reads_it():
    """``HR_SAMPLER`` at import: "sobol_bn" selects the Sobol grid, any
    other value (or none) the R2 rotation. Read in subprocesses, so this
    process's environment is left alone."""
    code = ("from hybrid_rendering_torch.ops import bluenoise; print(bluenoise.SAMPLER)")
    seen = {}
    for value in ("sobol_bn", "bn_r2", "something else", None):
        env = {k: v for k, v in os.environ.items() if k != "HR_SAMPLER"}
        if value is not None:
            env["HR_SAMPLER"] = value
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, check=True, timeout=120)
        seen[value] = out.stdout.strip()
    assert seen == {"sobol_bn": "sobol_bn", "bn_r2": "bn_r2", "something else": "bn_r2",
                    None: "bn_r2"}


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        tbluenoise.sample2d_grid(4, 4, 0, mode="white")


def test_tables_uploaded_once_per_device():
    """The scramble tables and the mask are built once per device and
    reused: a second call makes no new copy."""
    tbluenoise.sample2d_grid(8, 8, 3, 1, mode="sobol_bn")
    tbluenoise.sample2d_grid(8, 8, 3, 1, mode="bn_r2")
    tables = [tbluenoise._on_device(k, d, "cpu") for k, d in (("sobol", 1), ("mask", 0))]
    before = tbluenoise._on_device.cache_info()
    tbluenoise.sample2d_grid(*GRID, 4, 1, mode="sobol_bn")
    tbluenoise.sample2d_grid(*GRID, 4, 1, mode="bn_r2")
    after = tbluenoise._on_device.cache_info()
    assert after.misses == before.misses and after.hits == before.hits + 2
    assert all(tbluenoise._on_device(k, d, "cpu") is t
               for (k, d), t in zip((("sobol", 1), ("mask", 0)), tables))
