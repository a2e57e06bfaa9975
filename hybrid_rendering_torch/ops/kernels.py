"""Build and load the port's hand-written CUDA kernels.

All sources under ``hybrid_rendering_torch/csrc/`` compile with ``nvcc``
for ``sm_90a`` (one process per source, in parallel) and link into one
shared library with a plain C interface, loaded with ctypes (no PyTorch
headers, so the build takes seconds). The build runs at first use and
again whenever a source is newer than the library.
Every kernel launches on its operands' device: the wrapper makes that
device current (``torch.cuda.device``, which sets nothing when it already
is) and launches on its current stream (``stream_ptr(device)``);
``require`` refuses an operand on any other device. Every C entry point
returns ``cudaGetLastError()`` and ``check`` raises if it is not 0.

Each source has its own multiply-add flag (``_FMAD``). The default is
``-fmad=false``: no contraction, so a kernel rounds op by op like its plain
PyTorch version (trace.cu, flashtrace.cu, ddgi_sample.cu, shade.cu,
temporal.cu: bit parity).
stencil.cu is built with ``-fmad=true``: K3 is bound by instruction rate
and is held to a tolerance instead (K4 and K3's luma, in the same file,
write their unfused operations out).
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libhr_kernels.so")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

MAX_BLUR_RADIUS = 8
MAX_FUSED = 4  # à-trous iterations one launch can fuse (csrc/stencil.cu)

# multiply-add contraction per source; sources not named here get "false"
_FMAD = {"stencil.cu": "true"}


class GaussTaps(ctypes.Structure):
    """Bilateral-blur Gaussian taps, passed to the kernel by value."""

    _fields_ = [("w", ctypes.c_float * (2 * MAX_BLUR_RADIUS + 1))]


# C signatures: pointers and the stream as c_void_p, ints as c_int
_SIGNATURES = {
    "hr_trace_closest": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _F, _P, _P, _P, _P, _P, _P],
    "hr_trace_visibility": [_P, _I, _P, _I, _P, _P, _P, _I, _F, _P, _P],
    "hr_atrous_fused": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _F, _F,
                        _I, _I, _I, _I, _P, _P, _P, _P],
    "hr_bilateral_blur": [_P, _P, _P, _P, _I, _I, _I, GaussTaps, _F, _F,
                          _P, _P],
    "hr_ddgi_sample": [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                       _F, _F, _I, _P, _P, _P, _I, _P, _P],
    "hr_flash_closest": [_P, _I, _P, _P, _P, _I, _F, _F, _I, _F, _I, _I, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P],
    "hr_flash_closest_blocks_per_sm": [_I],
    "hr_flash_visibility": [_P, _I, _P, _P, _P, _P, _I, _F, _F, _I, _F, _I, _I, _I, _P, _P,
                            _P, _P],
    "hr_flash_visibility_blocks_per_sm": [_I],
    "hr_shade_rays": [_P, _P, _I, _F, _F, _F, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P],
    "hr_shade_combine": [_P, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _F, _I, _P, _P],
    "hr_temporal_shadows": [_I, _I] + [_P] * 11 + [_F] * 4 + [_P] * 5,
    "hr_temporal_ao": [_I, _I] + [_P] * 10 + [_F] * 2 + [_P] * 3,
    "hr_temporal_reflections": [_I, _I] + [_P] * 16 + [_F] * 4 + [_P] * 5,
    "hr_noop": [_P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run_all(cmds, timeout=600):
    """Run the commands at once; returns their combined output. Raises if
    any fails, after every process has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH if it is missing or stale: one nvcc
    per source, all started together, then one link. Returns nvcc's output
    (with ``-Xptxas -v`` when verbose)."""
    srcs = _sources()
    if os.path.exists(LIB_PATH) and all(
            os.path.getmtime(s) <= os.path.getmtime(LIB_PATH) for s in srcs):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        compile_cmds, objs = [], []
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
            fmad = _FMAD.get(os.path.basename(src), "false")
            cmd = [nvcc, ARCH, "-std=c++17", "-O3", f"-fmad={fmad}", "-Xcompiler", "-fPIC",
                   "-c", src, "-o", obj]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            compile_cmds.append(cmd)
            objs.append(obj)
        log = _run_all(compile_cmds)
        lib_tmp = os.path.join(tmpdir, "lib.so")
        log += _run_all([[nvcc, ARCH, "-shared", "-o", lib_tmp] + objs])
        os.replace(lib_tmp, LIB_PATH)
    return log


def lib():
    """The loaded kernel library (building it first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def stream_ptr(device=None) -> int:
    """The current stream of `device` (of the current device when None)."""
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require(t: torch.Tensor, name: str, dtype, shape=None, device=None) -> None:
    """Validate a kernel operand: on the card, on the launch's `device`
    (the current device when None), of `dtype`, contiguous and (where
    given) of `shape`. An operand on another card is refused, not moved."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, but the kernel launches on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def on_cpu(t: torch.Tensor) -> bool:
    """True if `t` takes the plain path. The plain version serves CPU
    tensors only: a CUDA tensor goes to the kernel, any other device is
    refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel or plain path for device {t.device}")
    return False
