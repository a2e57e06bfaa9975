"""ctypes binding of the native toolkit (``native/hr_native.cpp``, shared
with the JAX package): the binned-SAH BVH builder and the OBJ parser.

g++ compiles the source at first use into the port's own ignored build
directory; if that fails the callers fall back to Python, in the same
order as the JAX package: the Morton builder (ops/bvh.py ``build_bvh``) for
the BVH, ``scene/loader._load_obj_python`` for OBJ files.
``builder_name()`` and ``obj_parser_name()`` say which one runs.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "hr_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "hybrid_rendering_torch", "build")
_LIB = os.path.join(BUILD_DIR, "libhr_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name and rename: parallel test workers may race
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=240)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = (not os.path.exists(_LIB)
                 or os.path.getmtime(_SRC) > os.path.getmtime(_LIB))
        if stale and not _compile():
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.hr_build_bvh.restype = ctypes.c_int32
        lib.hr_build_bvh.argtypes = [fp, ctypes.c_int32, ctypes.c_int32,
                                     fp, fp, ip, ip]
        lib.hr_load_obj.restype = ctypes.c_void_p
        lib.hr_load_obj.argtypes = [ctypes.c_char_p]
        lib.hr_obj_counts.restype = None
        lib.hr_obj_counts.argtypes = [ctypes.c_void_p, ip, ip]
        lib.hr_obj_copy.restype = None
        lib.hr_obj_copy.argtypes = [ctypes.c_void_p, fp, fp, fp, ip]
        lib.hr_obj_free.restype = None
        lib.hr_obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def builder_name() -> str:
    """The BVH builder that scene builds in this process use."""
    return ("native binned-SAH (native/hr_native.cpp)" if get_lib() is not None
            else "python Morton median split (ops/bvh.py)")


def obj_parser_name() -> str:
    """The OBJ parser that ``scene/loader.load_obj`` uses in this process."""
    return ("native (native/hr_native.cpp)" if get_lib() is not None
            else "python (scene/loader.py)")


def build_bvh_native(tri_pos: np.ndarray, leaf_size: int = 4):
    """Binned-SAH build. Returns (nodes_min, nodes_max, nodes_meta, order)
    in the ops/bvh.py layout, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tri_pos, np.float32).reshape(-1, 9)
    T = tris.shape[0]
    out_min = np.empty((2 * T, 3), np.float32)
    out_max = np.empty((2 * T, 3), np.float32)
    out_meta = np.empty((2 * T, 3), np.int32)
    out_order = np.empty(T, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n = lib.hr_build_bvh(
        tris.ctypes.data_as(fp), T, leaf_size,
        out_min.ctypes.data_as(fp), out_max.ctypes.data_as(fp),
        out_meta.ctypes.data_as(ip), out_order.ctypes.data_as(ip),
    )
    if n <= 0:
        return None
    return out_min[:n], out_max[:n], out_meta[:n], out_order


def load_obj_native(path: str):
    """Parse an OBJ file with the native parser. Returns (positions (V,3),
    normals (V,3), uvs (V,2), indices (F,3)) as numpy arrays, or None when
    the library is unavailable or the file has no vertex or face."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.hr_load_obj(os.fsencode(path))
    if not handle:
        return None
    try:
        nv, nf = ctypes.c_int32(), ctypes.c_int32()
        lib.hr_obj_counts(handle, ctypes.byref(nv), ctypes.byref(nf))
        V, F = nv.value, nf.value
        if V == 0 or F == 0:
            return None
        pos = np.empty((V, 3), np.float32)
        nrm = np.empty((V, 3), np.float32)
        uv = np.empty((V, 2), np.float32)
        idx = np.empty((F, 3), np.int32)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.hr_obj_copy(handle, pos.ctypes.data_as(fp), nrm.ctypes.data_as(fp),
                        uv.ctypes.data_as(fp), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return pos, nrm, uv, idx
    finally:
        lib.hr_obj_free(handle)
