"""ctypes binding to the repository's native binned-SAH BVH builder.

The source is the JAX package's own native/bvh_builder.cpp, compiled with
the same g++ flags, so both packages build bit-identical trees and packed
tables. The library goes into the port's build directory (utils/build.py),
never into native/. If g++ fails, build_bvh_native raises: another builder
would give another tree, and with it other packed triangle ids.
build_bvh_auto falls back to accel/bvh.build_bvh only where the JAX
package's does: under TB_BVH=python, or when the library does not build
or load (native_available).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tracerboy_tpu_torch.accel.bvh import WideBVH
from tracerboy_tpu_torch.utils.build import (
    REPO_ROOT,
    build_shared_library,
)

_SRC = REPO_ROOT / "native" / "bvh_builder.cpp"
_FLAGS = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_shared_library("tbbvh", [_SRC],
                                                   _FLAGS)))
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.tb_bvh_build.restype = ctypes.c_void_p
        lib.tb_bvh_build.argtypes = [fp, ctypes.c_int32, ctypes.c_int32]
        lib.tb_bvh_num_wide.restype = ctypes.c_int32
        lib.tb_bvh_num_wide.argtypes = [ctypes.c_void_p]
        lib.tb_bvh_num_clusters.restype = ctypes.c_int32
        lib.tb_bvh_num_clusters.argtypes = [ctypes.c_void_p]
        lib.tb_bvh_copy.restype = None
        lib.tb_bvh_copy.argtypes = [ctypes.c_void_p, fp, fp, ip, ip]
        lib.tb_bvh_free.restype = None
        lib.tb_bvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def build_bvh_native(v0, v1, v2, leaf_size: int = 4) -> WideBVH:
    """Binned-SAH 8-wide BVH via the native builder.

    tri_order may repeat indices (clusters pad short SAH leaves with
    their last triangle): treat it as a gather map, not a permutation.
    """
    lib = _load()
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    tris = np.ascontiguousarray(
        np.concatenate([v0[:, None, :], v1[:, None, :], v2[:, None, :]],
                       axis=1).astype(np.float32).reshape(T, 9)
    )
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    h = lib.tb_bvh_build(tris.ctypes.data_as(fp), T, leaf_size)
    try:
        W = lib.tb_bvh_num_wide(h)
        C = lib.tb_bvh_num_clusters(h)
        lo = np.empty((W, 8, 3), np.float32)
        hi = np.empty((W, 8, 3), np.float32)
        children = np.empty((W, 8), np.int32)
        order = np.empty((C * leaf_size,), np.int32)
        lib.tb_bvh_copy(h, lo.ctypes.data_as(fp), hi.ctypes.data_as(fp),
                        children.ctypes.data_as(ip),
                        order.ctypes.data_as(ip))
    finally:
        lib.tb_bvh_free(h)

    return WideBVH(
        bounds_lo=lo, bounds_hi=hi, children=children,
        tri_order=order.astype(np.int64), leaf_size=leaf_size,
        num_tris=T,
        world_lo=np.minimum(np.minimum(v0, v1), v2).min(axis=0),
        world_hi=np.maximum(np.maximum(v0, v1), v2).max(axis=0),
        num_clusters=C,
    )


def native_available() -> bool:
    """Whether the native builder builds and loads here."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def build_bvh_auto(v0, v1, v2, leaf_size: int = 4) -> WideBVH:
    """The native SAH builder where it is available, else (or under
    TB_BVH=python) accel/bvh.build_bvh's LBVH, as the JAX package's
    build_bvh_auto chooses."""
    if os.environ.get("TB_BVH") != "python" and native_available():
        return build_bvh_native(v0, v1, v2, leaf_size)
    from tracerboy_tpu_torch.accel.bvh import build_bvh

    return build_bvh(v0, v1, v2, leaf_size)
