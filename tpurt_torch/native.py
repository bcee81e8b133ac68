"""ctypes binding of the shared C++ host library (counterpart of
``tpurt/native.py``, SAH/SBVH build only).

The library source lives in ``native/`` and is shared with the JAX
package, not copied: ``native/Makefile`` builds ``native/libtpurt_native.so``
on first use. Unlike the JAX package, which falls back to its on-device
Morton build when the library is missing, the port raises: that fallback
needs build kernels the port does not have yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtpurt_native.so")


@dataclasses.dataclass
class CpuBVH:
    """Depth-first BVH with skip links, as the native builder returns it
    (the layout of ``tpurt.bvh.reference.CpuBVH``).

    bb_min, bb_max : f32[num_nodes, 3]
    prim_start     : i32[num_nodes] first reference of a leaf
    prim_count     : i32[num_nodes] references in a leaf (0 = interior)
    skip           : i32[num_nodes] next node when the subtree is done
    tri_order      : i32[R] triangle id of each reference (SBVH duplicates)
    """

    bb_min: np.ndarray
    bb_max: np.ndarray
    prim_start: np.ndarray
    prim_count: np.ndarray
    skip: np.ndarray
    tri_order: np.ndarray


class _Library:
    """The loaded library, built with ``make`` on first use."""

    handle = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.handle is not None:
            return cls.handle
        if not os.path.exists(_LIB_PATH):
            proc = subprocess.run(["make", "-C", _NATIVE_DIR],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0 or not os.path.exists(_LIB_PATH):
                raise RuntimeError(
                    f"building {_LIB_PATH} failed:\n{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(_LIB_PATH)
        c_float_p = ctypes.POINTER(ctypes.c_float)
        c_int_p = ctypes.POINTER(ctypes.c_int32)
        lib.bvh_build_sbvh.restype = ctypes.c_void_p
        lib.bvh_build_sbvh.argtypes = [c_float_p, ctypes.c_int64, c_int_p,
                                       ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_float, ctypes.c_float]
        lib.bvh_num_nodes.restype = ctypes.c_int64
        lib.bvh_num_nodes.argtypes = [ctypes.c_void_p]
        lib.bvh_num_refs.restype = ctypes.c_int64
        lib.bvh_num_refs.argtypes = [ctypes.c_void_p]
        lib.bvh_copy.restype = None
        lib.bvh_copy.argtypes = [ctypes.c_void_p, c_float_p, c_float_p,
                                 c_int_p, c_int_p, c_int_p, c_int_p]
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = [ctypes.c_void_p]
        cls.handle = lib
        return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library; raises on failure."""
    return _Library.get()


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_sah_bvh(vertices: np.ndarray, indices: np.ndarray,
                  leaf_size: int, spatial_alpha: float,
                  spatial_budget: float) -> CpuBVH:
    """Native binned-SAH build with SBVH spatial splits -> CpuBVH: a node
    whose best object split overlaps by more than ``spatial_alpha`` x the
    root area also tries spatial splits, which duplicate straddling
    references up to ``spatial_budget * num_tris`` (the semantics of
    ``tpurt.native.build_sah_bvh``)."""
    lib = load_library()
    v = np.ascontiguousarray(vertices, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    h = lib.bvh_build_sbvh(_fp(v), v.shape[0], _ip(idx), idx.shape[0],
                           leaf_size, ctypes.c_float(spatial_alpha),
                           ctypes.c_float(spatial_budget))
    if not h:
        raise RuntimeError("native BVH build returned no tree")
    try:
        n = lib.bvh_num_nodes(h)
        nrefs = lib.bvh_num_refs(h)
        bb_min = np.empty((n, 3), np.float32)
        bb_max = np.empty((n, 3), np.float32)
        prim_start = np.empty(n, np.int32)
        prim_count = np.empty(n, np.int32)
        skip = np.empty(n, np.int32)
        order = np.empty(nrefs, np.int32)
        lib.bvh_copy(h, _fp(bb_min), _fp(bb_max), _ip(prim_start),
                     _ip(prim_count), _ip(skip), _ip(order))
        return CpuBVH(bb_min=bb_min, bb_max=bb_max, prim_start=prim_start,
                      prim_count=prim_count, skip=skip, tri_order=order)
    finally:
        lib.bvh_free(h)
