"""ctypes binding of the shared C++ host library (counterpart of
``tpurt/native.py``): the SAH/SBVH build and the OBJ parser.

The library source lives in ``native/`` and is shared with the JAX
package, not copied: ``native/Makefile`` builds ``native/libtpurt_native.so``
on first use, into a name of this process's own that is then renamed into
place, so that processes starting together never load a half-written
library. ``load_library`` raises when the build or the load fails;
``available`` says whether it succeeds, and the Renderer builds a static
scene on the device when it does not, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import os
import subprocess
from typing import List, Tuple

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


def _build(path: str) -> None:
    """``make`` the library into a temporary name beside ``path`` and
    rename it into place (an atomic replace), under an exclusive lock on
    the source directory so that concurrent first uses build it once.
    Raises with make's output on a failure."""
    fd = os.open(_NATIVE_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0 or not os.path.exists(tmp):
            raise RuntimeError(
                f"building {path} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        os.close(fd)


class _Library:
    """The loaded library, built on first use."""

    handle = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.handle is not None:
            return cls.handle
        if not os.path.exists(_LIB_PATH):
            _build(_LIB_PATH)
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
        vp = ctypes.c_void_p
        lib.obj_load.restype = vp
        lib.obj_load.argtypes = [ctypes.c_char_p]
        for name in ("obj_num_positions", "obj_num_normals",
                     "obj_num_texcoords", "obj_num_tris",
                     "obj_mtl_names_len", "obj_mtllibs_len"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [vp]
        for name, args in (("obj_copy_positions", [vp, c_float_p]),
                           ("obj_copy_normals", [vp, c_float_p]),
                           ("obj_copy_texcoords", [vp, c_float_p]),
                           ("obj_copy_tris", [vp, c_int_p, c_int_p]),
                           ("obj_copy_tri_tex", [vp, c_int_p]),
                           ("obj_copy_tri_mtl", [vp, c_int_p]),
                           ("obj_copy_mtl_names", [vp, ctypes.c_char_p]),
                           ("obj_copy_mtllibs", [vp, ctypes.c_char_p]),
                           ("obj_free", [vp])):
            getattr(lib, name).restype = None
            getattr(lib, name).argtypes = args
        cls.handle = lib
        return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library; raises on failure."""
    return _Library.get()


def available() -> bool:
    """Does the native library build and load? (``tpurt.native.available``;
    a failure is not remembered, so a later call tries again.)"""
    try:
        load_library()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


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


def load_obj_raw(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, List[str], List[str]]:
    """Native OBJ parse (``tpurt.native.load_obj_raw``) -> (positions
    f32[P, 3], normals f32[N, 3], texcoords f32[TC, 2], tri_pos i32[T, 3],
    tri_nrm i32[T, 3] (-1: no normal), tri_tex i32[T, 3] (-1: none),
    tri_mtl i32[T] material index (-1: none), material names, mtllib
    names). Raises FileNotFoundError for a file the parser cannot open,
    ValueError for one without faces, and as ``load_library`` does."""
    lib = load_library()
    h = lib.obj_load(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        npos, nn, ntc, nt = (lib.obj_num_positions(h), lib.obj_num_normals(h),
                             lib.obj_num_texcoords(h), lib.obj_num_tris(h))
        if nt == 0:
            raise ValueError(f"no faces found in OBJ file: {path}")
        pos = np.empty((npos, 3), np.float32)
        nrm = np.empty((max(nn, 1), 3), np.float32)
        tc = np.empty((max(ntc, 1), 2), np.float32)
        tp = np.empty((nt, 3), np.int32)
        tn = np.empty((nt, 3), np.int32)
        tt = np.empty((nt, 3), np.int32)
        tm = np.empty(nt, np.int32)
        if npos:
            lib.obj_copy_positions(h, _fp(pos))
        if nn:
            lib.obj_copy_normals(h, _fp(nrm))
        if ntc:
            lib.obj_copy_texcoords(h, _fp(tc))
        lib.obj_copy_tris(h, _ip(tp), _ip(tn))
        lib.obj_copy_tri_tex(h, _ip(tt))
        lib.obj_copy_tri_mtl(h, _ip(tm))

        def names(len_fn, copy_fn) -> List[str]:
            n = len_fn(h)
            if n == 0:
                return []
            buf = ctypes.create_string_buffer(int(n))
            copy_fn(h, buf)
            return buf.raw[:n].decode(errors="replace").split("\n")

        return (pos, nrm[:nn], tc[:ntc], tp, tn, tt, tm,
                names(lib.obj_mtl_names_len, lib.obj_copy_mtl_names),
                names(lib.obj_mtllibs_len, lib.obj_copy_mtllibs))
    finally:
        lib.obj_free(h)
