"""Build and load the port's CUDA kernel library, and the checks every
kernel wrapper makes at the launch boundary.

Every ``csrc/*.cu`` (the walk kernels include ``csrc/walk.cuh``; the
build kernels of ``csrc/build.cu`` and the rasterizer of ``csrc/raster.cu``
stand alone) is compiled by its own
``nvcc``, all started together, and one more ``nvcc`` links the objects
into one shared library with a plain C interface, bound with ctypes. The
build runs at first use, never at import, into ``build/tpurt_torch/`` at
the repository root, and is keyed by a hash of the sources, the headers
and the flags, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                          "build", "tpurt_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _check(t, name: str, dtype, shape, device) -> None:
    """Raise unless tensor ``t`` has the device, dtype and shape a kernel
    takes and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _pick(device, cuda_fn, plain_fn):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if device.type == "cuda":
        return cuda_fn
    if device.type == "cpu":
        return plain_fn
    raise ValueError(f"unsupported device {device}")


def _inputs():
    """Every source and header under csrc/, in a fixed order."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return path


class BuildInfo:
    """What the last build in this process did (the smoke prints it)."""

    seconds = 0.0
    log = ""
    path = ""


class _Library:
    handle = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(_BUILD_DIR,
                        f"libtpurt_kernels-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile every source with its own nvcc, all at once, then link them
    into one library; raises with the compiler's output on a failure."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    srcs = [p for p in _inputs() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, o in zip(srcs, objs)]
    logs = [proc.communicate(timeout=600)[0] for proc in procs]
    failed = any(proc.returncode != 0 for proc in procs)
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True,
                              timeout=600)
        logs.append(link.stdout + link.stderr)
        failed = link.returncode != 0
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{BuildInfo.log}")
    os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
    """Build the library if its hash is new, load it, declare the C
    signatures; raises on a failed build."""
    if _Library.handle is not None:
        return _Library.handle
    path = library_path()
    if not os.path.exists(path):
        _build(path)
    BuildInfo.path = path
    lib = ctypes.CDLL(path)
    i = ctypes.c_int
    for name in ("tpurt_fused_shadows_launch", "tpurt_shadow_rays_launch"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [i, ctypes.c_void_p, ctypes.c_void_p]
    for name in ("tpurt_stack_capacity", "tpurt_params_size"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = []
    p, f = ctypes.c_void_p, ctypes.c_float
    for name, args in (
            ("tpurt_morton_codes_launch", [p, i, p, p]),
            ("tpurt_topology_launch", [p, i, i, p, p, p, p, p, p, p]),
            ("tpurt_collapse_area_launch", [p, p, i, i, p, p, p, p]),
            ("tpurt_raster_rows_launch", [p, i, p, p, p, i, p, i, i, i, i,
                                          f, f, f, f, p, p, p])):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = args
    from .traverse import STACK_CAPACITY, Params
    if lib.tpurt_stack_capacity() != STACK_CAPACITY:
        raise RuntimeError("kernel STACK_CAPACITY differs from "
                           "traverse.STACK_CAPACITY")
    if lib.tpurt_params_size() != ctypes.sizeof(Params):
        raise RuntimeError("the kernel's Params struct differs from "
                           "traverse.Params")
    _Library.handle = lib
    return lib
