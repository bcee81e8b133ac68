"""Build and load the port's CUDA kernel library.

One ``nvcc`` call compiles every ``csrc/*.cu`` (which include
``csrc/walk.cuh``) into one shared library with a plain C interface, bound
with ctypes. The build runs at first use, never at import, into
``build/tpurt_torch/`` at the repository root, and is keyed by a hash of
the sources, the headers and the flags, so an edited source rebuilds.
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
    """Compile and link every source in one nvcc call; raises with the
    compiler's output on a failure."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    srcs = [p for p in _inputs() if p.endswith(".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *srcs],
                          capture_output=True, text=True, timeout=600)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = proc.stdout + proc.stderr
    if proc.returncode != 0:
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
    lib.tpurt_fused_shadows_launch.restype = i
    lib.tpurt_fused_shadows_launch.argtypes = [i, ctypes.c_void_p,
                                               ctypes.c_void_p]
    for name in ("tpurt_stack_capacity", "tpurt_params_size"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = []
    from .traverse import STACK_CAPACITY, Params
    if lib.tpurt_stack_capacity() != STACK_CAPACITY:
        raise RuntimeError("kernel STACK_CAPACITY differs from "
                           "traverse.STACK_CAPACITY")
    if lib.tpurt_params_size() != ctypes.sizeof(Params):
        raise RuntimeError("the kernel's Params struct differs from "
                           "traverse.Params")
    _Library.handle = lib
    return lib
