"""Build and load the port's CUDA kernel library.

``nvcc`` compiles ``csrc/closest_shadow.cu`` into a shared library with a
plain C interface, bound with ctypes. The build runs at first use, never at
import, into ``build/tpurt_torch/`` at the repository root, and is keyed by
a hash of the source and the flags, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "closest_shadow.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                          "build", "tpurt_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]


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
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libclosest_shadow-{digest.hexdigest()[:16]}.so")


def load_library() -> ctypes.CDLL:
    """Build the library if its hash is new, load it, declare the C
    signatures; raises on a failed build."""
    if _Library.handle is not None:
        return _Library.handle
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=600)
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{BuildInfo.log}")
        os.replace(tmp, path)
    BuildInfo.path = path
    lib = ctypes.CDLL(path)
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.tpurt_closest_shadow_launch.restype = i
    lib.tpurt_closest_shadow_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, ctypes.c_float, i, i, p]
    lib.tpurt_stack_capacity.restype = i
    lib.tpurt_stack_capacity.argtypes = []
    from .traverse import STACK_CAPACITY
    if lib.tpurt_stack_capacity() != STACK_CAPACITY:
        raise RuntimeError("kernel STACK_CAPACITY differs from "
                           "traverse.STACK_CAPACITY")
    _Library.handle = lib
    return lib
