"""The CUDA sources of the fused and shadow-ray walk kernels
(tpurt_torch/kernels/csrc/fused_shadows.cu and shadow_rays.cu), compiled
with g++ against tests/cuda_cpu/cuda_runtime.h and run on the CPU through
their own ``*_cuda`` wrappers, against their plain versions.

The stand-in runs a block's threads as std::threads that meet at a barrier
for ``__syncthreads``, so the kernels' block structure runs as written:
the point-light penumbra modes (PSOFT attrs 0, 1, 2 and ANY_PSOFT), one
thread per (ray, sample) with a block's counts summed in shared memory,
are held at spp values that divide a warp and do not (3, 8, 33) and one
above a block's 128 rays (130), with the real and the zero stream, and
with a 4-entry stack and an iteration cap of 2, where pushes are dropped
and walks capped. The thread-per-ray modes of the same two files are the
control. Every output, the walk counters too, must equal the plain
version's bit for bit: both are built without FMA contraction and g++ on
x86-64 rounds division and sqrt as the card does. Teapot 2000, 64x64 rays
(32 blocks of 128), leaf 14.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import tpurt_torch.kernels._build as kb
import tpurt_torch.kernels.traverse as tr
from tpurt_torch.app import Renderer
from tpurt_torch.bvh.wide import order_children_for_point
from tpurt_torch.camera import generate_rays
from tpurt_torch.passes.gbuffer import gbuf_from_attr_channels
from tpurt_torch.scenes import default_camera_for, teapot_scene
from tpurt_torch.types import Light, RenderConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "tpurt_torch", "kernels", "csrc")
STUB = os.path.join(ROOT, "tests", "cuda_cpu")
RES = 64
SUN = (0.45, 0.8, 0.3)
FILL = (-0.5, 0.7, 0.2)
PENUMBRA = ["closest_point_soft_shadow", "closest_point_soft_shadow_st",
            "closest_point_soft_shadow_tex", "any_point_soft"]
LAUNCH = re.compile(r"([\w:]+(?:<[^<>]*>)?)<<<([^,]+), ([^,]+), 0, st>>>"
                    r"\(([^;]*)\);")


@pytest.fixture(scope="module")
def cpu_library(tmp_path_factory):
    """The two sources with every launch rewritten into cpu_launch, built
    into one shared library with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA sources for the CPU")
    out = tmp_path_factory.mktemp("csrc")
    shutil.copy(os.path.join(CSRC, "walk.cuh"), out)
    srcs = []
    for name in ("fused_shadows.cu", "shadow_rays.cu"):
        with open(os.path.join(CSRC, name)) as f:
            src = f.read()
        n = len(re.findall("<<<", src))
        src, m = LAUNCH.subn(r"cpu_launch(\2, \3, [&] { \1(\4); });", src)
        assert m == n > 0, f"{name}: rewrote {m} of {n} launches"
        path = out / name
        path.write_text(src)
        srcs += ["-x", "c++", str(path)]
    lib = out / "libwalks_cpu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", f"-I{STUB}", f"-I{out}",
                    *srcs, "-o", str(lib)], check=True, capture_output=True)
    handle = ctypes.CDLL(str(lib))
    for name in ("tpurt_fused_shadows_launch", "tpurt_shadow_rays_launch"):
        getattr(handle, name).restype = ctypes.c_int
        getattr(handle, name).argtypes = [ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p]
    assert handle.tpurt_params_size() == ctypes.sizeof(tr.Params)
    return handle


@pytest.fixture
def on_cpu(cpu_library, monkeypatch):
    """The ``*_cuda`` wrappers launch the CPU build on CPU tensors."""
    monkeypatch.setattr(kb, "load_library", lambda: cpu_library)
    monkeypatch.setattr(tr, "_require_cuda", lambda dev: None)
    monkeypatch.setattr(tr, "_stream", lambda dev: None)


@pytest.fixture(scope="module")
def scene():
    mesh = teapot_scene(2000)
    cam = default_camera_for(mesh)
    bmin, bmax = mesh.bounds()
    lpos = 0.5 * (bmin + bmax) + np.float32([2.0, 6.0, 1.0])
    r = Renderer(mesh, cam, Light.directional(SUN),
                 RenderConfig(width=RES, height=RES, leaf_size=14),
                 device="cpu")
    acc = order_children_for_point(r.accel, cam.position)
    o, d = generate_rays(cam, RES, RES, "cpu")
    args, kw, p, meta = tr.closest_attrs_inputs(acc, o, d, r.attr_tables)
    gbuf = gbuf_from_attr_channels(
        tr._attr_channels(tr.closest_attrs_reference(*args, **kw)[0], p,
                          meta), o, d, cam, mesh)
    origins = gbuf["position"] + gbuf["gnormal"] * 1e-3
    return dict(r=r, acc=acc, o=o, d=d, lpos=lpos, gbuf=gbuf,
                origins=origins)


def _inputs(sc, name, **spec):
    """(args, kwargs) of kernel ``name`` on the scene's rays."""
    r, acc, o, d = sc["r"], sc["acc"], sc["o"], sc["d"]
    if name in ("any_point_soft", "any_soft"):
        g = sc["gbuf"]
        if name == "any_soft":
            return tr.any_soft_inputs(r.accel, sc["origins"], g["valid"],
                                      SUN, 0.997, seed=11, light=1,
                                      **spec)[:2]
        return tr.any_point_soft_inputs(r.accel, sc["origins"], g["valid"],
                                        sc["lpos"], 0.4, seed=11, light=1,
                                        **spec)[:2]
    if name == "any":
        from tpurt_torch.passes.shadow import shadow_ray_batch
        rays = shadow_ray_batch(sc["gbuf"], Light.point(sc["lpos"]), 1e-3,
                                None, (r.accel.root_min, r.accel.root_max))
        return tr.any_inputs(r.accel, *rays)[:2]
    if name == "closest":
        return tr.closest_inputs(acc, o, d)[:2]
    if name == "closest_attrs":
        return tr.closest_attrs_inputs(acc, o, d, r.attr_tables)[:2]
    tables = None if name.endswith("_st") else r.attr_tables
    stem = re.sub(r"_(st|tex)$", "", name)
    return getattr(tr, f"{stem}_inputs")(acc, o, d, bias=1e-3,
                                         attr_tables=tables, **spec)[:2]


def _point_soft(sc, name, **spec):
    if name == "any_point_soft":
        return _inputs(sc, name, **spec)
    return _inputs(sc, name, light_pos=sc["lpos"], radius=0.4, seed=11,
                   **spec)


def _run(name, args, kw):
    """The CPU build and the plain version on the same inputs, every output
    equal -> the kernel's outputs."""
    kfn, pfn = getattr(tr, f"{name}_cuda"), getattr(tr, f"{name}_reference")
    before = kfn.launches
    kres = kfn(*args, **kw)
    assert kfn.launches == before + 1
    kfn.launches = before
    pres = pfn(*args, **kw)
    assert len(kres) == len(pres)
    for i, (a, b) in enumerate(zip(kres, pres)):
        assert torch.equal(a, b), f"{name}: output {i} differs on " \
                                  f"{int((a != b).sum())} elements"
    return kres


@pytest.mark.parametrize("zero", [False, True], ids=["real", "zero"])
@pytest.mark.parametrize("spp", [3, 8, 33, 130])
@pytest.mark.parametrize("name", PENUMBRA)
def test_penumbra_kernel_source_equals_plain(on_cpu, scene, name, spp,
                                             zero):
    res = _run(name, *_point_soft(scene, name, spp=spp, zero_stream=zero))
    cnt = res[-2]
    assert res[-1].tolist() == [0, 0]
    assert int(cnt.max()) <= spp
    if zero:
        assert bool(((cnt == 0) | (cnt == spp)).all())
    else:
        assert bool(((cnt > 0) & (cnt < spp)).any())


@pytest.mark.parametrize("name", PENUMBRA)
def test_penumbra_kernel_source_counts_dropped_pushes(on_cpu, scene, name):
    """A 4-entry stack and an iteration cap of 2: the kernel drops and caps
    exactly the plain version's pushes and walks."""
    args, kw = _point_soft(scene, name, spp=8, zero_stream=False,
                           stack_size=4)
    overflow, capped = _run(name, args, dict(kw, max_iters=2))[-1].tolist()
    assert overflow > 0 and capped > 0


CONTROLS = {
    "closest_shadow": dict(light_dir=SUN),
    "closest_multi_shadow": dict(lights=[(SUN, None), (FILL, None)]),
    "closest_soft_shadow": dict(axis_dir=SUN, cone_cos=0.997, spp=4,
                                seed=11),
    "closest_soft_multi_shadow_st": dict(light0=("cone", SUN, 0.997),
                                         extra_dirs=[FILL], spp=4, seed=11),
    "closest_attrs": {},
    "closest": {},
    "any": {},
    "any_soft": dict(spp=4),
}


@pytest.mark.parametrize("name", list(CONTROLS))
def test_thread_per_ray_kernel_source_equals_plain(on_cpu, scene, name):
    _run(name, *_inputs(scene, name, **CONTROLS[name]))
