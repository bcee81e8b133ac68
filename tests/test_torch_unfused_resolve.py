"""The unfused frame resolved from its walks' packets
(``app.resolves_unfused``, ``app._resolved_unfused_frame``): the closest
attribute walk's channels stay in packets, the origins kernel
(``kernels/resolve.unfused_origins``, ``csrc/unfused_origins.cu``) writes
the in-kernel sampler's block straight from them, the sampler's counts
stay in packets, and the frame resolve kernel writes every output.

On the CPU, at 72x40 (3 x 2 tiles, two of them ragged), teapot 1200, leaf
8, for a cone at spp 8 with accumulation and a disk at spp 4:

- the frame (``render_frame_fn``, the plain versions on the CPU) equals,
  bit for bit and in every key, dtype, shape and key order, the sequence
  it replaces: ``gbuffer_production``, ``shadow_production``, then
  ``composite_lights``;
- the origins kernel's source, compiled with g++ against
  tests/cuda_cpu/cuda_runtime.h and launched through its own wrapper,
  equals its plain version bit for bit (both built without FMA
  contraction; the plain version takes IEEE square roots, as the card
  does);
- which frames resolve: a hard sun, two lights, a textured mesh, the
  raster G-buffer, a binary accel, the shade table (attrs=0) and the
  fused routes keep their code;
- the wrapper raises on a wrong device, dtype, shape or layout;
- no pattern of ``walk_roofline``, ``shadow_roofline`` or ``closest_ms``
  names the origins kernel, and a graph replay counts its launches.

The tests marked ``cuda`` need an NVIDIA card and skip elsewhere (run them
there with ``python -m pytest --noconftest -m cuda
tests/test_torch_unfused_resolve.py``): the origins kernel against its
plain version at 1920x1080, and the resolved frame against the sequence
it replaces, bit for bit.
"""

import ctypes
import dataclasses
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import tpurt_torch.app as app
import tpurt_torch.graphs as graphs
import tpurt_torch.kernels._build as kb
import tpurt_torch.kernels.resolve as rs
import tpurt_torch.kernels.traverse as tr
import tpurt_torch.native as native
from bench_torch import closestcount
from tpurt_torch.app import Renderer, frame_seed
from tpurt_torch.camera import generate_rays
from tpurt_torch.bvh.wide import order_children_for_point
from tpurt_torch.passes.composite import composite_lights
from tpurt_torch.scenes import default_camera_for, teapot_scene
from tpurt_torch.types import Light, RenderConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "tpurt_torch" / "kernels" / "csrc"
STUB = ROOT / "tests" / "cuda_cpu"
METRICS = ROOT / "bench_torch" / "metrics"
W, H = 72, 40
SEED = 2 ** 31 + 24_024
SUN = Light.directional((0.45, 0.8, 0.3))
SOFT_SUN = Light.sun((0.2, 0.5, -0.8), angular_radius_deg=4.0)
LAUNCH = re.compile(r"([\w:]+(?:<[^<>]*>)?)<<<([^,]+), ([^,]+), 0, st>>>"
                    r"\(([^;]*)\);")
NAMES = ["unfused_origins_kernel", "unfused_origins_kernel(OriginsParams)",
         "_Z22unfused_origins_kernel13OriginsParams"]


def _lamp(mesh, radius=0.15):
    c = 0.5 * sum(mesh.bounds())
    return Light.point(c + np.float32([0.3, 1.2, 0.4]), radius=radius,
                       intensity=2.0)


# case -> (lights, config fields)
CASES = {
    "cone_spp8": (lambda m: [SOFT_SUN], dict(spp=8, accumulate=True)),
    "disk_spp4": (lambda m: [_lamp(m)], dict(spp=4)),
}


@pytest.fixture(scope="module")
def mesh():
    """The teapot; the native library loaded first, so that the static
    accel is the host SBVH, as on the card."""
    native.load_library()
    return teapot_scene(1200)


def _renderer(mesh, case, device="cpu", width=W, height=H):
    lights, fields = CASES[case]
    cfg = RenderConfig(width=width, height=height, leaf_size=8, seed=SEED,
                       fused_shadow=False, **fields)
    r = Renderer(mesh, default_camera_for(mesh), lights(mesh), cfg,
                 device=device)
    assert r.route == "unfused" and r.config.gbuffer == "ray"
    return r


def _consts(r, frame: int = 3):
    cfg = r.config
    return r._block.write(r.camera, r.lights, cfg,
                          frame_seed(cfg.seed, frame))


def _replaced(r, consts):
    """The frame as the unfused productions and ``composite_lights`` make
    it: the sequence the resolved frame replaces."""
    cfg, lights = r.config, consts.lights
    gbuf, counts = app.gbuffer_production(r.accel, r.mesh, consts.camera,
                                          cfg, r.attr_tables)
    vis, c = app.shadow_production(r.accel, gbuf, lights[0], consts.seed, 0,
                                   cfg)
    return {"image": composite_lights(gbuf, [vis], lights, cfg,
                                      consts.background),
            "shadow": torch.stack([vis]), **gbuf,
            "walk_counts": counts + c}


def _closest(r, consts):
    """The closest attribute walk on the frame's rays, its outputs left in
    packets -> (launch, origins, dirs)."""
    cfg = r.config
    acc = order_children_for_point(r.accel, consts.camera.position)
    o, d = generate_rays(consts.camera, cfg.width, cfg.height, r.device)
    launch = tr._fused_launch(tr.CLOSEST, tr.closest_attrs_inputs(
        acc, o, d, r.attr_tables), r.attr_tables, False)
    return launch, o, d


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(a: dict, b: dict) -> None:
    """Same keys in the same order, and every output equal in dtype, shape
    and bits."""
    assert list(a) == list(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert torch.equal(_bits(a[k]), _bits(b[k])), \
            f"{k} differs on {int((_bits(a[k]) != _bits(b[k])).sum())}"


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("case", list(CASES))
def test_frame_equals_the_replaced_sequence(mesh, monkeypatch, case):
    r = _renderer(mesh, case)
    assert app.resolves_unfused(r.route, r.config, r.accel, r.attr_tables,
                                r.mesh, r.lights)
    consts = _consts(r)
    calls = []
    _spy(monkeypatch, app, "unfused_origins", calls)
    _spy(monkeypatch, app, "frame_resolve", calls)
    new = app.render_frame_fn(r.accel, r.mesh, r.camera, r.lights, r.config,
                              r.attr_tables, consts=consts)
    assert calls == ["unfused_origins", "frame_resolve"]
    old = _replaced(r, consts)
    _assert_same(new, old)
    valid = old["valid"]
    assert valid.any() and not valid.all()
    vis = new["shadow"][:, valid]
    assert (vis < 1).any() and (vis == 1).any()
    assert ((vis > 0) & (vis < 1)).any()


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_frames_take_the_plain_versions(mesh, monkeypatch, case):
    """On CPU tensors the frame runs the plain walks, the plain origins
    and the plain resolve, and records the unfused frame's stages."""
    picked = []

    def spy(device, kernel, plain):
        picked.append(kernel.__name__)
        return plain
    for module in (tr, rs):
        monkeypatch.setattr(module, "_pick", spy)
    r = _renderer(mesh, case)
    out = r.render_frame()
    sampler = "any_soft_cuda" if case == "cone_spp8" \
        else "any_point_soft_cuda"
    assert picked == ["closest_attrs_cuda", "unfused_origins_cuda", sampler,
                      "frame_resolve_cuda"]
    assert int(out["walk_counts"].abs().sum()) == 0


@pytest.mark.parametrize("case", list(CASES))
def test_sampler_takes_the_packed_block(mesh, case):
    """``trace_any_soft`` / ``trace_any_point_soft`` on the origins block
    (``packed=``) return the counts of the same origins passed as images,
    left in packets, and the same walk counters."""
    r = _renderer(mesh, case)
    consts = _consts(r)
    launch, o, d = _closest(r, consts)
    block = rs.unfused_origins_reference(launch, consts, r.mesh, o, d)
    origins = torch.stack([tr._unpack(block[:, c], launch.meta)
                           for c in range(3)], dim=-1)
    valid = tr._unpack(block[:, 3], launch.meta) > 0.0
    light, spp, seed = consts.lights[0], r.config.spp, consts.seed

    def sample(origins, valid, **kw):
        if case == "cone_spp8":
            return tr.trace_any_soft(r.accel, origins, valid,
                                     light.direction, app.cone_cos(light),
                                     spp, seed, **kw)
        return tr.trace_any_point_soft(r.accel, origins, valid,
                                       light.position, light.radius, spp,
                                       seed, **kw)
    want, want_counts = sample(origins, valid)
    got, got_counts = sample(None, None,
                             packed=(block, launch.p, launch.meta))
    assert got.shape == (launch.p, 8, 128) and got.dtype == torch.int32
    assert torch.equal(tr._unpack(got, launch.meta), want)
    assert torch.equal(got_counts, want_counts)
    assert ((want > 0) & (want < spp)).any()


# ---------------------------------------------------------------------------
# The kernel's source on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_library(tmp_path_factory):
    """csrc/unfused_origins.cu with its launch rewritten into cpu_launch,
    built into a shared library with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA source for the CPU")
    out = tmp_path_factory.mktemp("unfused_origins")
    src = (CSRC / "unfused_origins.cu").read_text()
    src, n = LAUNCH.subn(r"cpu_launch(\2, \3, [&] { \1(\4); });", src)
    assert n == 1
    path = out / "unfused_origins.cu"
    path.write_text(src)
    lib = out / "libunfused_origins_cpu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", f"-I{STUB}", "-x", "c++",
                    str(path), "-o", str(lib)], check=True,
                   capture_output=True)
    handle = ctypes.CDLL(str(lib))
    handle.tpurt_unfused_origins_launch.restype = ctypes.c_int
    handle.tpurt_unfused_origins_launch.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_void_p]
    assert handle.tpurt_origins_params_size() == \
        ctypes.sizeof(rs.OriginsParams)
    return handle


@pytest.fixture
def on_cpu(monkeypatch):
    """The kernel wrapper takes CPU tensors (its device check off)."""
    monkeypatch.setattr(rs, "_require_cuda", lambda dev: None)
    monkeypatch.setattr(rs, "_stream", lambda dev: None)


@pytest.fixture
def cpu_kernel(cpu_library, on_cpu, monkeypatch):
    """... and launches the CPU build; the plain version takes square roots
    rounded as IEEE 754 rounds them, as the card's and g++'s are (numpy's;
    PyTorch's CPU square root may be one ulp off)."""
    monkeypatch.setattr(kb, "load_library", lambda: cpu_library)
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_equals_plain(cpu_kernel, mesh, case):
    r = _renderer(mesh, case)
    consts = _consts(r)
    launch, o, d = _closest(r, consts)
    before = rs.unfused_origins_cuda.launches
    got = rs.unfused_origins_cuda(launch, consts, r.mesh, o, d)
    assert rs.unfused_origins_cuda.launches == before + 1
    want = rs.unfused_origins_reference(launch, consts, r.mesh, o, d)
    assert got.shape == want.shape == (6, 4, 8, 128)
    assert torch.equal(_bits(got), _bits(want))
    valid = want[:, 3]
    assert (valid == 1).any() and (valid == 0).any()
    # the ragged tiles' pixels outside the image are zeros
    tiles = want.reshape(6, 4, 32, 32)
    assert not tiles[2, :, :, 8:].any() and not tiles[3:, :, 8:].any()
    assert tiles[2, :3, :, :8].all() and tiles[3, :3, :8].all()


# ---------------------------------------------------------------------------
# Which frames resolve
# ---------------------------------------------------------------------------

def _textured(mesh):
    rng = np.random.default_rng(3)
    v = np.asarray(mesh.vertices)
    return dataclasses.replace(
        mesh, uv=np.stack([v[:, 0], v[:, 1]], axis=1).astype(np.float32),
        tex_atlas=rng.random((2, 8, 8, 3), dtype=np.float32),
        tri_tex=rng.integers(-1, 2, mesh.num_triangles).astype(np.int32))


@pytest.mark.parametrize("case", [
    "hard_sun", "two_lights", "textured", "raster", "binary", "attrs0",
    "fused"])
def test_other_frames_keep_the_tensor_code(mesh, monkeypatch, case):
    """These frames never call the origins kernel or its plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("the unfused frame resolved")
    monkeypatch.setattr(app, "unfused_origins", refuse)
    lights, m = [SOFT_SUN], mesh
    fields = dict(spp=4, fused_shadow=False)
    if case == "hard_sun":
        lights = [SUN]
    elif case == "two_lights":
        lights = [SOFT_SUN, SUN]
    elif case == "textured":
        m = _textured(mesh)
    elif case == "raster":
        fields["gbuffer"] = "raster"
    elif case == "binary":
        fields["bvh_width"] = 2
    elif case == "attrs0":
        fields["inkernel_attrs"] = False
    else:
        fields["fused_shadow"] = True
    r = Renderer(m, default_camera_for(mesh), lights,
                 RenderConfig(width=W, height=H, leaf_size=8, **fields),
                 device="cpu")
    assert not app.resolves_unfused(r.route, r.config, r.accel,
                                    r.attr_tables, r.mesh, r.lights)
    out = r.render_frame()
    assert out["valid"].any()


def test_resolves_unfused_follows_the_frames_input(mesh):
    """The unfused route with the ray-cast G-buffer, the 8-wide accel with
    its attribute rows, an untextured mesh and one light that an in-kernel
    sampler takes; nothing else decides."""
    r = _renderer(mesh, "cone_spp8")
    cfg, acc, at = r.config, r.accel, r.attr_tables

    def res(cfg=cfg, acc=acc, at=at, m=mesh, lights=(SOFT_SUN,)):
        route = app.frame_route(cfg, lights, acc)
        return app.resolves_unfused(route, cfg, acc, at, m, list(lights))
    assert res() and res(lights=[_lamp(mesh)])
    assert res(cfg=dataclasses.replace(cfg, gbuffer="auto"))
    assert not res(lights=[SUN])
    for light in (SOFT_SUN, _lamp(mesh)):
        assert not res(cfg=dataclasses.replace(cfg, spp=1), lights=[light])
    assert not res(lights=[SOFT_SUN, SUN])
    assert not res(m=_textured(mesh))
    assert not res(at=None)
    assert not res(cfg=dataclasses.replace(cfg, gbuffer="raster"))
    assert not res(cfg=dataclasses.replace(cfg, fused_shadow=True))
    binary = Renderer(mesh, r.camera, [SOFT_SUN], dataclasses.replace(
        cfg, bvh_width=2), device="cpu").accel
    assert tr.is_binary(binary) and not res(acc=binary)


# ---------------------------------------------------------------------------
# The wrapper's checks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cone_launch(mesh):
    r = _renderer(mesh, "cone_spp8")
    consts = _consts(r)
    return (r, consts, *_closest(r, consts))


def test_wrapper_refuses_cpu_tensors(cone_launch):
    r, consts, launch, o, d = cone_launch
    with pytest.raises(ValueError, match="need CUDA tensors"):
        rs.unfused_origins_cuda(launch, consts, r.mesh, o, d)


def _non_contiguous(t):
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


@pytest.mark.parametrize("fault,match", [
    ("attrs_dtype", "attrs has dtype"),
    ("attrs_shape", "attrs has shape"),
    ("rays_shape", "rays has shape"),
    ("rays_dtype", "rays has dtype"),
    ("attrs_layout", "attrs is not contiguous"),
    ("rays_layout", "rays is not contiguous"),
    ("bias_dtype", "bias has dtype"),
    ("packets", "packets for a"),
    ("padded", "attrs has shape"),
    ("flat", "image rays"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(on_cpu, cone_launch,
                                                       fault, match):
    r, consts, launch, o, d = cone_launch
    if fault == "attrs_dtype":
        launch = dataclasses.replace(launch, attrs=launch.attrs.double())
    elif fault == "attrs_shape":
        launch = dataclasses.replace(launch, attrs=launch.attrs[:, :14])
    elif fault == "rays_shape":
        launch = dataclasses.replace(launch, rays=launch.rays[:, :9])
    elif fault == "rays_dtype":
        launch = dataclasses.replace(launch, rays=launch.rays.double())
    elif fault == "attrs_layout":
        launch = dataclasses.replace(launch,
                                     attrs=_non_contiguous(launch.attrs))
    elif fault == "rays_layout":
        launch = dataclasses.replace(launch,
                                     rays=_non_contiguous(launch.rays))
    elif fault == "bias_dtype":
        consts = dataclasses.replace(consts, bias=consts.bias.double())
    elif fault == "packets":
        launch = dataclasses.replace(launch, p=launch.p + 1)
    elif fault == "padded":
        launch = dataclasses.replace(launch, attrs=torch.cat(
            [launch.attrs, launch.attrs[:1]]))
    else:
        launch = dataclasses.replace(launch, meta=("flat", W * H, 4096))
    with pytest.raises(ValueError, match=match):
        rs.unfused_origins_cuda(launch, consts, r.mesh, o, d)


# ---------------------------------------------------------------------------
# The benchmark's readers and the graphs
# ---------------------------------------------------------------------------

def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"unfused_resolve_test_{name}", METRICS / name / "read.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("reader", ["walk_roofline", "shadow_roofline",
                                    "closest_ms"])
def test_no_walk_pattern_names_the_kernel(reader):
    """The walk readers time the walks alone: their patterns miss the
    origins kernel under its source name and as the profiler names it."""
    if reader == "walk_roofline":
        pats = _reader(reader).patterns(str(METRICS / reader))
    elif reader == "shadow_roofline":
        pats = [_reader(reader).KERNELS]
    else:
        pats = [closestcount.KERNELS]
    assert pats
    assert not [n for n in NAMES for p in pats if p.search(n)]
    assert "unfused_origins_kernel" in \
        (CSRC / "unfused_origins.cu").read_text()


def test_a_replay_counts_the_kernels_launches():
    """The graphs count the origins kernel's launches like every other
    hand-written kernel's."""
    assert rs.unfused_origins_cuda in graphs._launch_counts()
    before = graphs._launch_counts()
    rs.unfused_origins_cuda.launches += 2
    moved = graphs._take_captured(before)
    assert moved == {rs.unfused_origins_cuda: 2}
    assert graphs._launch_counts() == before
    graphs._count_replay(moved)
    assert rs.unfused_origins_cuda.launches \
        == before[rs.unfused_origins_cuda] + 2
    rs.unfused_origins_cuda.launches -= 2


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card_at_1080p(card, mesh):
    r = _renderer(mesh, "cone_spp8", device=card, width=1920, height=1080)
    consts = _consts(r)
    launch, o, d = _closest(r, consts)
    got = rs.unfused_origins_cuda(launch, consts, r.mesh, o, d)
    want = rs.unfused_origins_reference(launch, consts, r.mesh, o, d)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (60 * 34, 4, 8, 128)
    assert torch.equal(_bits(got), _bits(want))
    assert want[:, 3].mean() > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_frame_equals_the_replaced_sequence_on_the_card(card, mesh, case):
    r = _renderer(mesh, case, device=card, width=1920, height=1080)
    consts = _consts(r)
    before = (rs.unfused_origins_cuda.launches,
              rs.frame_resolve_cuda.launches)
    new = app.render_frame_fn(r.accel, r.mesh, r.camera, r.lights, r.config,
                              r.attr_tables, consts=consts)
    assert (rs.unfused_origins_cuda.launches,
            rs.frame_resolve_cuda.launches) == (before[0] + 1, before[1] + 1)
    old = _replaced(r, consts)
    torch.cuda.synchronize()
    _assert_same(new, old)
