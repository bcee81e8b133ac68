"""The frame resolve (``tpurt_torch/kernels/resolve.py``,
``csrc/resolve.cu``): every output of a fused frame from the fused walk
launch's packets in one step.

On the CPU, at 72x40 (3 x 2 tiles, two of them ragged), teapot 1200, leaf
8, on every fused route the resolve takes (fused0 hard with a directional
and with a point light, fused0 soft at spp 8, fused0 disk-sampled, fusedN
with three lights, one a point, fusedSM with a cone and with a disk at spp
3):

- the frame's outputs (``frame_resolve_reference`` on the CPU) equal, bit
  for bit and in every key, dtype and shape, the sequence it replaces: the
  fused production's decode and visibility, then ``composite_lights``;
- the kernel's source, compiled with g++ against
  tests/cuda_cpu/cuda_runtime.h and launched through its own wrapper,
  equals the plain version bit for bit (both built without FMA
  contraction; on the CPU the kernel divides and clamps as PyTorch does
  there, ``host_div`` and ``clamp_min`` of the source, and the plain
  version takes IEEE square roots, as the card does);
- which frames resolve: attrs 0 and 2, fused0 with lights for the unfused
  pass, the unfused route and the raster G-buffer keep the tensor code,
  and CPU tensors take the plain version;
- the wrapper raises on a wrong device, dtype, shape or layout;
- no walk kernel pattern of ``walk_roofline`` names the kernel, and
  ``resolve_frame_share`` reads the program's counter.

The tests marked ``cuda`` need an NVIDIA card and skip elsewhere (run them
there with ``python -m pytest --noconftest -m cuda
tests/test_torch_resolve.py``, without the JAX set-up of conftest.py): the
kernel against its plain version on the card, bit for bit, on every route
above and on a 3840x2160 three-light frame; a captured static frame that
replays the kernel; the counter on graph and on eager rebuild frames.
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
from torch.profiler import ProfilerActivity, profile

import tpurt_torch.app as app
import tpurt_torch.kernels._build as kb
import tpurt_torch.kernels.resolve as rs
import tpurt_torch.native as native
from tpurt_torch.app import Renderer, frame_seed
from tpurt_torch.bvh.wide import order_children_for_point
from tpurt_torch.camera import generate_rays
from tpurt_torch.passes.composite import composite_lights
from tpurt_torch.scenes import default_camera_for, deform, teapot_scene
from tpurt_torch.types import Light, RenderConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "tpurt_torch" / "kernels" / "csrc"
STUB = ROOT / "tests" / "cuda_cpu"
METRICS = ROOT / "bench_torch" / "metrics"
W, H = 72, 40
SEED = 2 ** 31 + 4099
SUN = Light.directional((0.45, 0.8, 0.3))
SOFT_SUN = Light.sun((0.2, 0.5, -0.8), angular_radius_deg=4.0)
FILL = Light.directional((-0.5, 0.7, 0.2), color=(1.0, 0.8, 0.6),
                         intensity=0.5)
LAUNCH = re.compile(r"([\w:]+(?:<[^<>]*>)?)<<<([^,]+), ([^,]+), 0, st>>>"
                    r"\(([^;]*)\);")


def _lamp(mesh, radius, intensity=2.0):
    c = 0.5 * sum(mesh.bounds())
    return Light.point(c + np.float32([0.3, 1.2, 0.4]), radius=radius,
                       intensity=intensity)


# route name -> (lights, config fields, the Renderer's route, shadow kind)
ROUTES = {
    "hard_sun": (lambda m: [SUN], {}, "fused0", rs.OCCLUDED),
    "hard_point": (lambda m: [_lamp(m, 0.0)], {}, "fused0", rs.OCCLUDED),
    "soft_spp8": (lambda m: [SOFT_SUN], dict(spp=8, accumulate=True),
                  "fused0", rs.COUNTS),
    "disk_spp4": (lambda m: [_lamp(m, 0.15)], dict(spp=4), "fused0",
                  rs.COUNTS),
    "multi3": (lambda m: [SUN, FILL, _lamp(m, 0.0, 0.8)], {}, "fusedN",
               rs.MASK),
    "cone_fill_spp3": (lambda m: [SOFT_SUN, FILL], dict(spp=3), "fusedSM",
                       rs.COUNTS_MASK),
    "disk_fill_spp3": (lambda m: [_lamp(m, 0.15), FILL], dict(spp=3),
                       "fusedSM", rs.COUNTS_MASK),
}


@pytest.fixture(scope="module")
def mesh():
    """The teapot; the native library loaded first, so that the static
    accel is the host SBVH and "auto" resolves to the ray cast on the
    card too."""
    native.load_library()
    return teapot_scene(1200)


def _renderer(mesh, route, device="cpu", width=W, height=H, mode="static",
              **more):
    lights, fields, want, _ = ROUTES[route]
    cfg = RenderConfig(width=width, height=height, leaf_size=8, seed=SEED,
                       **{**fields, **more})
    r = Renderer(mesh, default_camera_for(mesh), lights(mesh), cfg,
                 mode=mode, device=device)
    assert r.route == want
    return r


def _consts(r, frame: int = 3):
    cfg = r.config
    return r._block.write(r.camera, r.lights, cfg,
                          frame_seed(cfg.seed, frame))


def _launch(r, consts):
    """The route's fused launch on the frame's rays, its outputs left in
    packets -> (launch, shadow kind, origins, dirs)."""
    cfg = r.config
    acc = order_children_for_point(r.accel, consts.camera.position)
    launch, kind = app.fused_launch(r.route, acc, consts.lights, cfg,
                                    consts.seed, consts.bias, r.attr_tables,
                                    False)
    o, d = generate_rays(consts.camera, cfg.width, cfg.height, r.device)
    return launch(o, d), kind, o, d


def _replaced(r, consts):
    """The frame as the fused production and ``composite_lights`` make it,
    the decode, the visibility and the composite apart: the sequence the
    resolve replaces."""
    cfg, lights = r.config, consts.lights
    gbuf, shadows, counts = app.gbuffer_fused_production(
        r.route, r.accel, r.mesh, consts.camera, cfg, lights, r.attr_tables,
        consts.seed, bias=consts.bias)
    return {"image": composite_lights(gbuf, shadows, lights, cfg,
                                      consts.background),
            "shadow": torch.stack(shadows), **gbuf, "walk_counts": counts}


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


@pytest.mark.parametrize("route", list(ROUTES))
def test_reference_equals_the_replaced_sequence(mesh, route):
    r = _renderer(mesh, route)
    consts = _consts(r)
    new = app.render_frame_fn(r.accel, r.mesh, r.camera, r.lights, r.config,
                              r.attr_tables, consts=consts)
    old = _replaced(r, consts)
    _assert_same(new, old)
    valid = old["valid"]
    assert valid.any() and not valid.all()
    assert new["shadow"].shape == (len(r.lights), H, W)
    vis = new["shadow"][:, valid]
    assert (vis < 1).any() and (vis == 1).any()


# ---------------------------------------------------------------------------
# The kernel's source on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_library(tmp_path_factory):
    """csrc/resolve.cu with its launch rewritten into cpu_launch, built
    into a shared library with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA source for the CPU")
    out = tmp_path_factory.mktemp("resolve")
    src = (CSRC / "resolve.cu").read_text()
    src, n = LAUNCH.subn(r"cpu_launch(\2, \3, [&] { \1(\4); });", src)
    assert n == 1
    path = out / "resolve.cu"
    path.write_text(src)
    lib = out / "libresolve_cpu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", f"-I{STUB}", "-x", "c++",
                    str(path), "-o", str(lib)], check=True,
                   capture_output=True)
    handle = ctypes.CDLL(str(lib))
    handle.tpurt_frame_resolve_launch.restype = ctypes.c_int
    handle.tpurt_frame_resolve_launch.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_void_p]
    assert handle.tpurt_resolve_params_size() == \
        ctypes.sizeof(rs.ResolveParams)
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


@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_source_equals_plain(cpu_kernel, mesh, route):
    r = _renderer(mesh, route)
    consts = _consts(r)
    launch, kind, o, d = _launch(r, consts)
    assert kind == ROUTES[route][3]
    before = rs.frame_resolve_cuda.launches
    got = rs.frame_resolve_cuda(launch, kind, consts, r.config, r.mesh, o, d)
    assert rs.frame_resolve_cuda.launches == before + 1
    want = rs.frame_resolve_reference(launch, kind, consts, r.config,
                                      r.mesh, o, d)
    _assert_same(got, want)
    assert got["view_dir"] is d


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
    "attrs0", "attrs2", "fused0_extra_light", "unfused", "raster"])
def test_other_frames_keep_the_tensor_code(mesh, monkeypatch, case):
    """These frames never call the resolve."""
    def refuse(*args, **kwargs):
        raise AssertionError("the frame resolved")
    monkeypatch.setattr(app, "frame_resolve", refuse)
    lights, fields = [SUN], {}
    m = mesh
    if case == "attrs0":
        fields = dict(inkernel_attrs=False)
    elif case == "attrs2":
        m = _textured(mesh)
    elif case == "fused0_extra_light":
        lights = [SOFT_SUN, _lamp(mesh, 0.15)]
        fields = dict(spp=2)
    elif case == "unfused":
        fields = dict(fused_shadow=False)
    else:
        fields = dict(gbuffer="raster")
    r = Renderer(m, default_camera_for(mesh), lights,
                 RenderConfig(width=W, height=H, leaf_size=8, **fields),
                 device="cpu")
    assert m.textured == (case == "attrs2")
    assert not app.resolves(r.route, r.attr_tables, r.mesh, len(lights))
    out = r.render_frame()
    assert out["valid"].any()


@pytest.mark.parametrize("route", ["hard_sun", "multi3", "cone_fill_spp3"])
def test_cpu_frames_take_the_plain_version(mesh, monkeypatch, route):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel launched on CPU tensors")
    monkeypatch.setattr(rs, "frame_resolve_cuda", refuse)
    calls = []
    real = rs.frame_resolve_reference

    def spy(*args):
        calls.append(args[1])
        return real(*args)
    monkeypatch.setattr(rs, "frame_resolve_reference", spy)
    r = _renderer(mesh, route)
    assert app.resolves(r.route, r.attr_tables, r.mesh, len(r.lights))
    r.render_frame()
    assert calls == [ROUTES[route][3]]


def test_resolves_follows_the_frames_input(mesh):
    """A fused route, the attribute rows, an untextured mesh and every
    light the launch's own; nothing else decides."""
    tex = _textured(mesh)
    at = object()
    assert app.resolves("fused0", at, mesh, 1)
    assert app.resolves("fusedN", at, mesh, 3)
    assert app.resolves("fusedSM", at, mesh, 2)
    assert not app.resolves("fused0", at, mesh, 2)
    assert not app.resolves("fused0", None, mesh, 1)
    assert not app.resolves("fusedN", at, tex, 3)
    assert not app.resolves("unfused", at, mesh, 1)


# ---------------------------------------------------------------------------
# The wrapper's checks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hard_launch(mesh):
    r = _renderer(mesh, "hard_sun")
    consts = _consts(r)
    return (r, consts, *_launch(r, consts))


def test_wrapper_refuses_cpu_tensors(hard_launch):
    r, consts, launch, kind, o, d = hard_launch
    with pytest.raises(ValueError, match="need CUDA tensors"):
        rs.frame_resolve_cuda(launch, kind, consts, r.config, r.mesh, o, d)


def _non_contiguous(t):
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


@pytest.mark.parametrize("fault,match", [
    ("attrs_dtype", "attrs has dtype"),
    ("rays_shape", "rays has shape"),
    ("shadow_dtype", "shadow\\[0\\] has dtype"),
    ("attrs_layout", "attrs is not contiguous"),
    ("block_shape", "block has shape"),
    ("shadow_blocks", "shadow blocks"),
    ("kind", "shadow kind"),
    ("textured", "untextured"),
    ("flat", "image rays"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(on_cpu, hard_launch,
                                                       fault, match):
    r, consts, launch, kind, o, d = hard_launch
    m = r.mesh
    if fault == "attrs_dtype":
        launch = dataclasses.replace(launch, attrs=launch.attrs.double())
    elif fault == "rays_shape":
        launch = dataclasses.replace(launch, rays=launch.rays[:, :9])
    elif fault == "shadow_dtype":
        launch = dataclasses.replace(
            launch, shadow=(launch.shadow[0].float(),))
    elif fault == "attrs_layout":
        launch = dataclasses.replace(launch,
                                     attrs=_non_contiguous(launch.attrs))
    elif fault == "block_shape":
        consts = dataclasses.replace(consts, block=consts.block[:-1])
    elif fault == "shadow_blocks":
        launch = dataclasses.replace(launch, shadow=launch.shadow * 2)
    elif fault == "kind":
        kind = 7
    elif fault == "textured":
        m = _textured(r.mesh)
    else:
        launch = dataclasses.replace(launch, meta=("flat", W * H, 4096))
    with pytest.raises(ValueError, match=match):
        rs.frame_resolve_cuda(launch, kind, consts, r.config, m, o, d)


# ---------------------------------------------------------------------------
# The benchmark's readers
# ---------------------------------------------------------------------------

def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"resolve_test_{name}", METRICS / name / "read.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_no_walk_pattern_names_the_kernel():
    """walk_roofline times the walks alone: its patterns miss the kernel
    under its source name and as the profiler names it."""
    pats = _reader("walk_roofline").patterns(str(METRICS / "walk_roofline"))
    assert pats
    names = ["frame_resolve_kernel", "frame_resolve_kernel(ResolveParams)",
             "_Z20frame_resolve_kernel13ResolveParams"]
    assert not [n for n in names for p in pats if p.search(n)]
    assert "frame_resolve_kernel" in (CSRC / "resolve.cu").read_text()


def _traced(r, n: int, pose=None):
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n):
            if pose is not None:
                r.set_vertices(pose(i))
            r.render_frame()
    return r


def _share(r):
    from types import SimpleNamespace
    ctx = SimpleNamespace(cell=SimpleNamespace(renderer=r))
    return _reader("resolve_frame_share").read(ctx)


def test_share_reads_the_programs_counter(mesh, monkeypatch):
    """The counter counts the traced frames whose outputs the kernel
    wrote: none on the CPU, each one where the kernel ran."""
    r = _traced(_renderer(mesh, "hard_sun"), 2)
    assert r.spans.frames == 2 and r.spans.resolve_frames == 0
    assert _share(r) == 0.0
    real = rs.frame_resolve_reference

    def kernel(*args):
        rs.resolve_frame()
        return real(*args)
    monkeypatch.setattr(rs, "frame_resolve_reference", kernel)
    r = _traced(_renderer(mesh, "multi3"), 3)
    assert r.spans.resolve_frames == 3 and _share(r) == 100.0
    assert _share(_renderer(mesh, "hard_sun")) is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_equals_plain_on_the_card(card, mesh, route):
    r = _renderer(mesh, route, device=card)
    consts = _consts(r)
    launch, kind, o, d = _launch(r, consts)
    got = rs.frame_resolve_cuda(launch, kind, consts, r.config, r.mesh, o, d)
    want = rs.frame_resolve_reference(launch, kind, consts, r.config,
                                      r.mesh, o, d)
    torch.cuda.synchronize()
    _assert_same(got, want)


@pytest.mark.cuda
def test_kernel_equals_plain_at_2160p(card, mesh):
    r = _renderer(mesh, "multi3", device=card, width=3840, height=2160)
    consts = _consts(r)
    launch, kind, o, d = _launch(r, consts)
    got = rs.frame_resolve_cuda(launch, kind, consts, r.config, r.mesh, o, d)
    want = rs.frame_resolve_reference(launch, kind, consts, r.config,
                                      r.mesh, o, d)
    torch.cuda.synchronize()
    _assert_same(got, want)
    assert got["valid"].float().mean() > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["hard_sun", "soft_spp8", "multi3"])
def test_graph_frames_replay_the_kernel(card, mesh, monkeypatch, route):
    """Four frames replayed from CUDA graphs equal four eager frames bit
    for bit, keep the frame's keys, launch the kernel once a frame, and
    every traced one counts as resolved."""
    graph = _renderer(mesh, route, device=card)
    eager = _renderer(mesh, route, device=card)
    outs = {"graph": [], "eager": []}
    before = rs.frame_resolve_cuda.launches
    for i in range(4):
        outs["graph"].append(graph.render_frame())
        with monkeypatch.context() as mp:
            mp.setattr(app, "takes_graph", lambda *a: False)
            outs["eager"].append(eager.render_frame())
    torch.cuda.synchronize()
    assert rs.frame_resolve_cuda.launches == before + 8
    assert graph.stats["graph_replays"] == 3
    for a, b in zip(outs["graph"], outs["eager"]):
        _assert_same(a, b)
    _traced(graph, 2)
    assert graph.spans.graph_frames == 2 and _share(graph) == 100.0


@pytest.mark.cuda
def test_rebuild_frames_are_resolved(card, mesh):
    r = _renderer(mesh, "hard_sun", device=card, mode="rebuild")
    _traced(r, 3, pose=lambda i: deform(mesh, 0.1 * (i + 1)))
    assert r.spans.frames == 3 and _share(r) == 100.0
