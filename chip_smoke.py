"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases (one card)

Phases, in order; any failure raises and the exit code is not 0:

1. Device check: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. There is no CPU path.
2. Build the CUDA kernel library (csrc/fused_shadows.cu and
   csrc/shadow_rays.cu, templates with a mode per walk kernel, and
   csrc/build.cu, the rebuild's kernels; one nvcc per source, in
   parallel), and print ptxas's register and spill report.
3. Every kernel against its plain PyTorch version on the card: teapot
   scene, 10k triangles, 512x512, leaf 14. closest_shadow with a
   directional and a point light; multi with directional + point +
   directional; soft with a 4 deg sun at spp 8; point-soft with radius 0.4
   at spp 8; soft-multi with a cone + two directional lights and with a
   disk + one directional light. The sampling kernels run once with the
   real generator and once with the zero stream; with the zero stream
   their counts must be spp x closest_shadow's hard occlusion along the
   axis or toward the centre. Then the unfused frame's kernels on the same
   rays: closest_attrs (its channels must equal closest_shadow's bit for
   bit), any with directional and point rays from the G-buffer, and
   any_soft and any_point_soft from its biased origins with the real and
   the zero stream; zero-stream counts must be spp x any's occlusion.
4. Config 1's path at the bench headline's size (Sponza-class hall, 260k
   triangles, 1920x1080, leaf 14, one directional light) through
   Renderer(device="cuda"): one warm-up frame and five timed frames,
   checked for finite values, coverage, shadow share and bit-identical
   repeats; then the kernel against its plain version on every 8th row
   and on the whole frame.
5. Config 3: the same hall and camera, a 2 deg sun, spp 8, accumulation,
   1920x1080: one warm-up and five timed frames, exactly one soft-kernel
   launch each; finite images, a penumbra, frames that differ, and a second
   Renderer with the same seed giving bit-identical frames; the soft kernel
   against its plain version on every 8th row and on the whole frame.
6. Config 5: the same hall and camera, 3840x2160, three directional lights
   (tpurt/cli.py's "multi" set): one warm-up and five timed frames, one
   multi-kernel launch each; per-light occluded shares; the kernel against
   its plain version on every 8th row and on the whole frame.
7. Point-soft (a lamp of radius 0.5 in the hall, spp 8) and soft-multi
   (the 2 deg sun with the two fill lights, spp 8) at 1920x1080: two
   frames each through the Renderer, the kernel against its plain version
   on every 8th row, and both timed on the whole ray block.
8. The unfused frame at 1920x1080 in the same hall, through the Renderer:
   config 1 and config 3 with fused_shadow=False, the lamp with
   fused_shadow=False, and the mixed set 2 deg sun + lamp (spp 8), which
   takes the fused cone kernel for the sun and the unfused disk sampler
   for the lamp. One warm-up and five timed frames each, with the launches
   of every kernel counted; config 1's unfused image against phase 4's
   fused one; the stage split (G-buffer, shadow pass per light,
   composite); every kernel of the case against its plain version on
   every 8th row and on the whole frame (the samplers also with the zero
   stream on every 8th row); each fused_shadow=False case timed in turns
   with its fused twin (fused, unfused, unfused, fused).
9. Config 2, the per-frame rebuild (tpurt/cli.py:28): the same hall and
   camera at 1920x1080, leaf 14, Renderer(mode="rebuild"). Each build
   kernel of csrc/build.cu against its plain version on the card, equal
   bit for bit: the Morton codes of the hall's centroids; the topology of
   the hall's clustered leaf codes and of a synthetic 30k-leaf code array
   drawn from 64 values; the area collapse with the Renderer's pad and
   with a forced pad smaller than the count. Then the whole rebuilt accel
   (nodes, leaf rows, tri_id, attribute rows, count) built once with the
   kernels and once with the plain versions on the card, equal. One
   warm-up and five timed frames, one launch of each build kernel and of
   closest_shadow per frame; frames bit-identical; the image against
   config 1's static frame (another tree of the same geometry: at most
   1e-3 of valid pixels may differ by more than 1e-3); the rebuild's
   stage split; the wide depth and nw_pad. Then five animated frames
   (set_vertices(deform(mesh, t))), finite, with the count of overflow
   recoveries, and one more after a pad forced below the count, which
   must recover.
10. The raster G-buffer (tpurt's primary visibility wherever the accel is
    neither an SBVH nor a clustered rebuild): the same hall, camera and
    light at 1920x1080, Renderer(gbuffer="raster"). One warm-up and five
    timed frames, one rasterizer and one any-hit launch each, frames
    bit-identical, coverage and image against phase 4's ray-cast frame
    (tests/test_raster.py's bounds: coverage differs on < 0.2% of pixels,
    the image by more than 2e-2 on < 1%); the rasterizer against its plain
    version on the whole frame's bins (ids, u, v and 1/w equal, every
    other channel within 1e-6); the binning's host syncs (must be 0) and
    its pair, big-row and per-tile statistics; the stage split (binning,
    kernel, decode, shadow pass, composite); the raster and ray frames in
    turns; one binning call and one raster frame under torch.profiler
    (kernel time, launches, the card's idle share, the costliest
    kernels). Then the two "auto" paths that resolve to raster on the card:
    sah=False (three frames) and mode="rebuild" with rebuild_splits=0
    (one warm-up and five timed frames, each with one launch of every
    build kernel), each image against the raster frame's; and a pair
    capacity forced to 4096, which must be grown and the frame rendered
    again, equal to the first.
11. Timings on one JSON line, then the kernel table on one JSON line, the
    card's nvidia-smi line, and last {"ok": true, "device": {...}}.

Tolerances of the walk kernels' checks against their plain versions:
valid masks equal; t to rtol
1e-6 / atol 1e-6; tri_id equal on >= 99.9% of valid pixels and every
other attribute channel within 1e-6 where it is; occlusion, each bit of a
mask and counts differ on at most 1e-3 of valid (for the shadow-ray
kernels: active) pixels, and nothing is set off them. Both are built
without fused multiply-adds and draw the same random bits, so they agree
bit for bit except where float rounding of division or sqrt could differ.

The kernel table's bound_ms is the larger of two floors computed from this
run's inputs: bytes (every input and output tensor once) over 3.35 TB/s,
and float32 operations over 67 TFLOP/s. The operations are those the
kernel performs, counted by the plain version's walks on the same inputs:
per node pop 8 empty-slot compares, 25 per slab test of a non-empty child
box, and 56 per triangle test, where the closest walk tests every
triangle of a leaf it visits and an any-hit walk stops at the first
occluder. Ray set-up, sampling and integer work are not counted. The
build kernels' operations (integer ones counted at the float32 rate): 52
per Morton code; per topology node one sparse-table min per level, two
compares per level of the two searches and 10 to place it; per expanded
wide node 190 for the six greedy steps and the emission. The rasterizer:
bytes of the pair rows its tiles read, the big rows every tile reads,
the run offsets and the 13 output planes; operations counted by the plain
version on the same bins, 30 per (record, pixel) test and 29 more where
the record takes the pixel.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# The main paths' sizes: the bench headline's scene and resolutions.
MAIN_TRIS = 260_000
MAIN_W, MAIN_H = 1920, 1080
UHD_W, UHD_H = 3840, 2160
# Config 1's size for the kernel-vs-plain checks.
SMALL_TRIS = 10_000
SMALL_RES = 512
SPP = 8
BIAS = 1e-3
SUN_DIR = (0.25, 0.9, 0.2)
LAMP_POS, LAMP_RADIUS = (2.0, 9.0, 0.5), 0.5

CSRC = "tpurt_torch/kernels/csrc/"
TPU = "tpurt/kernels/traverse.py:"
KERNELS = {
    "closest_shadow": ("fused_shadows.cu", 1450),
    "closest_multi_shadow": ("fused_shadows.cu", 1538),
    "closest_soft_shadow": ("fused_shadows.cu", 1032),
    "closest_point_soft_shadow": ("fused_shadows.cu", 1117),
    "closest_soft_multi_shadow": ("fused_shadows.cu", 1622),
    "closest_attrs": ("fused_shadows.cu", 1429),
    "any": ("shadow_rays.cu", 874),
    "any_soft": ("shadow_rays.cu", 890),
    "any_point_soft": ("shadow_rays.cu", 963),
}
# The kernels that take given shadow rays or origins, no camera rays.
SHADOW_RAYS = ("any", "any_soft", "any_point_soft")

# Float32 operations per node pop (8 empty-slot compares), per slab test
# of a non-empty child box (per axis 2 sub, 2 mul, min, max; 3 max and 3
# min to close the interval; the test) and per triangle test (56), and the
# card's published peaks.
OPS_PER_POP = 8
OPS_PER_SLAB = 25
OPS_PER_TRI = 56
FP32_PEAK = 67e12
HBM_RATE = 3.35e12


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def kernel(name):
    import tpurt_torch.kernels.traverse as tr
    return getattr(tr, f"{name}_cuda"), getattr(tr, f"{name}_reference")


def all_kernels():
    from tpurt_torch.kernels.build import BUILD_KERNELS
    from tpurt_torch.kernels.raster import RASTER_KERNELS
    from tpurt_torch.kernels.traverse import CUDA_KERNELS
    return CUDA_KERNELS + BUILD_KERNELS + RASTER_KERNELS


def reset_launches():
    for fn in all_kernels():
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__[:-len("_cuda")]: fn.launches for fn in all_kernels()}


def drive(expect: dict, fn):
    """Run one main path with every launch counter at 0 just before it;
    fail unless each kernel named in ``expect`` launched that many times
    and no other kernel launched. Returns (fn's result, the counts of the
    kernels in ``expect``)."""
    reset_launches()
    res = fn()
    torch.cuda.synchronize()
    got = launches()
    want = {k: expect.get(k, 0) for k in got}
    if got != want:
        raise RuntimeError(f"main path launches {got}, want {want}")
    return res, {k: got[k] for k in expect}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, timed with
    CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    """(fn's result, host milliseconds around it, synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def compare(kres, pres, what: str, outputs) -> dict:
    """Hold the kernel's (out, *i32 outputs, counts) against the plain
    version's. outputs: one ("count", _) or ("bits", n) per i32 output."""
    ko, po = kres[0], pres[0]
    kc, pc = kres[-1].tolist(), pres[-1].tolist()
    if kc != [0, 0] or pc != [0, 0]:
        raise RuntimeError(f"{what}: walk counters kernel {kc} plain {pc}")
    ko, po = ko.double(), po.double()
    kvalid = ko[:, 1] >= 0
    valid = po[:, 1] >= 0
    if not torch.equal(kvalid, valid):
        raise RuntimeError(f"{what}: valid masks differ on "
                           f"{int((kvalid != valid).sum())} rays")
    nvalid = int(valid.sum())
    if nvalid == 0:
        raise RuntimeError(f"{what}: no ray hit the scene")
    kt, pt = ko[:, 0][valid], po[:, 0][valid]
    if not torch.all((kt - pt).abs() <= 1e-6 + 1e-6 * pt.abs()):
        raise RuntimeError(f"{what}: t differs by up to "
                           f"{float((kt - pt).abs().max())}")
    same = (ko[:, 8] == po[:, 8]) & valid
    tri_frac = float(same.sum()) / nvalid
    if tri_frac < 0.999:
        raise RuntimeError(f"{what}: tri_id equal on only {tri_frac:.5f}")
    err = (ko - po).abs().permute(0, 2, 3, 1)[same]     # [n, 15]
    attr_err = float(err[:, 2:].max())
    if attr_err > 1e-6:
        raise RuntimeError(f"{what}: attribute channels differ by "
                           f"{attr_err}")
    shares = []
    for (kind, n), ki, pi in zip(outputs, kres[1:-1], pres[1:-1]):
        if bool((ki[~valid] != 0).any()):
            raise RuntimeError(f"{what}: shadow output set off the hit set")
        planes = [(ki, pi)] if kind == "count" else \
            [((ki >> b) & 1, (pi >> b) & 1) for b in range(n)]
        for a, b in planes:
            shares.append(int(((a != b) & valid).sum()) / nvalid)
    mism = max(shares, default=0.0)
    if mism > 1e-3:
        raise RuntimeError(f"{what}: shadow outputs differ on {mism:.2e} "
                           f"of valid rays ({shares})")
    max_abs = max(float((kt - pt).abs().max()), attr_err)
    return dict(valid=nvalid, tri_id_equal=tri_frac, mismatch_share=mism,
                mismatch_shares=shares, max_abs_err=max_abs)


def compare_rays(kres, pres, active, what: str) -> dict:
    """Hold a shadow-ray kernel's (i32 block, counts) against the plain
    version's; ``active``: the rays that walk (t_max > t_min, or a valid
    origin)."""
    kc, pc = kres[-1].tolist(), pres[-1].tolist()
    if kc != [0, 0] or pc != [0, 0]:
        raise RuntimeError(f"{what}: walk counters kernel {kc} plain {pc}")
    k, p = kres[0], pres[0]
    nact = int(active.sum())
    if nact == 0:
        raise RuntimeError(f"{what}: no active ray")
    if bool((k[~active] != 0).any()):
        raise RuntimeError(f"{what}: output set on an inactive ray")
    mism = int(((k != p) & active).sum()) / nact
    if mism > 1e-3:
        raise RuntimeError(f"{what}: outputs differ on {mism:.2e} of "
                           f"active rays")
    return dict(valid=nact, mismatch_share=mism,
                max_abs_err=float((k - p).abs().max()))


def check(name, kres, pres, args, kw, what) -> dict:
    """The comparison that fits kernel ``name``'s outputs."""
    if name in SHADOW_RAYS:
        rays = args[0]
        active = rays[:, 9] > kw["t_min"] if name == "any" \
            else rays[:, 3] > 0.0
        return compare_rays(kres, pres, active, what)
    return compare(kres, pres, what, outputs_of(name, kw))


def bound(stats: dict, args, res) -> dict:
    """Least time for the same work on the card: bytes of every input and
    output once over the memory rate, the kernel's float32 operations
    (from the plain version's counted visits) over the float32 peak.
    ``ops_upper`` ignores the kernel's early exits (every child slot
    slab-tested, every triangle of a visited leaf tested) and shows what
    they save."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)] + list(res)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = {k: int(stats.get(k, 0)) for k in (
        "pops", "slab_tests", "closest_tris", "anyhit_tris",
        "anyhit_leaf_tris")}
    ops = (n["pops"] * OPS_PER_POP + n["slab_tests"] * OPS_PER_SLAB
           + (n["closest_tris"] + n["anyhit_tris"]) * OPS_PER_TRI)
    ops_upper = (n["pops"] * 8 * (OPS_PER_SLAB + 1)
                 + (n["closest_tris"] + n["anyhit_leaf_tris"]) * OPS_PER_TRI)
    bytes_ms = nbytes / HBM_RATE * 1e3
    ops_ms = ops / FP32_PEAK * 1e3
    return dict(bytes=nbytes, ops=ops, ops_upper=ops_upper, **n,
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def outputs_of(name, kw):
    """The kernel's i32 outputs for ``compare``."""
    if name == "closest_shadow":
        return [("bits", 1)]
    if name == "closest_multi_shadow":
        return [("bits", len(kw["points"]))]
    if name == "closest_soft_multi_shadow":
        return [("count", 0), ("bits", kw["n_extra"])]
    if name == "closest_attrs":
        return []
    return [("count", 0)]


def check_pair(name, args, kw, what) -> tuple:
    """The kernel and its plain version on the same inputs -> (comparison,
    kernel result)."""
    kfn, pfn = kernel(name)
    before = kfn.launches
    kres = kfn(*args, **kw)
    torch.cuda.synchronize()
    if kfn.launches != before + 1:
        raise RuntimeError(f"{name}: launch counter did not grow")
    pres = pfn(*args, **kw)
    torch.cuda.synchronize()
    res = check(name, kres, pres, args, kw, what)
    kfn.launches = before
    return res, kres


def time_pair(name, args, kw, reps: int = 10) -> dict:
    """Kernel time (CUDA events) and plain time (one run, host clock) on
    the same inputs, the comparison, and the bound from the plain
    version's counted visits."""
    kfn, pfn = kernel(name)
    before = kfn.launches
    kres = kfn(*args, **kw)
    ms = cuda_ms(lambda: kfn(*args, **kw), reps)
    kfn.launches = before
    stats = {}
    pres, plain_ms = host_ms(lambda: pfn(*args, stats=stats, **kw))
    cmp = check(name, kres, pres, args, kw, f"{name} whole block")
    return dict(ms=ms, plain_ms=plain_ms, compare=cmp,
                **bound(stats, args, kres))


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version at 512^2
# ---------------------------------------------------------------------------

def inputs(name, acc, attr_tables, o, d, **spec):
    """The kernel's arguments for these rays, as the frame packs them."""
    import tpurt_torch.kernels.traverse as tr
    args, kw, _, _ = getattr(tr, f"{name}_inputs")(
        acc, o, d, bias=BIAS, attr_tables=attr_tables, **spec)
    return args, kw


def phase_small(dev) -> dict:
    """Every kernel vs its plain version at config-1 scale (teapot 10k,
    512x512, leaf 14)."""
    from tpurt_torch.app import Renderer
    from tpurt_torch.bvh.wide import order_children_for_point
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.scenes import default_camera_for, teapot_scene
    from tpurt_torch.types import Light, RenderConfig
    mesh = teapot_scene(SMALL_TRIS)
    cam = default_camera_for(mesh)
    bmin, bmax = mesh.bounds()
    lpos = 0.5 * (bmin + bmax) + np.float32([2.0, 6.0, 1.0])
    sun = Light.directional((0.45, 0.8, 0.3)).direction
    fill = Light.directional((-0.5, 0.7, 0.2)).direction
    fill2 = Light.directional((0.1, 0.9, -0.4)).direction
    cone_cos = float(np.cos(np.float32(np.deg2rad(4.0))))
    r = Renderer(mesh, cam, Light.directional(sun),
                 RenderConfig(width=SMALL_RES, height=SMALL_RES,
                              leaf_size=14), device=dev)
    acc = order_children_for_point(r.accel, cam.position)
    o, d = generate_rays(cam, SMALL_RES, SMALL_RES, dev)

    def args_of(name, **spec):
        return inputs(name, acc, r.attr_tables, o, d, **spec)

    hard = {}
    out = {}
    for kind, spec in (("directional", dict(light_dir=sun)),
                       ("point", dict(light_dir=sun, light_pos=lpos))):
        args, kw = args_of("closest_shadow", **spec)
        res, kres = check_pair("closest_shadow", args, kw, f"512^2 {kind}")
        hard[kind] = kres[1]
        hard[f"{kind} channels"] = kres[0]
        res.update(time_pair("closest_shadow", args, kw, 20))
        out[f"closest_shadow/{kind}"] = res
        log(f"phase 3 closest_shadow {kind}: {json.dumps(res)}")
    hard["fill"] = check_pair(
        "closest_shadow", *args_of("closest_shadow", light_dir=fill),
        "512^2 fill")[1][1]

    args, kw = args_of("closest_multi_shadow",
                       lights=[(sun, None), (None, lpos), (fill, None)])
    res, kres = check_pair("closest_multi_shadow", args, kw, "512^2 multi")
    # Each bit against the single-light kernel on the same light: the same
    # ray recipe, so they should agree on every ray.
    nvalid = int((kres[0][:, 1] >= 0).sum())
    res["vs_single_light_mismatch"] = [
        int((((kres[1] >> bit) & 1) != want).sum()) / nvalid
        for bit, want in ((0, hard["directional"]), (1, hard["point"]),
                          (2, hard["fill"]))]
    if max(res["vs_single_light_mismatch"]) > 1e-3:
        raise RuntimeError(f"multi bits differ from the single-light "
                           f"kernel: {res['vs_single_light_mismatch']}")
    res.update(time_pair("closest_multi_shadow", args, kw, 20))
    out["closest_multi_shadow"] = res
    log(f"phase 3 closest_multi_shadow: {json.dumps(res)}")

    samplers = {
        "closest_soft_shadow": [("cone", dict(
            axis_dir=sun, cone_cos=cone_cos, spp=SPP, seed=11), "directional")],
        "closest_point_soft_shadow": [("disk", dict(
            light_pos=lpos, radius=0.4, spp=SPP, seed=11), "point")],
        "closest_soft_multi_shadow": [
            ("cone+2", dict(light0=("cone", sun, cone_cos),
                            extra_dirs=[fill, fill2], spp=SPP, seed=11),
             "directional"),
            ("disk+1", dict(light0=("disk", lpos, 0.4), extra_dirs=[fill],
                            spp=SPP, seed=11), "point")],
    }
    for name, cases in samplers.items():
        for label, spec, hard_kind in cases:
            for zero in (False, True):
                what = f"512^2 {name} {label} zero_stream={zero}"
                args, kw = args_of(name, zero_stream=zero, **spec)
                res, kres = check_pair(name, args, kw, what)
                if zero:
                    want = SPP * hard[hard_kind]
                    valid = kres[0][:, 1] >= 0
                    share = int(((kres[1] != want) & valid).sum()) / int(
                        valid.sum())
                    if share > 1e-3:
                        raise RuntimeError(f"{what}: counts differ from spp "
                                           f"x hard on {share:.2e}")
                    res["zero_vs_hard_mismatch"] = share
                else:
                    cnt = kres[1][kres[0][:, 1] >= 0]
                    res["penumbra_share"] = float(
                        ((cnt > 0) & (cnt < SPP)).float().mean())
                    if not res["penumbra_share"] > 0:
                        raise RuntimeError(f"{what}: no penumbra")
                    res.update(time_pair(name, args, kw, 20))
                out[f"{name}/{label}/zero={zero}"] = res
                log(f"phase 3 {what}: {json.dumps(res)}")
    out.update(small_unfused(r, mesh, cam, o, d, acc, sun, lpos, cone_cos,
                             hard["directional channels"]))
    return out


def small_unfused(r, mesh, cam, o, d, acc, sun, lpos, cone_cos,
                  hard_channels) -> dict:
    """The unfused frame's kernels at 512^2: the closest hit alone, then
    shadow rays and origins made from its G-buffer on the unordered
    accel, as the unfused shadow pass makes them."""
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.passes.gbuffer import gbuf_from_attr_channels
    from tpurt_torch.passes.shadow import shadow_ray_batch
    from tpurt_torch.types import Light
    out = {}
    args, kw, p, meta = tr.closest_attrs_inputs(acc, o, d, r.attr_tables)
    res, kres = check_pair("closest_attrs", args, kw, "512^2 closest_attrs")
    if not torch.equal(kres[0], hard_channels):
        raise RuntimeError("closest_attrs channels differ from "
                           "closest_shadow's")
    res.update(time_pair("closest_attrs", args, kw, 20))
    out["closest_attrs"] = res
    log(f"phase 3 closest_attrs: {json.dumps(res)}")
    gbuf = gbuf_from_attr_channels(tr._attr_channels(kres[0], p, meta), o, d,
                                   cam, mesh)
    bounds = (r.accel.root_min, r.accel.root_max)
    lights = {"directional": Light.directional(sun),
              "point": Light.point(lpos)}
    occ = {}
    for kind, light in lights.items():
        so, sd, stm = shadow_ray_batch(gbuf, light, BIAS, None, bounds)
        args, kw = tr.any_inputs(r.accel, so, sd, stm)[:2]
        res, kres = check_pair("any", args, kw, f"512^2 any {kind}")
        occ[kind] = kres[0]
        res.update(time_pair("any", args, kw, 20))
        out[f"any/{kind}"] = res
        log(f"phase 3 any {kind}: {json.dumps(res)}")
    origins = gbuf["position"] + gbuf["gnormal"] * BIAS
    samplers = (("any_soft", dict(axis_dir=lights["directional"].direction,
                                  cone_cos=cone_cos), "directional"),
                ("any_point_soft", dict(light_pos=lpos, radius=0.4),
                 "point"))
    for name, spec, hard_kind in samplers:
        for zero in (False, True):
            what = f"512^2 {name} zero_stream={zero}"
            args, kw = getattr(tr, f"{name}_inputs")(
                r.accel, origins, gbuf["valid"], spp=SPP, seed=11, light=1,
                zero_stream=zero, **spec)[:2]
            res, kres = check_pair(name, args, kw, what)
            active = args[0][:, 3] > 0.0
            if zero:
                share = int(((kres[0] != SPP * occ[hard_kind]) & active)
                            .sum()) / int(active.sum())
                if share > 1e-3:
                    raise RuntimeError(f"{what}: counts differ from spp x "
                                       f"any's occlusion on {share:.2e}")
                res["zero_vs_hard_mismatch"] = share
            else:
                cnt = kres[0][active]
                res["penumbra_share"] = float(
                    ((cnt > 0) & (cnt < SPP)).float().mean())
                if not res["penumbra_share"] > 0:
                    raise RuntimeError(f"{what}: no penumbra")
                res.update(time_pair(name, args, kw, 20))
            out[f"{name}/zero={zero}"] = res
            log(f"phase 3 {what}: {json.dumps(res)}")
    return out


# ---------------------------------------------------------------------------
# Phases 4-7: the main paths at full size
# ---------------------------------------------------------------------------

def frames(r, n: int):
    """n frames with CUDA events around each -> (kept outputs, ms of all
    but the first)."""
    kept, ms = [], []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = r.render_frame()
        end.record()
        torch.cuda.synchronize()
        kept.append({"image": out["image"], "shadow": out["shadow"],
                     "valid": out["valid"]})
        if i > 0:
            ms.append(start.elapsed_time(end))
    return kept, ms


def check_image(out, w, h, what):
    img = out["image"]
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"{what}: image is not finite f32[H, W, 3]")
    share = float(out["valid"].float().mean())
    if not share > 0.5:
        raise RuntimeError(f"{what}: only {share:.3f} of pixels are valid")
    return share


def frame_inputs(name, r, w, h, **spec):
    """The kernel's inputs for the Renderer's whole frame and for every
    8th row of it, on the accel the frame walks (camera-ordered unless
    the config turns that off)."""
    from tpurt_torch.app import _gb_accel
    from tpurt_torch.camera import generate_rays
    acc = _gb_accel(r.accel, r.camera, r.config)
    o, d = generate_rays(r.camera, w, h, r.device)
    full = inputs(name, acc, r.attr_tables, o, d, **spec)
    sub = inputs(name, acc, r.attr_tables, o[::8].contiguous(),
                 d[::8].contiguous(), **spec)
    return full, sub


def kernel_vs_plain(name, r, w, h, what, **spec) -> dict:
    return vs_plain(name, *frame_inputs(name, r, w, h, **spec), what)


def vs_plain(name, full_inputs, sub_inputs, what) -> dict:
    """The kernel against its plain version on every 8th row, then timed
    and compared on the whole frame."""
    (args, kw), (sargs, skw) = full_inputs, sub_inputs
    sub, _ = check_pair(name, sargs, skw, f"{what} every 8th row")
    log(f"{what} every 8th row: {json.dumps(sub)}")
    full = time_pair(name, args, kw)
    log(f"{what} whole frame: {json.dumps(full)}")
    full["subsample"] = sub
    full["max_abs_err"] = max(sub["max_abs_err"],
                              full["compare"]["max_abs_err"])
    full["mismatch_share"] = max(sub["mismatch_share"],
                                 full["compare"]["mismatch_share"])
    return full


def stage_ms(r, trace, frame_ms_mean: float, reps: int = 5) -> dict:
    """Where a frame's time goes: CUDA events around each stage of
    render_frame_fn, run by hand on the Renderer's state (mean of reps
    calls, launch overhead included); the composite and the rest by
    difference from the mean frame. ``trace(accel, origins, dirs)`` is the
    frame's fused wrapper (packing, the kernel, channel unpacking)."""
    from tpurt_torch.app import _gb_accel
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.passes.gbuffer import gbuf_from_attr_channels
    cfg, cam = r.config, r.camera
    acc = _gb_accel(r.accel, cam, cfg)
    o, d = generate_rays(cam, cfg.width, cfg.height, r.device)
    ch = trace(acc, o, d)[0]
    stages = {
        "generate_rays": lambda: generate_rays(cam, cfg.width, cfg.height,
                                               r.device),
        "order_children": lambda: _gb_accel(r.accel, cam, cfg),
        "trace": lambda: trace(acc, o, d),
        "gbuffer_decode": lambda: gbuf_from_attr_channels(ch, o, d, cam,
                                                          r.mesh),
    }
    out = {k: cuda_ms(fn, reps) for k, fn in stages.items()}
    out["composite_and_rest"] = frame_ms_mean - sum(out.values())
    return out


def rays_per_s(npix, nvalid, nshadow, mean_ms) -> dict:
    s = mean_ms / 1e3
    return dict(primary_rays_per_s=npix / s, shadow_rays_per_s=nshadow / s,
                primary_plus_shadow_rays_per_s=(npix + nshadow) / s,
                valid_pixels=nvalid)


def setup_stats(r) -> dict:
    return dict(wide_rows=r.accel.num_wide, wide_depth=r.depth, **r.stats)


def phase_config1(dev, mesh) -> dict:
    """Config 1's fused frame at the bench headline's size."""
    from tpurt_torch.app import Renderer
    from tpurt_torch.kernels.traverse import trace_closest_shadow
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    light = Light.directional(SUN_DIR)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14)
    r = Renderer(mesh, cam, light, cfg, device=dev)
    log(f"phase 4 setup: tris={mesh.num_triangles} {json.dumps(setup_stats(r))}")
    torch.cuda.reset_peak_memory_stats()
    (kept, frame_ms), n = drive({"closest_shadow": 6}, lambda: frames(r, 6))
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    valid_share = check_image(kept[0], MAIN_W, MAIN_H, "config 1")
    valid = kept[0]["valid"]
    occ_share = float((kept[0]["shadow"][0][valid] < 1.0).float().mean())
    if not 0.0 < occ_share < 1.0:
        raise RuntimeError(f"occluded share {occ_share} not in (0, 1)")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("config 1 frames are not bit-identical")
    kp = kernel_vs_plain("closest_shadow", r, MAIN_W, MAIN_H, "phase 4",
                         light_dir=light.direction)
    mean_ms = float(np.mean(frame_ms))
    stages = stage_ms(r, lambda acc, o, d: trace_closest_shadow(
        acc, o, d, light.direction, BIAS, attr_tables=r.attr_tables),
        mean_ms)
    nvalid = int(valid.sum())
    return dict(launches=n["closest_shadow"], frame_ms=frame_ms,
                frame_ms_mean=mean_ms, kernel=kp, stages_ms=stages,
                image=kept[0]["image"], valid=valid, renderer=r,
                valid_share=valid_share,
                occluded_share=occ_share,
                peak_mem_mb=peak_mb, tris=mesh.num_triangles,
                **rays_per_s(MAIN_W * MAIN_H, nvalid, nvalid, mean_ms),
                **setup_stats(r))


def phase_config3(dev, mesh) -> dict:
    """Config 3: 2 deg sun, spp 8, accumulation, 1080p."""
    from tpurt_torch.app import Renderer, frame_seed
    from tpurt_torch.kernels.traverse import trace_closest_soft_shadow
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    sun = Light.sun(SUN_DIR, angular_radius_deg=2.0)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, spp=SPP, accumulate=True,
                       leaf_size=14)
    r = Renderer(mesh, cam, sun, cfg, device=dev)
    if r.route != "fused0":
        raise RuntimeError(f"config 3 takes route {r.route}")
    (kept, frame_ms), n = drive({"closest_soft_shadow": 6},
                                lambda: frames(r, 6))
    for f in kept:
        check_image(f, MAIN_W, MAIN_H, "config 3")
    valid = kept[0]["valid"]
    vis = kept[0]["shadow"][0][valid]
    penumbra = float(((vis > 0) & (vis < 1)).float().mean())
    occluded = float((vis < 1).float().mean())
    if not penumbra > 0:
        raise RuntimeError("config 3: no penumbra")
    if torch.equal(kept[0]["shadow"], kept[1]["shadow"]):
        raise RuntimeError("config 3: successive frames drew the same "
                           "samples")
    again, _ = frames(Renderer(mesh, cam, sun, cfg, device=dev), 6)
    for i, (a, b) in enumerate(zip(kept, again)):
        if not torch.equal(a["image"], b["image"]):
            raise RuntimeError(f"config 3 frame {i}: same seed, other image")
    cone_cos = float(np.cos(sun.angular_radius))
    seed = frame_seed(cfg.seed, 0)
    kp = kernel_vs_plain("closest_soft_shadow", r, MAIN_W, MAIN_H,
                         "phase 5", axis_dir=sun.direction,
                         cone_cos=cone_cos, spp=SPP, seed=seed)
    mean_ms = float(np.mean(frame_ms))
    stages = stage_ms(r, lambda acc, o, d: trace_closest_soft_shadow(
        acc, o, d, sun.direction, cone_cos, SPP, seed, BIAS,
        attr_tables=r.attr_tables), mean_ms)
    nvalid = int(valid.sum())
    return dict(launches=n["closest_soft_shadow"], frame_ms=frame_ms,
                frame_ms_mean=mean_ms, kernel=kp, stages_ms=stages,
                penumbra_share=penumbra,
                occluded_share=occluded,
                **rays_per_s(MAIN_W * MAIN_H, nvalid, nvalid * SPP, mean_ms))


def config5_lights():
    from tpurt_torch.types import Light
    return [Light.directional(SUN_DIR, intensity=0.8),
            Light.directional((-0.55, 0.65, 0.25), color=(1.0, 0.85, 0.6),
                              intensity=0.5),
            Light.directional((0.1, 0.9, -0.4), color=(0.7, 0.8, 1.0),
                              intensity=0.35)]


def phase_config5(dev, mesh) -> dict:
    """Config 5: three directional lights at 3840x2160."""
    from tpurt_torch.app import Renderer
    from tpurt_torch.kernels.traverse import trace_closest_multi_shadow
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import RenderConfig
    cam = sponza_interior_camera()
    lights = config5_lights()
    cfg = RenderConfig(width=UHD_W, height=UHD_H, leaf_size=14)
    r = Renderer(mesh, cam, lights, cfg, device=dev)
    if r.route != "fusedN":
        raise RuntimeError(f"config 5 takes route {r.route}")
    torch.cuda.reset_peak_memory_stats()
    (kept, frame_ms), n = drive({"closest_multi_shadow": 6},
                                lambda: frames(r, 6))
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    check_image(kept[0], UHD_W, UHD_H, "config 5")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("config 5 frames are not bit-identical")
    valid = kept[0]["valid"]
    shares = [float((s[valid] < 1.0).float().mean())
              for s in kept[0]["shadow"]]
    if not 0.0 < shares[0] < 1.0:
        raise RuntimeError(f"config 5 light 0 occluded share {shares[0]}")
    spec = [(l.direction, None) for l in lights]
    kp = kernel_vs_plain("closest_multi_shadow", r, UHD_W, UHD_H, "phase 6",
                         lights=spec)
    mean_ms = float(np.mean(frame_ms))
    stages = stage_ms(r, lambda acc, o, d: trace_closest_multi_shadow(
        acc, o, d, spec, BIAS, attr_tables=r.attr_tables), mean_ms)
    nvalid = int(valid.sum())
    return dict(launches=n["closest_multi_shadow"], frame_ms=frame_ms,
                frame_ms_mean=mean_ms, kernel=kp, stages_ms=stages,
                occluded_shares=shares,
                peak_mem_mb=peak_mb,
                **rays_per_s(UHD_W * UHD_H, nvalid, nvalid * len(lights),
                             mean_ms))


def phase_soft_variants(dev, mesh) -> dict:
    """Point-soft and soft-multi at 1080p through the Renderer."""
    from tpurt_torch.app import Renderer, frame_seed
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, spp=SPP, leaf_size=14)
    sun = Light.sun(SUN_DIR, angular_radius_deg=2.0)
    fills = config5_lights()[1:]
    lamp = Light.point(LAMP_POS, radius=LAMP_RADIUS)
    cases = {
        "closest_point_soft_shadow": (
            [lamp], "fused0",
            dict(light_pos=lamp.position, radius=LAMP_RADIUS, spp=SPP,
                 seed=frame_seed(cfg.seed, 0))),
        "closest_soft_multi_shadow": (
            [sun] + fills, "fusedSM",
            dict(light0=("cone", sun.direction,
                         float(np.cos(sun.angular_radius))),
                 extra_dirs=[l.direction for l in fills], spp=SPP,
                 seed=frame_seed(cfg.seed, 0))),
    }
    out = {}
    for name, (lights, route, spec) in cases.items():
        r = Renderer(mesh, cam, lights, cfg, device=dev)
        if r.route != route:
            raise RuntimeError(f"{name}: route {r.route}, want {route}")
        (kept, frame_ms), n = drive({name: 2}, lambda: frames(r, 2))
        for f in kept:
            check_image(f, MAIN_W, MAIN_H, name)
        valid = kept[0]["valid"]
        vis = kept[0]["shadow"][0][valid]
        penumbra = float(((vis > 0) & (vis < 1)).float().mean())
        if not penumbra > 0:
            raise RuntimeError(f"{name}: no penumbra")
        kp = kernel_vs_plain(name, r, MAIN_W, MAIN_H, f"phase 7 {name}",
                             **spec)
        out[name] = dict(launches=n[name], frame_ms=frame_ms, kernel=kp,
                         penumbra_share=penumbra,
                         occluded_shares=[float((s[valid] < 1).float()
                                                .mean())
                                          for s in kept[0]["shadow"]])
    return out


def unfused_inputs(name, r, light_index: int, step: int):
    """Kernel ``name``'s inputs in the Renderer's unfused frame, on every
    ``step``-th row: the closest hit on the camera-ordered accel, shadow
    rays or origins from its G-buffer on the accel as built."""
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.app import _gb_accel, frame_seed, gbuffer_production
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.passes.shadow import cone_cos, shadow_ray_batch
    cfg = r.config

    def rows(x):
        return x[::step].contiguous()
    if name == "closest_attrs":
        o, d = generate_rays(r.camera, cfg.width, cfg.height, r.device)
        return tr.closest_attrs_inputs(_gb_accel(r.accel, r.camera, cfg),
                                       rows(o), rows(d), r.attr_tables)[:2]
    gbuf, _ = gbuffer_production(r.accel, r.mesh, r.camera, cfg,
                                 r.attr_tables)
    light = r.lights[light_index]
    if name == "any":
        so, sd, stm = shadow_ray_batch(gbuf, light, cfg.shadow_bias, None,
                                       (r.accel.root_min, r.accel.root_max))
        return tr.any_inputs(r.accel, rows(so), rows(sd), rows(stm))[:2]
    origins = rows(gbuf["position"] + gbuf["gnormal"] * cfg.shadow_bias)
    valid = rows(gbuf["valid"])
    seed = frame_seed(cfg.seed, 0)
    if name == "any_soft":
        return tr.any_soft_inputs(r.accel, origins, valid, light.direction,
                                  cone_cos(light), cfg.spp, seed,
                                  light_index)[:2]
    return tr.any_point_soft_inputs(r.accel, origins, valid, light.position,
                                    float(light.radius), cfg.spp, seed,
                                    light_index)[:2]


def stage_ms_unfused(r, frame_ms_mean: float, reps: int = 5) -> dict:
    """Where an unfused or mixed frame's time goes: CUDA events around the
    G-buffer (with light 0's fused shadow on the fused0 route), each
    light's unfused shadow pass and the composite, run by hand on the
    Renderer's state (mean of reps calls); the rest by difference."""
    from tpurt_torch.app import (composite_lights, frame_seed,
                                 gbuffer_production,
                                 gbuffer_shadow_fused_production,
                                 shadow_production, unfused_lights)
    cfg = r.config
    seed = frame_seed(cfg.seed, 0)
    if r.route == "fused0":
        def gb():
            return gbuffer_shadow_fused_production(
                r.accel, r.mesh, r.camera, cfg, r.lights[0], r.attr_tables,
                seed)
        gbuf, vis0, _ = gb()
        shadows = [vis0]
        out = {"gbuffer_and_light0_fused": cuda_ms(gb, reps)}
    else:
        def gb():
            return gbuffer_production(r.accel, r.mesh, r.camera, cfg,
                                      r.attr_tables)
        gbuf, _ = gb()
        shadows = []
        out = {"gbuffer": cuda_ms(gb, reps)}
    for li in unfused_lights(r.route, len(r.lights)):
        def shadow(li=li):
            return shadow_production(r.accel, gbuf, r.lights[li], seed, li,
                                     cfg)
        shadows.append(shadow()[0])
        out[f"shadow_pass_light{li}"] = cuda_ms(shadow, reps)
    out["composite"] = cuda_ms(
        lambda: composite_lights(gbuf, shadows, r.lights, cfg), reps)
    out["counter_read_rest"] = frame_ms_mean - sum(out.values())
    return out


def in_turns(ra, rb, n: int = 5) -> dict:
    """Frame ms of two Renderers in turns (a, b, b, a, repeated n times;
    CUDA events around each frame), so that both see the same host and
    card state."""
    ms = {"a": [], "b": []}
    for _ in range(n):
        for key, r in (("a", ra), ("b", rb), ("b", rb), ("a", ra)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r.render_frame()
            end.record()
            torch.cuda.synchronize()
            ms[key].append(start.elapsed_time(end))
    return {k: dict(mean=float(np.mean(v)), min=float(np.min(v)), ms=v)
            for k, v in ms.items()}


def phase_unfused(dev, mesh, fused_config1_image) -> dict:
    """The unfused frame at 1080p: configs 1 and 3 and the lamp with
    fused_shadow=False, and the mixed set sun + lamp (fused0 + unfused)."""
    from tpurt_torch.app import Renderer
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import LIGHT_DIRECTIONAL, Light, RenderConfig
    cam = sponza_interior_camera()
    sun = Light.sun(SUN_DIR, angular_radius_deg=2.0)
    lamp = Light.point(LAMP_POS, radius=LAMP_RADIUS)
    unfused = dict(fused_shadow=False)
    # label: (lights, config fields, route, launches per frame by kernel,
    # the unfused kernels to hold against their plain versions with the
    # index of the light they trace). The three fused_shadow=False cases
    # are also timed in turns with their fused twin.
    cases = {
        "config1_unfused": ([Light.directional(SUN_DIR)], dict(unfused),
                            "unfused", {"closest_attrs": 1, "any": 1},
                            [("closest_attrs", 0), ("any", 0)]),
        "config3_unfused": ([sun], dict(unfused, spp=SPP), "unfused",
                            {"closest_attrs": 1, "any_soft": 1},
                            [("any_soft", 0)]),
        "lamp_unfused": ([lamp], dict(unfused, spp=SPP), "unfused",
                         {"closest_attrs": 1, "any_point_soft": 1},
                         [("any_point_soft", 0)]),
        "sun_lamp_mixed": ([sun, lamp], dict(spp=SPP), "fused0",
                           {"closest_soft_shadow": 1, "any_point_soft": 1},
                           [("any_point_soft", 1)]),
    }
    out = {}
    for label, (lights, fields, route, per_frame, checked) in cases.items():
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14,
                           **fields)
        r = Renderer(mesh, cam, lights, cfg, device=dev)
        if r.route != route:
            raise RuntimeError(f"{label}: route {r.route}, want {route}")
        (kept, frame_ms), n = drive({k: 6 * v for k, v in per_frame.items()},
                                    lambda: frames(r, 6))
        for f in kept:
            check_image(f, MAIN_W, MAIN_H, label)
        valid = kept[0]["valid"]
        res = dict(route=route, launches=n, frame_ms=frame_ms,
                   frame_ms_mean=float(np.mean(frame_ms)),
                   occluded_shares=[float((s[valid] < 1).float().mean())
                                    for s in kept[0]["shadow"]])
        for li, light in enumerate(lights):
            if light.kind != LIGHT_DIRECTIONAL:
                vis = kept[0]["shadow"][li][valid]
                pen = float(((vis > 0) & (vis < 1)).float().mean())
                if not pen > 0:
                    raise RuntimeError(f"{label} light {li}: no penumbra")
                res[f"penumbra_share_light{li}"] = pen
        if label == "config1_unfused":
            img = kept[0]["image"]
            differ = (img != fused_config1_image).any(-1) & valid
            share = float(differ.sum()) / int(valid.sum())
            if share > 1e-3:
                raise RuntimeError(f"config 1 unfused image differs from the "
                                   f"fused one on {share:.2e} of valid pixels")
            res["vs_fused_image_share"] = share
        res["kernels"] = {
            name: vs_plain(name, unfused_inputs(name, r, li, 1),
                           unfused_inputs(name, r, li, 8),
                           f"phase 8 {label} {name}")
            for name, li in checked}
        for name, li in checked:
            if name in ("any_soft", "any_point_soft"):
                args, kw = unfused_inputs(name, r, li, 8)
                res["kernels"][name]["zero_stream_every_8th_row"] = \
                    check_pair(name, args, dict(kw, zero_stream=True),
                               f"phase 8 {label} {name} zero stream")[0]
        res["stages_ms"] = stage_ms_unfused(r, res["frame_ms_mean"])
        if not cfg.fused_shadow:
            twin = Renderer(mesh, cam, lights,
                            dataclasses.replace(cfg, fused_shadow=True),
                            device=dev)
            turns = in_turns(twin, r)
            res["in_turns_ms"] = {"fused": turns["a"], "unfused": turns["b"]}
        out[label] = res
        log(f"phase 8 {label}: {json.dumps(res)}")
    return out


# ---------------------------------------------------------------------------
# Phase 9: config 2, the per-frame rebuild
# ---------------------------------------------------------------------------

BUILD_TPU = "tpurt/kernels/build.py:"
BUILD_KERNEL_LINES = {"morton_codes": 353, "topology": 265,
                      "collapse_area": 742}
OPS_PER_CODE = 52
OPS_PER_TOPOLOGY_PLACE = 10
OPS_PER_WIDE_NODE = 190


class plain_build_kernels:
    """Within the block the build wrappers take their plain versions on
    CUDA tensors too (the twin of a rebuild made with the kernels)."""

    NAMES = ("morton_codes", "topology", "collapse_area")

    def __enter__(self):
        import tpurt_torch.kernels.build as b
        self.saved = {n: getattr(b, f"{n}_cuda") for n in self.NAMES}
        for n in self.NAMES:
            setattr(b, f"{n}_cuda", getattr(b, f"{n}_reference"))

    def __exit__(self, *exc):
        import tpurt_torch.kernels.build as b
        for n, fn in self.saved.items():
            setattr(b, f"{n}_cuda", fn)


def host_syncs(fn) -> list:
    """Run fn under CUDA's sync debug mode; each call that waits for the
    card warns, and is returned as the port's innermost frame that made
    it."""
    import traceback
    found = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if "tpurt_torch" in f.filename]
        found.append(f"{frames[-1].filename.split('tpurt_torch/')[-1]}:"
                     f"{frames[-1].lineno} {frames[-1].line}"
                     if frames else str(message))
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def build_pair(name, args, what) -> dict:
    """A build kernel and its plain version on the same inputs: every
    output equal exactly -> (comparison, kernel result)."""
    import tpurt_torch.kernels.build as b
    kfn, pfn = getattr(b, f"{name}_cuda"), getattr(b, f"{name}_reference")
    before = kfn.launches
    kres = kfn(*args)
    torch.cuda.synchronize()
    if kfn.launches != before + 1:
        raise RuntimeError(f"{name}: launch counter did not grow")
    kfn.launches = before
    pres = pfn(*args)
    torch.cuda.synchronize()
    kres = kres if isinstance(kres, tuple) else (kres,)
    pres = pres if isinstance(pres, tuple) else (pres,)
    err = 0
    for i, (k, p) in enumerate(zip(kres, pres)):
        if k.shape != p.shape or k.dtype != p.dtype or not torch.equal(k, p):
            bad = int((k != p).sum()) if k.shape == p.shape else -1
            raise RuntimeError(f"{what}: output {i} differs from the plain "
                               f"version ({bad} entries)")
        err = max(err, float((k.double() - p.double()).abs().max())
                  if k.numel() else 0.0)
    return dict(max_abs_err=err, mismatch_share=0.0)


def rebuild_frames(r, n: int):
    """n rebuild-mode frames with CUDA events around each -> (kept
    outputs, frame ms and rebuild ms of all but the first)."""
    kept, ms, build = [], [], []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = r.render_frame()
        end.record()
        torch.cuda.synchronize()
        kept.append({"image": out["image"], "shadow": out["shadow"],
                     "valid": out["valid"]})
        if i > 0:
            ms.append(start.elapsed_time(end))
            build.append(r.stats["build_ms"])
    return kept, ms, build


def build_bound(nbytes: int, ops: int) -> dict:
    bytes_ms = nbytes / HBM_RATE * 1e3
    ops_ms = ops / FP32_PEAK * 1e3
    return dict(bytes=nbytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def time_build(name, args, reps: int = 20) -> dict:
    """Kernel ms (CUDA events) and plain ms (host clock) on the same
    inputs."""
    import tpurt_torch.kernels.build as b
    kfn, pfn = getattr(b, f"{name}_cuda"), getattr(b, f"{name}_reference")
    before = kfn.launches
    ms = cuda_ms(lambda: kfn(*args), reps)
    kfn.launches = before
    _, plain_ms = host_ms(lambda: pfn(*args))
    return dict(ms=ms, plain_ms=plain_ms)


def rebuild_stages(r):
    """_rebuild_fused by hand, stage by stage, on the Renderer's geometry
    -> (the three build kernels' inputs at config 2's shapes: unit
    coordinates of the centroids, the clustered leaf codes' deltas, the
    deferred tree's child array and node areas; {stage: callable that
    reruns it on the intermediates})."""
    from tpurt_torch.bvh import lbvh as L
    from tpurt_torch.bvh import wide as W
    from tpurt_torch.bvh.morton import unit_coords
    from tpurt_torch.kernels.build import collapse_area, morton_codes, \
        topology
    from tpurt_torch.passes.shading import (attr_payload_columns,
                                            leaf_attr_rows_from_sorted)
    m, k, splits = r.mesh, r.config.leaf_size, r._rebuild_splits
    tpad = r.bvh.num_sorted_tris
    tri, v0, e1, e2, cen, smin, smax = L._triangle_data(m.vertices,
                                                        m.indices, tpad)
    cols = L._pad_columns(attr_payload_columns(m, r.device), tpad)
    codes = morton_codes(cen, smin, smax)
    order = torch.arange(tpad, dtype=torch.int32, device=r.device)
    chs, srt = L._sort_payload(codes, [order, v0, e1, e2, tri] + cols)
    sv0, se1, se2 = srt[1:4]
    split = L._subleaf_split(chs, *L._leaf_boxes(sv0, se1, se2, k)[2:], k,
                             splits)
    d = L.adjacent_deltas(split[1]).contiguous()
    bvh = L.build_lbvh(m.vertices, m.indices, leaf_size=k, boxes="defer",
                       split_blocks=splits)
    boxes = W._leaf_boxes_from_tris(bvh)
    tab = L.range_table(*boxes)
    area = W.node_areas(bvh, tab)
    front, src, _ = collapse_area(bvh.nodes_child, area, r._nw_pad)
    stages = {
        "bounds_and_centroids": lambda: L._triangle_data(m.vertices,
                                                         m.indices, tpad),
        "attribute_columns": lambda: attr_payload_columns(m, r.device),
        "morton_kernel": lambda: morton_codes(cen, smin, smax),
        "sort_and_payload_gather": lambda: L._sort_payload(
            codes, [order, v0, e1, e2, tri] + cols),
        "subleaf_split": lambda: L._subleaf_split(
            chs, *L._leaf_boxes(sv0, se1, se2, k)[2:], k, splits),
        "deltas_and_topology_kernel": lambda: topology(
            L.adjacent_deltas(split[1])),
        "root_box": lambda: torch.cat([split[2], -split[3]], 1).amin(0),
        "range_table_and_areas": lambda: W.node_areas(
            bvh, L.range_table(*boxes)),
        "collapse_kernel": lambda: collapse_area(bvh.nodes_child, area,
                                                 r._nw_pad),
        "row_assembly": lambda: (W.assemble_area_rows(
            bvh, boxes, tab, front, src, r._nw_pad), W.block_rows(bvh)),
        "attribute_rows": lambda: leaf_attr_rows_from_sorted(
            srt[5:], srt[0], bvh.num_blocks, k),
    }
    inputs = (unit_coords(cen, smin, smax).contiguous(), d,
              bvh.nodes_child.contiguous(), area)
    return inputs, stages


def phase_config2(dev, mesh, static_image) -> dict:
    """Config 2: the per-frame rebuild at 1080p."""
    import tpurt_torch.kernels.build as B
    from tpurt_torch.app import Renderer
    from tpurt_torch.bvh.lbvh import adjacent_deltas
    from tpurt_torch.kernels.traverse import trace_closest_shadow
    from tpurt_torch.scenes import deform, sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    light = Light.directional(SUN_DIR)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14)
    t0 = time.perf_counter()
    r = Renderer(mesh, cam, light, cfg, mode="rebuild", device=dev)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    if r.route != "fused0" or r.config.order_children:
        raise RuntimeError(f"config 2 takes route {r.route}, ordered "
                           f"{r.config.order_children}")
    nl, nb = r.bvh.num_leaves, r.bvh.num_blocks
    log(f"phase 9 setup: {setup_ms:.1f} ms; blocks={nb} leaves={nl} "
        f"splits={r._rebuild_splits} nw_pad={r._nw_pad} "
        f"wide_depth={r.depth} {json.dumps(r.stats)}")

    # Each build kernel against its plain version, exactly.
    (unit, d, child, area), rebuild_stage = rebuild_stages(r)
    rng = np.random.default_rng(2)
    values = rng.integers(0, 1 << 30, 64)
    synth = torch.from_numpy(np.sort(rng.choice(values, 30_000)).astype(
        np.int32)).to(dev)
    d30k = adjacent_deltas(synth).contiguous()
    count = int(B.collapse_area_reference(child, area, r._nw_pad)[2])
    checks = {
        "morton_codes": [build_pair("morton_codes", (unit,),
                                    "morton codes, config 2")],
        "topology": [build_pair("topology", (d,), "topology, config 2"),
                     build_pair("topology", (d30k,),
                                "topology, 30k leaves of 64 codes")],
        "collapse_area": [
            build_pair("collapse_area", (child, area, r._nw_pad),
                       "collapse, config 2 pad"),
            build_pair("collapse_area", (child, area, count // 2),
                       f"collapse, forced pad {count // 2} < {count}")],
    }
    log(f"phase 9 build kernels vs plain: count={count} "
        f"{json.dumps(checks)}")
    ni = int(child.shape[0])
    levels = max(1, ni.bit_length())
    n = int(unit.shape[0])
    kernels = {
        "morton_codes": dict(args=(unit,), **build_bound(
            n * 12 + n * 4, n * OPS_PER_CODE)),
        "topology": dict(args=(d,), **build_bound(
            ni * 4 + ni * 8 + ni * 8,
            (levels - 1) * ni + 2 * levels * ni
            + OPS_PER_TOPOLOGY_PLACE * (ni + 1))),
        "collapse_area": dict(args=(child, area, r._nw_pad), **build_bound(
            ni * 12 + r._nw_pad * 36 + 4,
            min(count, r._nw_pad) * OPS_PER_WIDE_NODE)),
    }
    for name, kk in kernels.items():
        kk.update(time_build(name, kk.pop("args")))
        kk["checks"] = checks[name]
        kk["max_abs_err"] = max(c["max_abs_err"] for c in checks[name])
        kk["mismatch_share"] = 0.0
        log(f"phase 9 {name}: {json.dumps(kk)}")

    # The whole rebuilt accel, kernels against plain versions; the kernels'
    # rebuild once more under CUDA's sync debug mode, which warns at every
    # call that waits for the card.
    syncs = host_syncs(r._rebuild)
    log(f"phase 9 host syncs in one rebuild: {len(syncs)} {syncs}")
    _, kw, kat, kcnt = r._rebuild()
    with plain_build_kernels():
        _, pw, pat, pcnt = r._rebuild()
    torch.cuda.synchronize()
    pairs = (("nodes", kw.nodes, pw.nodes), ("tris", kw.tris, pw.tris),
             ("tri_id", kw.tri_id, pw.tri_id), ("at0", kat[0], pat[0]),
             ("at1", kat[1], pat[1]), ("count", kcnt, pcnt))
    for what, a, b in pairs:
        if not torch.equal(a, b):
            raise RuntimeError(f"rebuilt accel: {what} differs between the "
                               f"kernels and the plain versions")
    log("phase 9 rebuilt accel: kernels == plain versions "
        "(nodes, tris, tri_id, at0, at1, count)")

    # Config 2 frames through the Renderer.
    (kept, frame_ms, build_ms), n = drive(
        {"closest_shadow": 6, "morton_codes": 6, "topology": 6,
         "collapse_area": 6}, lambda: rebuild_frames(r, 6))
    valid_share = check_image(kept[0], MAIN_W, MAIN_H, "config 2")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("config 2 frames are not bit-identical")
    valid = kept[0]["valid"]
    diff = (kept[0]["image"] - static_image).abs().amax(-1)
    nvalid = int(valid.sum())
    share = float(((diff > 1e-3) & valid).sum()) / nvalid
    exact = float(((diff > 0) & valid).sum()) / nvalid
    if share > 1e-3:
        raise RuntimeError(f"config 2 image differs from config 1's static "
                           f"one on {share:.2e} of valid pixels")
    # Where the rebuild's time goes: CUDA events around each stage (mean
    # of 5 calls, launch overhead included).
    stages = {name: cuda_ms(fn, 5) for name, fn in rebuild_stage.items()}
    stages["sum"] = sum(stages.values())
    hard = kernel_vs_plain("closest_shadow", r, MAIN_W, MAIN_H,
                           "phase 9 closest_shadow on the rebuilt tree",
                           light_dir=light.direction)
    mean_ms = float(np.mean(frame_ms))
    # The frame's stages after the rebuild; their rest excludes it.
    frame_stages = stage_ms(r, lambda acc, o, d: trace_closest_shadow(
        acc, o, d, light.direction, BIAS, attr_tables=r.attr_tables),
        mean_ms - float(np.mean(build_ms)))
    res = dict(launches=n, frame_ms=frame_ms, frame_ms_mean=mean_ms,
               build_ms=build_ms, build_ms_mean=float(np.mean(build_ms)),
               rebuild_stages_ms=stages, frame_stages_ms=frame_stages,
               closest_shadow=hard,
               valid_share=valid_share,
               vs_static_share=share, vs_static_any_bit_share=exact,
               occluded_share=float((kept[0]["shadow"][0][valid] < 1.0)
                                    .float().mean()),
               nw_pad=r._nw_pad, wide_count=count, wide_depth=r.depth,
               rebuild_host_syncs=len(syncs),
               blocks=nb, leaves=nl, splits=r._rebuild_splits,
               setup_ms=setup_ms, setup=dict(r.stats),
               kernels={k: {kk: vv for kk, vv in v.items()
                            if kk != "checks"}
                        for k, v in kernels.items()},
               **rays_per_s(MAIN_W * MAIN_H, nvalid, nvalid, mean_ms))
    log(f"phase 9 config 2: {json.dumps(res)}")

    # Five animated frames.
    anim = []
    for step in range(1, 6):
        r.set_vertices(deform(mesh, 0.2 * step))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = r.render_frame()
        end.record()
        torch.cuda.synchronize()
        check_image(out, MAIN_W, MAIN_H, f"config 2 animated frame {step}")
        anim.append(dict(frame_ms=start.elapsed_time(end),
                         build_ms=r.stats["build_ms"], nw_pad=r._nw_pad))
    res["animated"] = dict(frames=anim, overflow_recoveries=int(
        r.stats["overflow_recoveries"]))
    # The recovery on the card: a pad forced below the count, one more
    # animated frame.
    before = r.stats["overflow_recoveries"]
    r._nw_pad = count // 2
    r.set_vertices(deform(mesh, 1.2))
    out, ms = host_ms(r.render_frame)
    check_image(out, MAIN_W, MAIN_H, "config 2 frame after a forced overflow")
    if r.stats["overflow_recoveries"] != before + 1:
        raise RuntimeError("the forced overflow was not recovered")
    res["animated"]["forced_overflow"] = dict(
        pad=count // 2, new_pad=r._nw_pad, frame_host_ms=ms)
    log(f"phase 9 animated: {json.dumps(res['animated'])}")
    return res


# ---------------------------------------------------------------------------
# Phase 10: the raster G-buffer
# ---------------------------------------------------------------------------

RASTER_TPU = "tpurt/kernels/raster.py:217"
# Float32 operations of the rasterizer per (record, pixel) test: three
# edge values (2 mul, 2 add each), the d-sum (2 add), the two-sided
# coverage test (6 compares, 5 logic), 1/w (1 mul), the z-test and its
# gates (2 compares, 2 logic); and where the record takes the pixel, the
# d-weighted normal (3 x (3 mul, 2 add)) and 14 state writes.
OPS_PER_TEST = 30
OPS_PER_TAKE = 29


def raster_compare(kres, pres, what: str) -> dict:
    """The rasterizer against its plain version on the same bins: ids, u,
    v and 1/w equal, every other channel within 1e-6."""
    (kt, ka), (pt, pa) = kres, pres
    if not torch.equal(kt, pt):
        raise RuntimeError(f"{what}: tri_id differs on "
                           f"{int((kt != pt).sum())} pixels")
    if not torch.equal(ka[0:3], pa[0:3]):
        raise RuntimeError(f"{what}: u, v or 1/w differ by up to "
                           f"{float((ka[0:3] - pa[0:3]).abs().max())}")
    err = float((ka - pa).abs().max())
    if err > 1e-6:
        raise RuntimeError(f"{what}: channels differ by {err}")
    return dict(valid=int((kt >= 0).sum()), max_abs_err=err,
                mismatch_share=0.0)


def profile_device(fn, top: int = 8) -> dict:
    """One call of fn under torch.profiler (CPU and CUDA activity): the
    host milliseconds around it (synchronised, the profiler's overhead
    included), the kernels' summed device time, their launches, the idle
    share of the card over the call, and the kernels that took the most
    device time. kernel_ms 0 means the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    by_time = sorted(kernels, key=lambda e: -e.self_device_time_total)
    return dict(host_ms=wall, kernel_ms=busy,
                launches=sum(e.count for e in kernels),
                idle_share=1.0 - busy / wall if busy else None,
                top=[[e.key[:72], e.count, e.self_device_time_total / 1e3]
                     for e in by_time[:top]])


def bins_stats(bins) -> dict:
    """The binning's load: pair rows, big rows and pair rows per tile."""
    counts = bins.row_counts.double()
    q = torch.quantile(counts, torch.tensor(
        [0.5, 0.9, 0.99], dtype=torch.float64, device=counts.device))
    return dict(cap_rows=int(bins.pair_rows.shape[0]),
                pair_rows=int(counts.sum()), big_nrows=int(bins.big_nrows),
                tiles=int(counts.numel()),
                empty_tiles=int((counts == 0).sum()),
                rows_per_tile=dict(zip(("mean", "median", "p90", "p99", "max"),
                                       [float(counts.mean()), *q.tolist(),
                                        float(counts.max())])),
                overflow=bool(bins.overflow))


def phase_raster(dev, mesh, c1) -> dict:
    """The raster G-buffer at 1080p; c1: phase 4's image, valid mask and
    Renderer."""
    import tpurt_torch.kernels.raster as R
    from tpurt_torch.app import (Renderer, composite_lights, frame_seed,
                                 shadow_production)
    from tpurt_torch.passes.gbuffer import gbuffer_raster_pass
    from tpurt_torch.raster.setup import bin_rows, default_cap_rows
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    w, h = MAIN_W, MAIN_H
    cam = sponza_interior_camera()
    light = Light.directional(SUN_DIR)
    cfg = RenderConfig(width=w, height=h, leaf_size=14, gbuffer="raster")
    r = Renderer(mesh, cam, light, cfg, device=dev)
    if r.route != "unfused" or r.attr_tables is not None:
        raise RuntimeError(f"raster frame: route {r.route}, attribute rows "
                           f"{r.attr_tables is not None}")
    (kept, frame_ms), n = drive({"rasterize_rows": 6, "any": 6},
                                lambda: frames(r, 6))
    valid_share = check_image(kept[0], w, h, "raster")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("raster frames are not bit-identical")
    valid = kept[0]["valid"]
    coverage = float((valid != c1["valid"]).float().mean())
    diff = (kept[0]["image"] - c1["image"]).abs().amax(-1)
    image_share = float((diff > 2e-2).float().mean())
    if coverage >= 0.002 or image_share >= 0.01:
        raise RuntimeError(f"raster frame against the ray-cast one: "
                           f"coverage differs on {coverage:.2e}, the image "
                           f"on {image_share:.2e} of pixels")
    mean_ms = float(np.mean(frame_ms))
    res = dict(launches=n, frame_ms=frame_ms, frame_ms_mean=mean_ms,
               valid_share=valid_share, vs_ray_coverage_share=coverage,
               vs_ray_image_share=image_share,
               occluded_share=float((kept[0]["shadow"][0][valid] < 1.0)
                                    .float().mean()),
               setup=dict(r.stats))
    log(f"phase 10 raster frames: {json.dumps(res)}")

    # The kernel against its plain version on the frame's bins.
    cap = default_cap_rows(mesh.num_triangles)
    bins = bin_rows(cam, r.mesh, w, h, cap)
    syncs = host_syncs(lambda: bin_rows(cam, r.mesh, w, h, cap))
    if syncs:
        raise RuntimeError(f"bin_rows waited for the card: {syncs}")
    res["bins"] = bins_stats(bins)
    res["bin_rows_host_syncs"] = len(syncs)
    log(f"phase 10 bins: {json.dumps(res['bins'])}")
    before = R.rasterize_rows_cuda.launches
    kres = R.rasterize_rows_cuda(bins, w, h)
    torch.cuda.synchronize()
    if R.rasterize_rows_cuda.launches != before + 1:
        raise RuntimeError("rasterize_rows: launch counter did not grow")
    ms = cuda_ms(lambda: R.rasterize_rows_cuda(bins, w, h), 20)
    R.rasterize_rows_cuda.launches = before
    stats = {}
    pres, plain_ms = host_ms(lambda: R.rasterize_rows_reference(
        bins, w, h, stats=stats))
    cmp = raster_compare(kres, pres, "phase 10 rasterizer, whole frame")
    ntiles = int(bins.row_starts.numel())
    nbytes = ((res["bins"]["pair_rows"] + res["bins"]["big_nrows"] * ntiles)
              * 512 + 2 * ntiles * 4 + 13 * w * h * 4)
    ops = OPS_PER_TEST * stats["record_tests"] + OPS_PER_TAKE * stats["takes"]
    res["kernel"] = dict(ms=ms, plain_ms=plain_ms, compare=cmp,
                         max_abs_err=cmp["max_abs_err"], mismatch_share=0.0,
                         **stats, **build_bound(nbytes, ops))
    log(f"phase 10 rasterizer: {json.dumps(res['kernel'])}")

    # Where the frame's time goes (mean of 5 calls per stage).
    seed = frame_seed(cfg.seed, 0)
    gbuf = gbuffer_raster_pass(r.mesh, cam, w, h)
    vis = shadow_production(r.accel, gbuf, light, seed, 0, r.config)[0]
    st = {"binning": cuda_ms(lambda: bin_rows(cam, r.mesh, w, h, cap), 5),
          "raster_kernel": cuda_ms(lambda: R.rasterize_rows_cuda(bins, w, h),
                                   5),
          "gbuffer_pass": cuda_ms(lambda: gbuffer_raster_pass(r.mesh, cam, w,
                                                              h), 5),
          "shadow_pass_light0": cuda_ms(lambda: shadow_production(
              r.accel, gbuf, light, seed, 0, r.config), 5),
          "composite": cuda_ms(lambda: composite_lights(
              gbuf, [vis], [light], r.config), 5)}
    st["decode"] = st["gbuffer_pass"] - st["binning"] - st["raster_kernel"]
    st["counter_read_rest"] = mean_ms - st["gbuffer_pass"] \
        - st["shadow_pass_light0"] - st["composite"]
    res["stages_ms"] = st
    turns = in_turns(c1["renderer"], r)
    res["in_turns_ms"] = {"ray": turns["a"], "raster": turns["b"]}
    log(f"phase 10 stages: {json.dumps(st)}; in turns "
        f"{json.dumps(res['in_turns_ms'])}")
    res["profile"] = {"binning": profile_device(
        lambda: bin_rows(cam, r.mesh, w, h, cap)),
        "raster_frame": profile_device(r.render_frame)}
    log(f"phase 10 profile: {json.dumps(res['profile'])}")

    # The "auto" paths that take the rasterizer on the card.
    def against_raster(img, v):
        d = (img - kept[0]["image"]).abs().amax(-1)
        return float(((d > 1e-3) & v).sum()) / int(v.sum())
    r2 = Renderer(mesh, cam, light, RenderConfig(
        width=w, height=h, leaf_size=14, sah=False), device=dev)
    if r2.config.gbuffer != "raster":
        raise RuntimeError("sah=False with gbuffer='auto' took the ray cast")
    (k2, ms2), n2 = drive({"rasterize_rows": 3, "any": 3},
                          lambda: frames(r2, 3))
    share2 = against_raster(k2[0]["image"], k2[0]["valid"])
    if share2 > 1e-3:
        raise RuntimeError(f"sah=False raster frame differs on {share2:.2e}")
    res["sah_false_auto"] = dict(launches=n2, frame_ms=ms2,
                                 vs_raster_share=share2, setup=r2.stats)
    rb = Renderer(mesh, cam, light, RenderConfig(
        width=w, height=h, leaf_size=14, rebuild_splits=0), mode="rebuild",
        device=dev)
    if rb.config.gbuffer != "raster" or rb.attr_tables is not None:
        raise RuntimeError("rebuild_splits=0 with gbuffer='auto' did not "
                           "take the rasterizer without attribute rows")
    (k3, ms3, build3), n3 = drive(
        {"rasterize_rows": 6, "any": 6, "morton_codes": 6, "topology": 6,
         "collapse_area": 6}, lambda: rebuild_frames(rb, 6))
    for f in k3[1:]:
        if not torch.equal(f["image"], k3[0]["image"]):
            raise RuntimeError("raster rebuild frames are not bit-identical")
    share3 = against_raster(k3[0]["image"], k3[0]["valid"])
    if share3 > 1e-3:
        raise RuntimeError(f"raster rebuild frame differs on {share3:.2e}")
    res["rebuild_plain_morton"] = dict(
        launches=n3, frame_ms=ms3, frame_ms_mean=float(np.mean(ms3)),
        build_ms=build3, build_ms_mean=float(np.mean(build3)),
        vs_raster_share=share3, nw_pad=rb._nw_pad, wide_depth=rb.depth,
        setup=dict(rb.stats))
    log(f"phase 10 auto paths: sah=False {json.dumps(res['sah_false_auto'])}"
        f"; rebuild {json.dumps(res['rebuild_plain_morton'])}")

    # A pair capacity too small for the view must be grown.
    r.config = dataclasses.replace(r.config, raster_cap_pairs=4096)
    grown = r.stats["raster_cap_growths"]
    out, host = host_ms(r.render_frame)
    if r.stats["raster_cap_growths"] != grown + 1 or \
            not torch.equal(out["image"], kept[0]["image"]):
        raise RuntimeError("the forced pair capacity was not recovered")
    res["forced_cap"] = dict(cap=4096, new_cap=r.config.raster_cap_pairs,
                             frame_host_ms=host)
    log(f"phase 10 forced capacity: {json.dumps(res['forced_cap'])}")
    return res


def build_kernel_row(name, launches_, kp) -> dict:
    return {"name": name, "route": "cuda", "source": CSRC + "build.cu",
            "replaces": f"{BUILD_TPU}{BUILD_KERNEL_LINES[name]}",
            "launches": launches_, "max_abs_err": kp["max_abs_err"],
            "mismatch_share": kp["mismatch_share"], "ms": kp["ms"],
            "plain_ms": kp["plain_ms"], "bound_ms": kp["bound_ms"],
            "bound_by": kp["bound_by"], "library_ms": None}


def kernel_row(name, launches_, kp, small) -> dict:
    src, line = KERNELS[name]
    checks = [kp] + [v for k, v in small.items()
                     if k == name or k.startswith(name + "/")]
    return {"name": name, "route": "cuda", "source": CSRC + src,
            "replaces": f"{TPU}{line}", "launches": launches_,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "mismatch_share": max(c["mismatch_share"] for c in checks),
            "ms": kp["ms"], "plain_ms": kp["plain_ms"],
            "bound_ms": kp["bound_ms"], "bound_by": kp["bound_by"],
            "library_ms": None, "closest_tris": kp["closest_tris"],
            "anyhit_tris": kp["anyhit_tris"]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; the port's "
                         "smoke runs only on a GPU")
    from tpurt_torch.kernels._build import BuildInfo, load_library
    from tpurt_torch.scenes import sponza_scene
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}; "
        f"cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    load_library()
    build_s = time.perf_counter() - t0
    log(f"phase 2: kernel library built in {build_s:.2f} s "
        f"(nvcc {BuildInfo.seconds:.2f} s) -> {BuildInfo.path}")
    for line in BuildInfo.log.splitlines():
        if ("registers" in line or "spill" in line or "stack frame" in line
                or "Compiling entry" in line):
            log(f"  ptxas: {line.strip()}")

    t_start = time.perf_counter()
    small = phase_small(dev)
    mesh = sponza_scene(MAIN_TRIS)
    c1 = phase_config1(dev, mesh)
    c3 = phase_config3(dev, mesh)
    c5 = phase_config5(dev, mesh)
    variants = phase_soft_variants(dev, mesh)
    phase4 = {k: c1.pop(k) for k in ("image", "valid", "renderer")}
    static_image = phase4["image"]
    unf = phase_unfused(dev, mesh, static_image)
    c2 = phase_config2(dev, mesh, static_image)
    ras = phase_raster(dev, mesh, phase4)
    timings = {"card": card, "build_s": build_s,
               "phases_s": time.perf_counter() - t_start,
               "teapot_512": small, "config1_1080p": c1,
               "config3_1080p": c3, "config5_2160p": c5,
               "soft_variants_1080p": variants, "unfused_1080p": unf,
               "config2_1080p": c2, "raster_1080p": ras}
    rows = [kernel_row("closest_shadow", c1["launches"], c1["kernel"],
                       small),
            kernel_row("closest_multi_shadow", c5["launches"], c5["kernel"],
                       small),
            kernel_row("closest_soft_shadow", c3["launches"], c3["kernel"],
                       small)]
    rows += [kernel_row(name, v["launches"], v["kernel"], small)
             for name, v in variants.items()]
    for label, name in (("config1_unfused", "closest_attrs"),
                        ("config1_unfused", "any"),
                        ("config3_unfused", "any_soft"),
                        ("lamp_unfused", "any_point_soft")):
        rows.append(kernel_row(name, unf[label]["launches"][name],
                               unf[label]["kernels"][name], small))
    rows += [build_kernel_row(name, c2["launches"][name], kp)
             for name, kp in c2["kernels"].items()]
    kp = ras["kernel"]
    rows.append({"name": "rasterize_rows", "route": "cuda",
                 "source": CSRC + "raster.cu", "replaces": RASTER_TPU,
                 "launches": ras["launches"]["rasterize_rows"],
                 "max_abs_err": kp["max_abs_err"],
                 "mismatch_share": kp["mismatch_share"], "ms": kp["ms"],
                 "plain_ms": kp["plain_ms"], "bound_ms": kp["bound_ms"],
                 "bound_by": kp["bound_by"], "library_ms": None})
    log(json.dumps({"timings": timings}))
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
