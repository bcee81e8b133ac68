"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases (one card)

Phases, in order; any failure raises and the exit code is not 0:

1. Device check: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. There is no CPU path.
2. Build the CUDA kernel library (csrc/fused_shadows.cu, one template
   with a mode per kernel) with one nvcc call, and print ptxas's register
   and spill report.
3. Every kernel against its plain PyTorch version on the card: teapot
   scene, 10k triangles, 512x512, leaf 14. closest_shadow with a
   directional and a point light; multi with directional + point +
   directional; soft with a 4 deg sun at spp 8; point-soft with radius 0.4
   at spp 8; soft-multi with a cone + two directional lights and with a
   disk + one directional light. The sampling kernels run once with the
   real generator and once with the zero stream; with the zero stream
   their counts must be spp x closest_shadow's hard occlusion along the
   axis or toward the centre.
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
8. Timings on one JSON line, then the kernel table on one JSON line, the
   card's nvidia-smi line, and last {"ok": true, "device": {...}}.

Tolerances of the kernel-vs-plain checks: valid masks equal; t to rtol
1e-6 / atol 1e-6; tri_id equal on >= 99.9% of valid pixels and every
other attribute channel within 1e-6 where it is; occlusion, each bit of a
mask and counts differ on at most 1e-3 of valid pixels. Both are built
without fused multiply-adds and draw the same random bits, so they agree
bit for bit except where float rounding of division or sqrt could differ.

The kernel table's bound_ms is the larger of two floors computed from this
run's inputs: bytes (every input and output tensor once) over 3.35 TB/s,
and float32 operations over 67 TFLOP/s. The operations are those the
kernel performs, counted by the plain version's walks on the same inputs:
per node pop 8 empty-slot compares, 25 per slab test of a non-empty child
box, and 56 per triangle test, where the closest walk tests every
triangle of a leaf it visits and an any-hit walk stops at the first
occluder. Ray set-up, sampling and integer work are not counted.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
}

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


def reset_launches():
    from tpurt_torch.kernels.traverse import CUDA_KERNELS
    for fn in CUDA_KERNELS:
        fn.launches = 0


def launches() -> dict:
    from tpurt_torch.kernels.traverse import CUDA_KERNELS
    return {fn.__name__[:-len("_cuda")]: fn.launches for fn in CUDA_KERNELS}


def drive(name, fn, expect: int):
    """Run one main path with every launch counter at 0 just before it;
    fail unless ``name``'s kernel launched ``expect`` times and no other
    kernel launched. Returns (fn's result, the launch count)."""
    reset_launches()
    res = fn()
    torch.cuda.synchronize()
    got = launches()
    want = {k: (expect if k == name else 0) for k in got}
    if got != want:
        raise RuntimeError(f"{name} main path launches {got}, want {want}")
    return res, got[name]


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
    mism = max(shares)
    if mism > 1e-3:
        raise RuntimeError(f"{what}: shadow outputs differ on {mism:.2e} "
                           f"of valid rays ({shares})")
    max_abs = max(float((kt - pt).abs().max()), attr_err)
    return dict(valid=nvalid, tri_id_equal=tri_frac, mismatch_share=mism,
                mismatch_shares=shares, max_abs_err=max_abs)


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
    res = compare(kres, pres, what, outputs_of(name, kw))
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
    cmp = compare(kres, pres, f"{name} whole block", outputs_of(name, kw))
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
    8th row of it."""
    from tpurt_torch.bvh.wide import order_children_for_point
    from tpurt_torch.camera import generate_rays
    acc = order_children_for_point(r.accel, r.camera.position)
    o, d = generate_rays(r.camera, w, h, r.device)
    full = inputs(name, acc, r.attr_tables, o, d, **spec)
    sub = inputs(name, acc, r.attr_tables, o[::8].contiguous(),
                 d[::8].contiguous(), **spec)
    return full, sub


def kernel_vs_plain(name, r, w, h, what, **spec) -> dict:
    (args, kw), (sargs, skw) = frame_inputs(name, r, w, h, **spec)
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
    (kept, frame_ms), n = drive("closest_shadow", lambda: frames(r, 6), 6)
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
    return dict(launches=n, frame_ms=frame_ms, frame_ms_mean=mean_ms,
                kernel=kp, stages_ms=stages, valid_share=valid_share,
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
    (kept, frame_ms), n = drive("closest_soft_shadow",
                                lambda: frames(r, 6), 6)
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
    return dict(launches=n, frame_ms=frame_ms, frame_ms_mean=mean_ms,
                kernel=kp, stages_ms=stages, penumbra_share=penumbra,
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
    (kept, frame_ms), n = drive("closest_multi_shadow",
                                lambda: frames(r, 6), 6)
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
    return dict(launches=n, frame_ms=frame_ms, frame_ms_mean=mean_ms,
                kernel=kp, stages_ms=stages, occluded_shares=shares,
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
        (kept, frame_ms), n = drive(name, lambda: frames(r, 2), 2)
        for f in kept:
            check_image(f, MAIN_W, MAIN_H, name)
        valid = kept[0]["valid"]
        vis = kept[0]["shadow"][0][valid]
        penumbra = float(((vis > 0) & (vis < 1)).float().mean())
        if not penumbra > 0:
            raise RuntimeError(f"{name}: no penumbra")
        kp = kernel_vs_plain(name, r, MAIN_W, MAIN_H, f"phase 7 {name}",
                             **spec)
        out[name] = dict(launches=n, frame_ms=frame_ms, kernel=kp,
                         penumbra_share=penumbra,
                         occluded_shares=[float((s[valid] < 1).float()
                                                .mean())
                                          for s in kept[0]["shadow"]])
    return out


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
    timings = {"card": card, "build_s": build_s,
               "phases_s": time.perf_counter() - t_start,
               "teapot_512": small, "config1_1080p": c1,
               "config3_1080p": c3, "config5_2160p": c5,
               "soft_variants_1080p": variants}
    rows = [kernel_row("closest_shadow", c1["launches"], c1["kernel"],
                       small),
            kernel_row("closest_multi_shadow", c5["launches"], c5["kernel"],
                       small),
            kernel_row("closest_soft_shadow", c3["launches"], c3["kernel"],
                       small)]
    rows += [kernel_row(name, v["launches"], v["kernel"], small)
             for name, v in variants.items()]
    log(json.dumps({"timings": timings}))
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
