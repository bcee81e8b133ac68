"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases (one card)

Phases, in order; any failure raises and the exit code is not 0:

1. Device check: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. There is no CPU path.
2. Build the CUDA kernel library with nvcc (seconds and ptxas report).
3. The kernel against its plain PyTorch version on the card: teapot scene,
   10k triangles, 512x512, leaf 14, a directional and a point light.
4. The main path at full size: Sponza-class hall, 260k triangles,
   1920x1080, leaf 14, one directional light, through Renderer(device=
   "cuda"): one warm-up frame and five timed frames, checked for finite
   values, coverage, shadow share and bit-identical repeats; then the
   kernel against its plain version on every 8th row of the same frame
   and on the whole frame (the kernel table's times are the whole
   frame's).
5. Timings on one JSON line, then the kernel table on one JSON line, the
   card's nvidia-smi line, and last {"ok": true, "device": {...}}.

Tolerances of the kernel-vs-plain checks: valid masks equal; t to rtol
1e-6 / atol 1e-6; tri_id equal on >= 99.9% of valid pixels and every
other attribute channel within 1e-6 where it is; occlusion mismatches at
most 1e-3 of valid pixels. Both are built without fused multiply-adds, so
they agree bit for bit except where float rounding of division or sqrt
could differ.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SRC = "tpurt_torch/kernels/csrc/closest_shadow.cu"
# The main path's size: the bench headline's scene and resolution.
MAIN_TRIS = 260_000
MAIN_W, MAIN_H = 1920, 1080
# Config 1's size for the kernel-vs-plain check.
SMALL_TRIS = 10_000
SMALL_RES = 512
REPLACES = "tpurt/kernels/traverse.py:1450"


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


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


def compare(kernel_res, plain_res, what: str) -> dict:
    """Hold the kernel's (out, occ, counts) against the plain version's."""
    (ko, kocc, kc), (po, pocc, pc) = kernel_res, plain_res
    kc, pc = kc.tolist(), pc.tolist()
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
    occ_mism = int(((kocc != pocc) & valid).sum())
    if occ_mism > 1e-3 * nvalid:
        raise RuntimeError(f"{what}: {occ_mism} occlusion mismatches of "
                           f"{nvalid} valid rays")
    max_abs = max(float((kt - pt).abs().max()), attr_err)
    return dict(valid=nvalid, tri_id_equal=tri_frac, occ_mismatch=occ_mism,
                max_abs_err=max_abs)


def kernel_inputs(wide, attr_tables, origins, dirs, light):
    """The kernel's arguments for these rays, as the frame packs them."""
    from tpurt_torch.kernels.traverse import closest_shadow_inputs
    from tpurt_torch.types import LIGHT_POINT
    lpos = light.position if light.kind == LIGHT_POINT else None
    args, kw, _, _ = closest_shadow_inputs(
        wide, origins, dirs, light.direction, 1e-3, attr_tables,
        light_pos=lpos)
    return args, kw


def phase_small(dev) -> dict:
    """Kernel vs plain at config-1 scale (teapot 10k, 512x512, leaf 14)."""
    from tpurt_torch.app import Renderer
    from tpurt_torch.bvh.wide import order_children_for_point
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.kernels.traverse import (closest_shadow_cuda,
                                              closest_shadow_reference)
    from tpurt_torch.scenes import default_camera_for, teapot_scene
    from tpurt_torch.types import Light, RenderConfig
    mesh = teapot_scene(SMALL_TRIS)
    cam = default_camera_for(mesh)
    bmin, bmax = mesh.bounds()
    lights = {"directional": Light.directional((0.45, 0.8, 0.3)),
              "point": Light.point(0.5 * (bmin + bmax)
                                   + np.float32([2.0, 6.0, 1.0]))}
    r = Renderer(mesh, cam, lights["directional"],
                 RenderConfig(width=SMALL_RES, height=SMALL_RES, leaf_size=14),
                 device=dev)
    acc = order_children_for_point(r.accel, cam.position)
    o, d = generate_rays(cam, SMALL_RES, SMALL_RES, dev)
    out = {}
    for kind, light in lights.items():
        args, kw = kernel_inputs(acc, r.attr_tables, o, d, light)
        before = closest_shadow_cuda.launches
        kres = closest_shadow_cuda(*args, **kw)
        torch.cuda.synchronize()
        if closest_shadow_cuda.launches != before + 1:
            raise RuntimeError("launch counter did not grow")
        t0 = time.perf_counter()
        pres = closest_shadow_reference(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        res = compare(kres, pres, f"512^2 {kind}")
        res["kernel_ms"] = cuda_ms(lambda: closest_shadow_cuda(*args, **kw),
                                   20)
        res["plain_ms"] = plain_ms
        res["occluded_share"] = float(
            kres[1].bool().reshape(-1)[(kres[0][:, 1] >= 0).reshape(-1)]
            .float().mean())
        res["wide_depth"] = r.depth
        out[kind] = res
        log(f"phase 3 {kind}: {json.dumps(res)}")
    return out


def phase_main(dev) -> dict:
    """The main path at Sponza-class 260k triangles, 1920x1080."""
    from tpurt_torch.app import Renderer
    from tpurt_torch.bvh.wide import order_children_for_point
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.kernels.traverse import (closest_shadow_cuda,
                                              closest_shadow_reference)
    from tpurt_torch.scenes import sponza_interior_camera, sponza_scene
    from tpurt_torch.types import Light, RenderConfig
    mesh = sponza_scene(MAIN_TRIS)
    cam = sponza_interior_camera()
    light = Light.directional((0.25, 0.9, 0.2))
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14)
    r = Renderer(mesh, cam, light, cfg, device=dev)
    log(f"phase 4 setup: tris={mesh.num_triangles} "
        f"wide_rows={r.accel.num_wide} depth={r.depth} {json.dumps(r.stats)}")

    torch.cuda.reset_peak_memory_stats()
    closest_shadow_cuda.launches = 0
    frames, frame_ms = [], []
    for i in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = r.render_frame()
        end.record()
        torch.cuda.synchronize()
        frames.append(out)
        if i > 0:
            frame_ms.append(start.elapsed_time(end))
    launches = closest_shadow_cuda.launches
    if launches < 6:
        raise RuntimeError(f"main path launched the kernel {launches} times")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    img = frames[0]["image"]
    if tuple(img.shape) != (MAIN_H, MAIN_W, 3) or not bool(
            torch.isfinite(img).all()):
        raise RuntimeError("image is not finite f32[H, W, 3]")
    valid = frames[0]["valid"]
    valid_share = float(valid.float().mean())
    occ_share = float((frames[0]["shadow"][0][valid] < 1.0).float().mean())
    if not valid_share > 0.5:
        raise RuntimeError(f"only {valid_share:.3f} of pixels are valid")
    if not 0.0 < occ_share < 1.0:
        raise RuntimeError(f"occluded share {occ_share} not in (0, 1)")
    for f in frames[1:]:
        if not torch.equal(f["image"], img):
            raise RuntimeError("frames are not bit-identical")

    acc = order_children_for_point(r.accel, cam.position)
    o, d = generate_rays(cam, MAIN_W, MAIN_H, dev)
    args, kw = kernel_inputs(acc, r.attr_tables, o, d, light)
    kernel_ms = cuda_ms(lambda: closest_shadow_cuda(*args, **kw), 10)
    sargs, skw = kernel_inputs(acc, r.attr_tables, o[::8].contiguous(),
                               d[::8].contiguous(), light)
    kres = closest_shadow_cuda(*sargs, **skw)
    sub_kernel_ms = cuda_ms(lambda: closest_shadow_cuda(*sargs, **skw), 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pres = closest_shadow_reference(*sargs, **skw)
    torch.cuda.synchronize()
    sub_plain_ms = (time.perf_counter() - t0) * 1e3
    cmp = compare(kres, pres, "1080p every 8th row")
    log(f"phase 4 subsample: {json.dumps(cmp)}")
    # The same comparison on the whole frame's ray block: the kernel's
    # and the plain version's times at the shape the main path launches.
    kres = closest_shadow_cuda(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pres = closest_shadow_reference(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    full = compare(kres, pres, "1080p full frame")
    log(f"phase 4 full frame: {json.dumps(full)}")

    mean_ms = float(np.mean(frame_ms))
    npix = cfg.width * cfg.height
    nvalid = int(valid.sum())
    return dict(
        launches=launches, frame_ms=frame_ms, frame_ms_mean=mean_ms,
        kernel_ms_1080p=kernel_ms, plain_ms_1080p=plain_ms,
        kernel_ms_subsample=sub_kernel_ms, plain_ms_subsample=sub_plain_ms,
        subsample_rays=int(o[::8].shape[0]) * MAIN_W,
        max_abs_err=max(cmp["max_abs_err"], full["max_abs_err"]),
        valid_share=valid_share,
        occluded_share=occ_share, peak_mem_mb=peak_mb,
        primary_rays_per_s=npix / (mean_ms / 1e3),
        shadow_rays_per_s=nvalid / (mean_ms / 1e3),
        primary_plus_shadow_rays_per_s=(npix + nvalid) / (mean_ms / 1e3),
        sah_build_ms=r.stats["sah_build_ms"],
        collapse_ms=r.stats["collapse_ms"],
        attr_rows_ms=r.stats["attr_rows_ms"], wide_depth=r.depth,
        tris=mesh.num_triangles)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; the port's "
                         "smoke runs only on a GPU")
    from tpurt_torch.kernels._build import BuildInfo, load_library
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
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"  ptxas: {line.strip()}")

    small = phase_small(dev)
    main_res = phase_main(dev)
    timings = {"card": card, "build_s": build_s, "teapot_512": small,
               "sponza_1080p": main_res}
    kernels_row = {
        "name": "closest_shadow", "route": "cuda", "source": SRC,
        "replaces": REPLACES, "launches": main_res["launches"],
        "max_abs_err": max([main_res["max_abs_err"]]
                           + [v["max_abs_err"] for v in small.values()]),
        "ms": main_res["kernel_ms_1080p"],
        "plain_ms": main_res["plain_ms_1080p"]}
    log(json.dumps({"timings": timings}))
    log(json.dumps({"kernels": [kernels_row]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
