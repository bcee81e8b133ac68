"""Time the port's point-light penumbra kernels of one source tree at the
1080p hall lamp (the Sponza-class hall, a point light of radius 0.5 at
(2, 9, 0.5), spp 8, leaf 14): ANY_PSOFT and PSOFT attrs=0, 1 and 2 over 20
launches each (CUDA events, after one warm-up), HARD and ANY_SOFT (a 2 deg
sun, spp 8) as controls, five fused and five unfused lamp frames, and the
SHA-256 of the lamp frames' images and of every timed kernel's outputs.
Prints one JSON line.

    python3 probes/port_turns_psoft.py ROOT     # ROOT: a checkout of the repo

Run it in turns for two trees on one card (parent, change, change,
parent), each in a process of its own, so that both see the same card and
host; every tree builds its own kernel library under ROOT/build/ (ptxas's
registers and spills of the penumbra entries are printed for a tree's
first run, which builds it). The hashes must agree between the trees:
the kernels compute the same counts.
"""

import hashlib
import json
import os
import subprocess
import sys

# The tree under test first; this checkout's root last, for chip_smoke.
sys.path.insert(0, sys.argv[1])
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import tpurt_torch.kernels.traverse as tr  # noqa: E402
from tpurt_torch.app import (Renderer, _gb_accel, frame_seed,  # noqa: E402
                             gbuffer_production)
from tpurt_torch.camera import generate_rays  # noqa: E402
from tpurt_torch.kernels._build import BuildInfo, load_library  # noqa: E402
from tpurt_torch.passes.shadow import cone_cos  # noqa: E402
from tpurt_torch.scenes import (sponza_interior_camera,  # noqa: E402
                                sponza_scene)
from tpurt_torch.types import Light, RenderConfig  # noqa: E402
from chip_smoke import ptxas_report  # noqa: E402

W, H, SPP, BIAS = 1920, 1080, 8, 1e-3
LAMP_POS, LAMP_RADIUS = (2.0, 9.0, 0.5), 0.5
SUN_DIR = (0.25, 0.9, 0.2)


def cuda_ms(fn, reps: int = 20) -> float:
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


def sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def frames(r, n: int = 5):
    """One warm-up, then n frames with CUDA events -> (ms, last output)."""
    out = r.render_frame()
    ms = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = r.render_frame()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms, out


# The penumbra modes' kernel entries (this design's and the thread-per-ray
# template instantiations before it) and the controls HARD attrs=1 and
# ANY_SOFT, by ptxas's mangled names.
PTXAS_ENTRIES = ("psoft_kernel", "fused_shadows_kernelILi3E",
                 "shadow_rays_kernelILi2E", "fused_shadows_kernelILi0ELi1E",
                 "shadow_rays_kernelILi1E")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("port_turns_psoft: CUDA is not available")
    load_library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    mesh = sponza_scene(260_000)
    cam = sponza_interior_camera()
    lamp = Light.point(LAMP_POS, radius=LAMP_RADIUS)
    cfg = RenderConfig(width=W, height=H, leaf_size=14, spp=SPP)
    r = Renderer(mesh, cam, [lamp], cfg, device="cuda")
    ru = Renderer(mesh, cam, [lamp],
                  RenderConfig(width=W, height=H, leaf_size=14, spp=SPP,
                               fused_shadow=False), device="cuda")
    seed = frame_seed(cfg.seed, 0)
    acc = _gb_accel(r.accel, cam, cfg)
    o, d = generate_rays(cam, W, H, r.device)
    calls = {}
    for name, tables in (("closest_point_soft_shadow", r.attr_tables),
                         ("closest_point_soft_shadow_st", None),
                         ("closest_point_soft_shadow_tex", r.attr_tables)):
        args, kw = tr.closest_point_soft_shadow_inputs(
            acc, o, d, lamp.position, LAMP_RADIUS, SPP, seed, BIAS,
            tables)[:2]
        calls[name] = (getattr(tr, f"{name}_cuda"), args, kw)
    args, kw = tr.closest_shadow_inputs(acc, o, d, np.float32(SUN_DIR), BIAS,
                                        r.attr_tables)[:2]
    calls["closest_shadow"] = (tr.closest_shadow_cuda, args, kw)
    gbuf, _ = gbuffer_production(r.accel, mesh, cam, cfg, r.attr_tables)
    origins = gbuf["position"] + gbuf["gnormal"] * cfg.shadow_bias
    args, kw = tr.any_point_soft_inputs(r.accel, origins, gbuf["valid"],
                                        lamp.position, LAMP_RADIUS, SPP,
                                        seed, 0)[:2]
    calls["any_point_soft"] = (tr.any_point_soft_cuda, args, kw)
    sun = Light.sun(SUN_DIR, angular_radius_deg=2.0)
    args, kw = tr.any_soft_inputs(r.accel, origins, gbuf["valid"],
                                  sun.direction, cone_cos(sun), SPP, seed,
                                  0)[:2]
    calls["any_soft"] = (tr.any_soft_cuda, args, kw)
    ms, outs = {}, {}
    for name, (fn, args, kw) in calls.items():
        res = fn(*args, **kw)
        if res[-1].tolist() != [0, 0]:
            raise RuntimeError(f"{name}: walk counters {res[-1].tolist()}")
        outs[name] = sha(res)
        ms[name] = cuda_ms(lambda: fn(*args, **kw))
    fused_ms, fused = frames(r)
    unfused_ms, unfused = frames(ru)
    print(json.dumps({
        "tree": sys.argv[1], "card": card, "kernel_ms": ms,
        "ptxas": {k: v for k, v in ptxas_report(BuildInfo.log).items()
                  if any(e in k for e in PTXAS_ENTRIES)},
        "frame_ms": {"fused": fused_ms, "unfused": unfused_ms},
        "frame_ms_mean": {"fused": float(np.mean(fused_ms)),
                          "unfused": float(np.mean(unfused_ms))},
        "routes": [r.route, ru.route],
        "image_sha256": {"fused": sha([fused["image"]]),
                         "unfused": sha([unfused["image"]])},
        "kernel_out_sha256": outs}), flush=True)


if __name__ == "__main__":
    main()
