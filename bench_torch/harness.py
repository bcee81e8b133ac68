"""One run of one benchmark cell (``python3 bench_torch/run.py --help``).

The manifest (``BENCHMARK.json``) names the cell's configuration and
traffic mix; each is a data file found by its name:

- ``bench_torch/configs/<config>.json``: the deployment (scene generator
  and size, camera, accel, render settings, the guarantees it states);
- ``bench_torch/traffic/<traffic>.json``: the frames a user asks for
  (resolution, lights, samples, accumulation, animation, and how many
  frames warm up, are traced and are checked);
- ``bench_torch/limits/<workload>.json``: the limits that decide
  ``correct`` in that cell, with the readings they were set from;
- ``bench_torch/metrics/<metric>/read.py``: the reader of one per-layer
  metric (``read(ctx)`` -> a number, or None where it finds nothing).

The loop is closed, as a game loop is: the next frame is asked for when
the last one returns (``Renderer.render_frame``, after ``set_vertices``
in an animated cell). ``render_frame`` ends in a host read of its walk
flags that follows all of the frame's device work, so the host clock
around the call times the whole frame.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from tpurt_torch.types import LIGHT_AREA_CONE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = ("hit_off", "t_err", "shadow_off", "image_off")
# A checked frame is drawn from the seed among the window's first few
# frames; the window's last frame is always checked.
CHECK_SPAN = 8


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(workload: str, root: str = ROOT) -> SimpleNamespace:
    """The workload's entry in the manifest, its configuration, traffic
    mix and limits, and the per-layer metrics that apply to it."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    bench = os.path.join(root, "bench_torch")
    per_layer = [m for m in manifest["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in manifest["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    return SimpleNamespace(
        name=workload, chips=w["chips"],
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(bench, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(bench, "limits", workload + ".json")),
        per_layer=per_layer, end_to_end=end_to_end, bench=bench)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def load_libraries(config: dict) -> Dict[str, float]:
    """Load the program's libraries before any other set-up, building each
    that the checkout lacks (a checkout's first run), so that the compiler
    shows apart from the rest of set-up -> {library: seconds, and
    "<library>_built": 1.0 where it was built}. The native library (the
    host SBVH) is loaded only where the configuration builds the accel on
    the host; its failure raises rather than let the Renderer fall back
    to a build on the device."""
    from tpurt_torch import native
    from tpurt_torch.kernels import _build
    libs = [("kernels", _build.library_path(), _build.load_library)]
    if config["render"]["sah"] and config["mode"] != "rebuild":
        libs.append(("native", native._LIB_PATH, native.load_library))
    out = {}
    for name, path, load in libs:
        built = not os.path.exists(path)
        t0 = time.perf_counter()
        load()
        out[name + "_s"] = time.perf_counter() - t0
        if built:
            out[name + "_built"] = 1.0
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Cell:
    """The system under test for one cell and seed: the scene drawn from
    the seed, the Renderer, and one frame step."""

    def __init__(self, cell, seed: int, device, overrides: dict):
        from tpurt_torch.app import Renderer
        from tpurt_torch.types import RenderConfig
        from . import scene
        conf, traffic = cell.config, cell.traffic
        self.dev = torch.device(device)
        spec = dict(conf["scene"])
        if "tris_target" in overrides:
            spec["tris_target"] = overrides["tris_target"]
        t0 = time.perf_counter()
        self.mesh = scene.make_scene(spec, seed)
        self.phases = {"scene_s": time.perf_counter() - t0}
        self.camera = scene.camera(conf["camera"])
        self.lights = scene.lights(traffic["lights"])
        self.view = dict(conf["render"], width=traffic["width"],
                         height=traffic["height"], spp=traffic["spp"],
                         accumulate=traffic["accumulate"])
        for k in ("width", "height"):
            self.view[k] = overrides.get(k, self.view[k])
        rc = dict(self.view)
        rc["background"] = tuple(rc["background"])
        self.config = RenderConfig(seed=seed, **rc)
        self.seed = seed
        t0 = time.perf_counter()
        self.renderer = Renderer(self.mesh, self.camera, self.lights,
                                 self.config, mode=conf["mode"],
                                 device=self.dev)
        _sync(self.dev)
        self.phases["renderer_s"] = time.perf_counter() - t0
        self.setup_stats = {k: v for k, v in self.renderer.stats.items()
                            if k.endswith("_ms")}
        self.anim = traffic.get("animate")
        self.frame = 0          # animation frames asked for so far
        self.last_image = None  # the last frame's image (a reference)
        if self.anim:
            self.base = torch.as_tensor(self.mesh.vertices, device=self.dev)
            self.phase0 = seed % self.anim["phase_frames"]

    def pose(self, frame: int) -> torch.Tensor:
        """The animation's vertices at one frame, made on the device."""
        from .scene import deform
        return deform(self.base, (self.phase0 + frame) * self.anim["dt"],
                      self.anim["amplitude"], self.anim["freq"])

    def step(self) -> dict:
        """One frame as a user's loop asks for it."""
        r = self.renderer
        if self.anim:
            r.set_vertices(self.pose(self.frame))
        self.frame += 1
        out = r.render_frame()
        self.last_image = out["image"]
        return out


class Window:
    """The frames of one window: their host times, failures, and the
    outputs kept for the check (by reference: no copy is made)."""

    def __init__(self, cell: Cell, check_at: int):
        self.cell = cell
        self.check_at = check_at
        self.times: List[float] = []
        self.failed = 0
        self.kept: List[dict] = []
        self.last: Optional[dict] = None
        self.build_ms: List[float] = []

    def frame(self) -> None:
        c = self.cell
        r = c.renderer
        info = {"frame_index": r.frame_index, "anim_frame": c.frame,
                "prev_image": c.last_image}
        t0 = time.perf_counter()
        try:
            out = c.step()
        except Exception:                      # a frame that raised
            self.failed += 1
            if self.failed == 1:
                traceback.print_exc(file=sys.stderr)
            self.times.append(time.perf_counter() - t0)
            return
        self.times.append(time.perf_counter() - t0)
        if "build_ms" in r.stats:
            self.build_ms.append(r.stats["build_ms"])
        info["out"] = {k: out[k] for k in ("image", "shadow", "t", "tri_id",
                                           "valid")}
        if len(self.times) - 1 == self.check_at:
            self.kept.append(info)
        self.last = info

    def close(self) -> None:
        """Keep the window's last frame too."""
        if self.last is not None and (not self.kept
                                      or self.kept[-1] is not self.last):
            self.kept.append(self.last)


def _implied_image(k: dict, accumulate: bool) -> torch.Tensor:
    """The frame's own image: the output, or, where the frames
    accumulate, the frame that the running mean's last update added:
    mean_n * (n + 1) - mean_(n-1) * n."""
    img = k["out"]["image"]
    n = k["frame_index"]
    if not accumulate or n == 0:
        return img
    return img * (n + 1) - k["prev_image"] * n


def sampled(k: dict, idx: torch.Tensor, accumulate: bool) -> dict:
    """The kept frame's outputs at the sampled pixels (flat indices)."""
    o = k["out"]
    img = _implied_image(k, accumulate)
    return {"t": o["t"].reshape(-1)[idx].float(),
            "tri_id": o["tri_id"].reshape(-1)[idx],
            "valid": o["valid"].reshape(-1)[idx],
            "shadow": o["shadow"].reshape(o["shadow"].shape[0], -1)[:, idx]
            .float(),
            "image": img.reshape(-1, 3)[idx].float()}


def reference_frame(cell: Cell, k: dict, y, x, dtype=torch.float32) -> dict:
    """The reference's frame at pixels (y, x), on the frame's geometry."""
    from . import reference as ref
    m = cell.mesh
    dev = y.device
    idx = torch.as_tensor(m.indices, device=dev)
    if cell.anim:
        verts = cell.pose(k["anim_frame"]).to(dev)
        normals = ref.smooth_normals(verts, idx)
    else:
        verts = torch.as_tensor(m.vertices, device=dev)
        normals = torch.as_tensor(m.normals, device=dev)
    geo = ref.geometry(verts, idx, normals,
                       torch.as_tensor(m.albedo, device=dev), dtype)
    fseed = ref.frame_seed(cell.seed, k["frame_index"])
    return ref.render(geo, cell.camera, cell.lights, cell.view, y, x, fseed,
                      dtype)


def pixel_sample(seed: int, n: int, total: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev)
    g.manual_seed(seed % (1 << 63))
    return torch.randperm(total, generator=g, device=dev)[:min(n, total)]


def check(cell: Cell, kept: List[dict], idx: torch.Tensor,
          control: bool = False) -> Dict[str, float]:
    """The numbers of CHECKS over the kept frames at the sampled pixels
    ``idx`` (the largest of each). ``control``: the reference computed in
    bfloat16 stands in for the program's outputs."""
    from .reference import compare
    w = cell.view["width"]
    y, x = idx // w, idx % w
    worst = {k: 0.0 for k in CHECKS}
    for k in kept:
        want = reference_frame(cell, k, y, x)
        if control:
            got = reference_frame(cell, k, y, x, torch.bfloat16)
        else:
            got = k["sampled"]
        for name, v in compare(got, want).items():
            worst[name] = max(worst[name], v)
    return worst


def _load_reader(bench: str, name: str):
    path = os.path.join(bench, "metrics", name, "read.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_torch_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", overrides: Optional[dict] = None,
        fault=None, root: str = ROOT, control: bool = False) -> dict:
    """One run of the cell -> the result dict. ``overrides`` (tests only)
    shrinks the scene, the frame and the samples; ``fault(cell)`` (tests
    only) breaks the system under test after its set-up; ``control``
    (``bench_torch/calibrate.py``, the tests) puts the control, the
    reference computed in bfloat16, in the program's place on the same
    frames and pixels: ``correct`` and ``checks`` are then the control's,
    and the program's numbers are kept beside them."""
    overrides = overrides or {}
    cell = find_cell(workload, root)
    traffic = cell.traffic
    phases = {"imports_s": time.perf_counter() - t_start}
    if torch.device(device).type == "cuda":
        phases.update(load_libraries(cell.config))
    c = Cell(cell, seed, device, overrides)
    phases.update(c.phases)
    if fault is not None:
        fault(c)
    t0 = time.perf_counter()
    for _ in range(overrides.get("warmup_frames", traffic["warmup_frames"])):
        c.step()
    _sync(c.dev)
    phases["warmup_s"] = time.perf_counter() - t0
    # What set-up left behind is not collected again in the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    check_at = random.Random(seed).randrange(CHECK_SPAN)
    win = Window(c, check_at)
    summary = None
    if trace:
        from .profile import profile_frames
        n = overrides.get("trace_frames", traffic["trace_frames"])
        summary = profile_frames(win.frame, n, c.dev)
    else:
        t0 = time.perf_counter()
        while True:
            win.frame()
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(c.dev)
        window_s = time.perf_counter() - t0
    win.close()
    peak = torch.cuda.max_memory_allocated(c.dev) \
        if c.dev.type == "cuda" else 0
    recoveries = c.renderer.stats.get("overflow_recoveries")
    done = len(win.times) - win.failed
    metrics = {}
    t_read = time.perf_counter()
    if trace:
        ctx = SimpleNamespace(cell=c, trace=summary, build_ms=win.build_ms,
                              setup_stats=c.setup_stats, bench=cell.bench,
                              last_frame_index=c.renderer.frame_index - 1)
        for m in cell.per_layer:
            value = _load_reader(cell.bench, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif done:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = {"frame_ms": window_s * 1e3 / done,
                  "frame_ms_p95": float(np.percentile(win.times, 95)) * 1e3,
                  "setup_s": setup_s}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in values.items() if k in units}
    read_s = time.perf_counter() - t_read
    pixels = overrides.get("check_pixels", traffic["check_pixels"])
    w, h = c.view["width"], c.view["height"]
    idx = pixel_sample(seed, pixels, w * h, c.dev)
    shadow_rays = None
    for k in win.kept:
        k["sampled"] = sampled(k, idx, c.view["accumulate"])
    if win.kept:
        valid = int(win.kept[-1]["out"]["valid"].sum())
        per_light = [c.view["spp"] if l.kind == LIGHT_AREA_CONE else 1
                     for l in c.lights]
        shadow_rays = valid * sum(per_light)
    for k in win.kept:
        k.pop("out")
        k.pop("prev_image")
    win.last = c.last_image = None
    c.renderer = None
    gc.unfreeze()
    gc.collect()
    if c.dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check(c, win.kept, idx) if win.kept else None
    check_s = time.perf_counter() - t_check
    control_numbers = check(c, win.kept, idx, control=True) \
        if control and win.kept else None
    limits = cell.limits
    judged = control_numbers if control else numbers
    correct = judged is not None and all(
        judged[k] <= limits[k] for k in CHECKS)
    result = {"correct": correct, "attempted": len(win.times),
              "failed": win.failed, "metrics": metrics,
              "device": {"platform": "gpu" if c.dev.type == "cuda"
                         else c.dev.type,
                         "kind": torch.cuda.get_device_name(c.dev)
                         if c.dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = summary.breakdown
    result["_info"] = {"shadow_rays_per_frame": shadow_rays,
                       "check_s": check_s, "read_s": read_s,
                       "program": numbers, "control": control_numbers,
                       "setup_phases": phases,
                       "setup_stats": c.setup_stats,
                       "overflow_recoveries": recoveries}
    result["checks"] = {k: {"value": (judged or {}).get(k, math.inf),
                            "limit": limits[k]} for k in CHECKS}
    return result


def report(result: dict) -> None:
    """Earlier lines, then the result as the last line of standard
    output; the checks as the last lines of standard error."""
    out, err = sys.stdout, sys.stderr
    info = result.pop("_info")
    frame = result["metrics"].get("frame_ms")
    if frame and info["shadow_rays_per_frame"]:
        print(f"shadow_mrays_per_s: "
              f"{info['shadow_rays_per_frame'] / frame['value'] / 1e3}",
              file=out)
    print(f"setup phases: {json.dumps(info['setup_phases'])}", file=out)
    print(f"setup: {json.dumps(info['setup_stats'])}; overflow "
          f"recoveries: {info['overflow_recoveries']}; per-layer reading "
          f"{info['read_s']} s; check {info['check_s']} s", file=out)
    print(json.dumps(result), file=out, flush=True)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=err)
    err.flush()


def main(argv, t_start: float) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = find_cell(a.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # One process with one intra-op thread: nothing of the benchmark's own
    # competes with the frame loop's thread for the host's cores.
    torch.set_num_threads(1)
    result = run(a.workload, a.seed, a.seconds, bool(a.trace),
                 t_start=t_start)
    print(f"card: {card_line()}", flush=True)
    report(result)
    return 0
