"""Time the port's attrs=1 walk kernels of one source tree at config 1's
1080p frame (the Sponza-class hall, one directional light, leaf 14): HARD
and CLOSEST over 20 launches each (CUDA events, after one warm-up) and
five Renderer frames. Prints one JSON line.

    python3 probes/port_turns.py ROOT     # ROOT: a checkout of the repo

Run it in turns for two trees on one card (parent, change, change,
parent), each in a process of its own, so that both see the same card and
host; every tree builds its own kernel library under ROOT/build/.
"""

import json
import sys

sys.path.insert(0, sys.argv[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

import tpurt_torch.kernels.traverse as tr  # noqa: E402
from tpurt_torch.app import Renderer, _gb_accel  # noqa: E402
from tpurt_torch.camera import generate_rays  # noqa: E402
from tpurt_torch.kernels._build import load_library  # noqa: E402
from tpurt_torch.scenes import (sponza_interior_camera,  # noqa: E402
                                sponza_scene)
from tpurt_torch.types import Light, RenderConfig  # noqa: E402


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("port_turns: CUDA is not available")
    load_library()
    light = Light.directional((0.25, 0.9, 0.2))
    r = Renderer(sponza_scene(260_000), sponza_interior_camera(), light,
                 RenderConfig(width=1920, height=1080, leaf_size=14),
                 device="cuda")
    acc = _gb_accel(r.accel, r.camera, r.config)
    o, d = generate_rays(r.camera, 1920, 1080, r.device)
    args, kw = tr.closest_shadow_inputs(acc, o, d, light.direction, 1e-3,
                                        r.attr_tables)[:2]
    hard = cuda_ms(lambda: tr.closest_shadow_cuda(*args, **kw))
    args, kw = tr.closest_attrs_inputs(acc, o, d, r.attr_tables)[:2]
    closest = cuda_ms(lambda: tr.closest_attrs_cuda(*args, **kw))
    frames = []
    for i in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r.render_frame()
        end.record()
        torch.cuda.synchronize()
        if i:
            frames.append(start.elapsed_time(end))
    print(json.dumps({"tree": sys.argv[1],
                      "card": torch.cuda.get_device_name(0),
                      "hard_ms": hard, "closest_attrs_ms": closest,
                      "frame_ms_mean": float(np.mean(frames))}), flush=True)


if __name__ == "__main__":
    main()
