"""Where the v1 rasterizer (``bin_triangles`` + ``rasterize_tiles``, 16-float
records over uncentred pixel coordinates) and the production one
(``bin_rows`` + ``rasterize_rows``, 32-float records over centred,
unit-scaled coordinates) pick different triangles, at config 1's 1080p
view of the Sponza-class hall; both against the ray cast's closest hit
(mode NEAREST on the SBVH accel) at the same pixel centres. Prints one
JSON line.

    python3 probes/port_raster_v1.py        # one card

For the pixels where the two rasterizers' ids differ it reports the
relative gap of their 1/w, and which of the two the ray cast agrees with.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import tpurt_torch.kernels.raster as R  # noqa: E402
import tpurt_torch.kernels.traverse as tr  # noqa: E402
from tpurt_torch.app import Renderer  # noqa: E402
from tpurt_torch.camera import generate_rays  # noqa: E402
from tpurt_torch.raster.setup import (bin_rows, bin_triangles,  # noqa: E402
                                      default_cap_pairs, default_cap_rows)
from tpurt_torch.scenes import (sponza_interior_camera,  # noqa: E402
                                sponza_scene)
from tpurt_torch.types import Light, RenderConfig  # noqa: E402

W, H = 1920, 1080


def share(mask, of):
    n = int(of.sum())
    return float((mask & of).sum()) / n if n else 0.0


def main():
    dev = torch.device("cuda", 0)
    mesh = sponza_scene(260_000)
    cam = sponza_interior_camera()
    r = Renderer(mesh, cam, Light.directional((0.25, 0.9, 0.2)),
                 RenderConfig(width=W, height=H, leaf_size=14), device=dev)
    md = mesh.on(dev)
    n = mesh.num_triangles
    t1, u1, v1, w1 = R.rasterize_tiles(
        bin_triangles(cam, md, W, H, default_cap_pairs(n)), W, H)
    t2, a2 = R.rasterize_rows(bin_rows(cam, md, W, H, default_cap_rows(n)),
                              W, H)
    w2 = a2[2]
    o, d = generate_rays(cam, W, H, dev)
    _, tray, counts = tr.trace_closest(r.accel, o, d)
    tr.check_walk_counts(counts)
    cov = (t1 >= 0) & (t2 >= 0)
    diff = cov & (t1 != t2)
    gap = ((w1 - w2).abs() / w2.abs().clamp(min=1e-30))[diff]
    q = torch.tensor([0.5, 0.9, 0.99, 1.0], device=dev)
    res = dict(
        card=torch.cuda.get_device_name(0), covered=int(cov.sum()),
        v1_v2_ids_equal=1.0 - share(diff, cov),
        v1_vs_ray=share(t1 == tray, cov), v2_vs_ray=share(t2 == tray, cov),
        differ=int(diff.sum()),
        differ_ray_takes_v1=share(t1 == tray, diff),
        differ_ray_takes_v2=share(t2 == tray, diff),
        differ_invw_rel_gap_quantiles=(torch.quantile(gap.double(), q.double())
                                       .tolist() if gap.numel() else []),
        differ_gap_below_1e3=share(gap <= 1e-3, torch.ones_like(gap,
                                                                dtype=bool)))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
