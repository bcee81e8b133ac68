"""Renderer: the static-scene frame (counterpart of the static slice of
``tpurt/app.py``).

One frame: camera rays -> near-first child ordering of the accel -> ONE
fused kernel launch (closest hit with the winner's shading attributes,
then light 0's hard shadow) -> G-buffer decode -> composite. The accel is
built once per scene: host SBVH build, 8-wide area collapse, leaf
attribute rows. On the H100 the accel lives in device memory, so the TPU
package's VMEM budgets and chunked split have no counterpart here.

Everything outside this slice raises ``NotImplementedError`` naming the
missing piece; nothing falls back to another path or device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Union

import torch

from .bvh.sah import build_sah_lbvh
from .bvh.wide import (WideBVH, count_wide, leaf_boxes_from_nodes,
                       make_wide_plan, order_children_for_point,
                       round_up_bucket, wide_depth, widen_from_plan)
from .camera import generate_rays
from .kernels.traverse import (check_stack_bound, check_walk_counts,
                               trace_closest_shadow)
from .passes.composite import accumulate, composite_pass
from .passes.gbuffer import gbuf_from_attr_channels
from .passes.shading import make_leaf_attr_rows
from .types import (LIGHT_AREA_CONE, LIGHT_POINT, Camera, Light, Mesh,
                    RenderConfig)


def check_slice(config: RenderConfig, mode: str, lights: Sequence[Light],
                mesh: Mesh, cache_dir: Optional[str]) -> None:
    """Raise NotImplementedError for anything the port does not cover yet."""
    missing = []
    if mode != "static":
        missing.append(f"mode={mode!r} (per-frame rebuild / refit)")
    if config.bvh_width != 8:
        missing.append(f"bvh_width={config.bvh_width} (binary traversal)")
    if not config.sah:
        missing.append("sah=False (on-device Morton build)")
    if not config.use_pallas:
        missing.append("use_pallas=False (portable traversal)")
    if config.gbuffer == "raster":
        missing.append("gbuffer='raster' (tile rasterizer)")
    if not config.fused_shadow:
        missing.append("fused_shadow=False (unfused shadow pass)")
    if not config.inkernel_attrs or config.seeded_gbuffer:
        missing.append("the shade-table G-buffer (inkernel_attrs=False or "
                       "seeded_gbuffer=True)")
    if mesh.textured:
        missing.append("textured meshes")
    if len(lights) != 1:
        missing.append(f"{len(lights)} lights (only one is ported)")
    for l in lights:
        if l.kind == LIGHT_AREA_CONE:
            missing.append("area (cone) lights")
        if l.kind == LIGHT_POINT and config.spp > 1:
            missing.append("spp > 1 on a point light (disk penumbra)")
    if cache_dir is not None:
        missing.append("cache_dir (content-addressed BVH cache)")
    if missing:
        raise NotImplementedError("not ported: " + "; ".join(missing))


def gbuffer_shadow_fused_production(bvh: WideBVH, mesh: Mesh, cam: Camera,
                                    cfg: RenderConfig, light: Light,
                                    attr_tables):
    """ONE kernel launch returns the hit set with its shading attributes
    and light 0's hard-shadow visibility. Returns (gbuf, visibility,
    walk counts)."""
    dev = bvh.nodes.device
    gb_accel = order_children_for_point(bvh, cam.position) \
        if cfg.order_children else bvh
    lpos = light.position if light.kind == LIGHT_POINT else None
    origins, dirs = generate_rays(cam, cfg.width, cfg.height, dev)
    ch, occ, counts = trace_closest_shadow(
        gb_accel, origins, dirs, light.direction, cfg.shadow_bias,
        light_pos=lpos, attr_tables=attr_tables)
    gbuf = gbuf_from_attr_channels(ch, origins, dirs, cam, mesh)
    vis = torch.where(occ, 0.0, 1.0)
    vis = torch.where(gbuf["valid"], vis, 1.0)
    return gbuf, vis, counts


def render_frame_fn(bvh: WideBVH, mesh: Mesh, cam: Camera,
                    lights: Sequence[Light], cfg: RenderConfig,
                    attr_tables) -> Dict[str, torch.Tensor]:
    """One fused frame: G-buffer + light-0 shadow -> composite."""
    gbuf, vis0, counts = gbuffer_shadow_fused_production(
        bvh, mesh, cam, cfg, lights[0], attr_tables)
    img = composite_pass(gbuf, vis0, lights[0], cfg.ambient, cfg.background)
    return {"image": img, "shadow": vis0[None], **gbuf,
            "walk_counts": counts}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Renderer:
    """Owns the scene and its accel on ``device`` and renders frames.

    ``stats`` holds the set-up times in milliseconds: ``sah_build_ms``
    (host SBVH build and conversion, copy to the device included),
    ``collapse_ms`` (8-wide collapse) and ``attr_rows_ms``."""

    def __init__(self, mesh: Mesh, camera: Camera,
                 lights: Union[Light, Sequence[Light]],
                 config: RenderConfig = RenderConfig(),
                 mode: str = "static", cache_dir: Optional[str] = None, *,
                 device):
        if isinstance(lights, Light):
            lights = [lights]
        lights = list(lights)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available")
        check_slice(config, mode, lights, mesh, cache_dir)
        if config.gbuffer == "auto":
            config = dataclasses.replace(config, gbuffer="ray")
        self.config = config
        self.mode = mode
        self.mesh = mesh
        self.camera = camera
        self.lights = lights
        self.frame_index = 0
        self.accum: Optional[torch.Tensor] = None
        self.stats: Dict[str, float] = {}

        t0 = time.perf_counter()
        self.bvh = build_sah_lbvh(mesh, self.device, config.leaf_size)
        _sync(self.device)
        t1 = time.perf_counter()
        self.accel = self._make_accel()
        _sync(self.device)
        t2 = time.perf_counter()
        self.attr_tables = make_leaf_attr_rows(self.bvh, mesh)
        _sync(self.device)
        t3 = time.perf_counter()
        self.stats.update(sah_build_ms=(t1 - t0) * 1e3,
                          collapse_ms=(t2 - t1) * 1e3,
                          attr_rows_ms=(t3 - t2) * 1e3)
        self.depth = wide_depth(self.accel)
        check_stack_bound(self.depth)

    def _make_accel(self) -> WideBVH:
        """8-wide area collapse of the SAH tree. The leaf slots take the
        builder's stored (on SBVH: clipped) boxes."""
        nw_pad = round_up_bucket(max(count_wide(self.bvh), 1))
        plan = make_wide_plan(self.bvh, nw_pad)
        return widen_from_plan(plan, self.bvh, leaf_boxes_from_nodes(self.bvh))

    def render_frame(self) -> Dict[str, torch.Tensor]:
        """Render one frame; returns the output dict (tensors on the
        Renderer's device). Raises if a walk overflowed its stack or hit
        the iteration cap."""
        cfg = self.config
        out = render_frame_fn(self.accel, self.mesh, self.camera,
                              self.lights, cfg, self.attr_tables)
        check_walk_counts(out["walk_counts"])
        if cfg.accumulate:
            if self.accum is None:
                self.accum = out["image"]
            else:
                self.accum = accumulate(self.accum, self.frame_index,
                                        out["image"])
            out["image"] = self.accum
        self.frame_index += 1
        return out
