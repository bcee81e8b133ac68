"""Renderer: the static-scene fused frames (counterpart of the static slice
of ``tpurt/app.py``).

One frame: camera rays -> near-first child ordering of the accel -> ONE
fused kernel launch -> G-buffer decode -> composite. The kernel finds the
closest hit with the winner's shading attributes, then traces the light
set's shadows from the biased hit point. Which kernel runs follows
``tpurt``'s routing order (``render_frame_fn``):

1. fusedN: every light hard (directional; point or cone at spp 1) and at
   least two of them -> one hard walk per light, an occlusion bitmask;
2. fusedSM: a soft light 0 (cone or point at spp > 1) with hard
   directional extras -> light-0 sample counts plus a bitmask;
3. fused0: one light -> its hard shadow, cone samples or disk samples.

Unlike ``tpurt`` the soft paths are not gated on the backend: the port's
in-kernel generator is real on the CPU too. The accel is built once per
scene: host SBVH build, 8-wide area collapse, leaf attribute rows. On the
H100 the accel lives in device memory, so the TPU package's VMEM budgets
and chunked split have no counterpart here.

Everything outside this slice raises ``NotImplementedError`` naming the
missing piece; nothing falls back to another path or device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .bvh.sah import build_sah_lbvh
from .bvh.wide import (WideBVH, count_wide, leaf_boxes_from_nodes,
                       make_wide_plan, order_children_for_point,
                       round_up_bucket, wide_depth, widen_from_plan)
from .camera import generate_rays
from .kernels.traverse import (MAX_MASK_LIGHTS, check_stack_bound,
                               check_walk_counts, trace_closest_multi_shadow,
                               trace_closest_point_soft_shadow,
                               trace_closest_shadow,
                               trace_closest_soft_multi_shadow,
                               trace_closest_soft_shadow)
from .passes.composite import accumulate, composite_pass
from .passes.gbuffer import gbuf_from_attr_channels
from .passes.shading import make_leaf_attr_rows
from .types import (LIGHT_AREA_CONE, LIGHT_DIRECTIONAL, LIGHT_POINT, Camera,
                    Light, Mesh, RenderConfig)


def _fused_on(cfg: RenderConfig) -> bool:
    return cfg.fused_shadow and cfg.use_pallas and cfg.gbuffer != "raster"


def fused_shadow_applicable(cfg: RenderConfig, lights) -> bool:
    """Does the single-light fused kernel take light 0? Directional lights
    are hard; point and cone lights are hard at spp 1 and take the soft
    (disk or cone) kernels at spp > 1 (``tpurt/app.py`` :297, without its
    compiled-backend gate)."""
    if not (_fused_on(cfg) and len(lights) > 0):
        return False
    return lights[0].kind in (LIGHT_DIRECTIONAL, LIGHT_POINT,
                              LIGHT_AREA_CONE)


def fused_multi_applicable(cfg: RenderConfig, lights) -> bool:
    """Does the N-hard-shadow kernel take the light set? Two or more
    lights, each directional, or point or cone at spp 1 (:322)."""
    if not (_fused_on(cfg) and len(lights) >= 2):
        return False
    return all(l.kind == LIGHT_DIRECTIONAL
               or (l.kind in (LIGHT_POINT, LIGHT_AREA_CONE) and cfg.spp == 1)
               for l in lights)


def fused_soft_multi_applicable(cfg: RenderConfig, lights) -> bool:
    """Does the soft-plus-extras kernel take the light set? Light 0 a cone
    or point light at spp > 1, every other light directional (:360,
    without its compiled-backend gate)."""
    if not (_fused_on(cfg) and cfg.spp > 1 and len(lights) >= 2):
        return False
    return (lights[0].kind in (LIGHT_AREA_CONE, LIGHT_POINT)
            and all(l.kind == LIGHT_DIRECTIONAL for l in lights[1:]))


def frame_route(cfg: RenderConfig, lights) -> Optional[str]:
    """The fused path a frame takes, in ``tpurt``'s order (fusedN, fusedSM,
    fused0), or None when no fused kernel shades every light (``tpurt``
    then traces the other lights in the unfused shadow pass)."""
    if fused_multi_applicable(cfg, lights):
        return "fusedN"
    if fused_soft_multi_applicable(cfg, lights):
        return "fusedSM"
    if len(lights) == 1 and fused_shadow_applicable(cfg, lights):
        return "fused0"
    return None


def _kinds(lights) -> str:
    names = {LIGHT_DIRECTIONAL: "directional", LIGHT_POINT: "point",
             LIGHT_AREA_CONE: "area cone"}
    return ", ".join(names.get(l.kind, str(l.kind)) for l in lights)


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
    if not lights:
        missing.append("an empty light set")
    elif _fused_on(config):
        route = frame_route(config, lights)
        if route is None:
            missing.append(
                f"{len(lights)} lights ({_kinds(lights)}) at spp "
                f"{config.spp}: no fused kernel takes this light set; the "
                f"lights after light 0 need the unfused shadow pass")
        elif route == "fusedN" and len(lights) > MAX_MASK_LIGHTS:
            missing.append(f"{len(lights)} lights (the occlusion mask holds "
                           f"{MAX_MASK_LIGHTS})")
        elif route == "fusedSM" and len(lights) - 1 > MAX_MASK_LIGHTS:
            missing.append(f"{len(lights) - 1} extra lights (the occlusion "
                           f"mask holds {MAX_MASK_LIGHTS})")
    if cache_dir is not None:
        missing.append("cache_dir (content-addressed BVH cache)")
    if missing:
        raise NotImplementedError("not ported: " + "; ".join(missing))


def _mix32(h: int) -> int:
    """MurmurHash3's 32-bit finaliser."""
    h &= 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def frame_seed(seed: int, frame_index: int) -> int:
    """The in-kernel generator's 32-bit key word for one frame:
    fmix32(fmix32(seed) + 0x9E3779B9 * (frame_index + 1)), in place of
    ``tpurt``'s ``_kernel_seed`` of ``fold_in(PRNGKey(seed), frame)``. Any
    change of seed or frame changes every sample; it is not bit-compatible
    with ``jax.random``. The light index is the generator's second key
    word."""
    return _mix32(_mix32(seed) + 0x9E3779B9 * (frame_index + 1))


def _gb_accel(bvh: WideBVH, cam: Camera, cfg: RenderConfig) -> WideBVH:
    return order_children_for_point(bvh, cam.position) \
        if cfg.order_children else bvh


def _cone_cos(light: Light) -> float:
    return float(np.cos(np.float32(light.angular_radius)))


def _visibility(valid: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, vis, 1.0)


def _mask_visibility(valid, mask, n: int, first_bit: int = 0):
    """Bit ``first_bit + i`` of the occlusion mask -> visibility of the
    i-th of n lights."""
    return [_visibility(valid, torch.where(
        ((mask >> (first_bit + i)) & 1) > 0, 0.0, 1.0)) for i in range(n)]


def gbuffer_shadow_fused_production(bvh: WideBVH, mesh: Mesh, cam: Camera,
                                    cfg: RenderConfig, light: Light,
                                    attr_tables, seed: int = 0):
    """ONE kernel launch returns the hit set with its shading attributes
    and light 0's visibility: hard (directional, point, or a cone at spp 1
    along its axis), cone-sampled for an area light at spp > 1, or
    disk-sampled for a point light at spp > 1 (visibility = 1 - counts /
    spp). Returns (gbuf, visibility, walk counts)."""
    dev = bvh.nodes.device
    gb_accel = _gb_accel(bvh, cam, cfg)
    origins, dirs = generate_rays(cam, cfg.width, cfg.height, dev)
    soft = light.kind == LIGHT_AREA_CONE and cfg.spp > 1
    psoft = light.kind == LIGHT_POINT and cfg.spp > 1
    if psoft:
        ch, cnt, counts = trace_closest_point_soft_shadow(
            gb_accel, origins, dirs, light.position, light.radius, cfg.spp,
            seed, cfg.shadow_bias, attr_tables=attr_tables)
        vis = 1.0 - cnt.to(torch.float32) / cfg.spp
    elif soft:
        ch, cnt, counts = trace_closest_soft_shadow(
            gb_accel, origins, dirs, light.direction, _cone_cos(light),
            cfg.spp, seed, cfg.shadow_bias, attr_tables=attr_tables)
        vis = 1.0 - cnt.to(torch.float32) / cfg.spp
    else:
        lpos = light.position if light.kind == LIGHT_POINT else None
        ch, occ, counts = trace_closest_shadow(
            gb_accel, origins, dirs, light.direction, cfg.shadow_bias,
            light_pos=lpos, attr_tables=attr_tables)
        vis = torch.where(occ, 0.0, 1.0)
    gbuf = gbuf_from_attr_channels(ch, origins, dirs, cam, mesh)
    return gbuf, _visibility(gbuf["valid"], vis), counts


def gbuffer_multi_shadow_fused_production(bvh: WideBVH, mesh: Mesh,
                                          cam: Camera, cfg: RenderConfig,
                                          lights: Sequence[Light],
                                          attr_tables):
    """ONE kernel launch for an all-hard light set: the hit set and one
    occlusion bit per light (cones at spp 1 along their axes). Returns
    (gbuf, [visibility per light], walk counts)."""
    dev = bvh.nodes.device
    gb_accel = _gb_accel(bvh, cam, cfg)
    spec = [(None, l.position) if l.kind == LIGHT_POINT
            else (l.direction, None) for l in lights]
    origins, dirs = generate_rays(cam, cfg.width, cfg.height, dev)
    ch, mask, counts = trace_closest_multi_shadow(
        gb_accel, origins, dirs, spec, cfg.shadow_bias,
        attr_tables=attr_tables)
    gbuf = gbuf_from_attr_channels(ch, origins, dirs, cam, mesh)
    return gbuf, _mask_visibility(gbuf["valid"], mask, len(lights)), counts


def gbuffer_soft_multi_shadow_fused_production(bvh: WideBVH, mesh: Mesh,
                                               cam: Camera,
                                               cfg: RenderConfig,
                                               lights: Sequence[Light],
                                               attr_tables, seed: int = 0):
    """ONE kernel launch for a soft light 0 (cone or disk) with hard
    directional extras: the hit set, light 0's sample counts and the
    extras' occlusion bits. Returns (gbuf, [visibility per light], walk
    counts)."""
    dev = bvh.nodes.device
    gb_accel = _gb_accel(bvh, cam, cfg)
    l0 = lights[0]
    light0 = ("disk", l0.position, l0.radius) if l0.kind == LIGHT_POINT \
        else ("cone", l0.direction, _cone_cos(l0))
    origins, dirs = generate_rays(cam, cfg.width, cfg.height, dev)
    ch, cnt, mask, counts = trace_closest_soft_multi_shadow(
        gb_accel, origins, dirs, light0, [l.direction for l in lights[1:]],
        cfg.spp, seed, cfg.shadow_bias, attr_tables=attr_tables)
    gbuf = gbuf_from_attr_channels(ch, origins, dirs, cam, mesh)
    valid = gbuf["valid"]
    vises = [_visibility(valid, 1.0 - cnt.to(torch.float32) / cfg.spp)]
    vises += _mask_visibility(valid, mask, len(lights) - 1)
    return gbuf, vises, counts


def render_frame_fn(bvh: WideBVH, mesh: Mesh, cam: Camera,
                    lights: Sequence[Light], cfg: RenderConfig,
                    attr_tables, seed: int = 0) -> Dict[str, torch.Tensor]:
    """One fused frame: G-buffer + every light's shadows from ONE kernel
    launch -> composite (sum of per-light direct terms + one ambient
    term). ``seed``: the frame's generator key (``frame_seed``)."""
    route = frame_route(cfg, lights)
    if route == "fusedN":
        gbuf, shadows, counts = gbuffer_multi_shadow_fused_production(
            bvh, mesh, cam, cfg, lights, attr_tables)
    elif route == "fusedSM":
        gbuf, shadows, counts = gbuffer_soft_multi_shadow_fused_production(
            bvh, mesh, cam, cfg, lights, attr_tables, seed)
    elif route == "fused0":
        gbuf, vis0, counts = gbuffer_shadow_fused_production(
            bvh, mesh, cam, cfg, lights[0], attr_tables, seed)
        shadows = [vis0]
    else:
        raise NotImplementedError(
            f"no fused kernel takes lights ({_kinds(lights)}) at spp "
            f"{cfg.spp}")
    img = composite_pass(gbuf, shadows[0], lights[0], cfg.ambient,
                         cfg.background)
    valid = gbuf["valid"][..., None]
    for li in range(1, len(lights)):
        extra = composite_pass(gbuf, shadows[li], lights[li], 0.0,
                               (0.0, 0.0, 0.0))
        img = torch.where(valid, img + extra, img)
    return {"image": img, "shadow": torch.stack(shadows), **gbuf,
            "walk_counts": counts}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Renderer:
    """Owns the scene and its accel on ``device`` (the card unless the
    caller asks for ``"cpu"``) and renders frames.

    ``stats`` holds the set-up times in milliseconds: ``sah_build_ms``
    (host SBVH build and conversion, copy to the device included),
    ``collapse_ms`` (8-wide collapse) and ``attr_rows_ms``."""

    def __init__(self, mesh: Mesh, camera: Camera,
                 lights: Union[Light, Sequence[Light]],
                 config: RenderConfig = RenderConfig(),
                 mode: str = "static", cache_dir: Optional[str] = None, *,
                 device="cuda"):
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
        self.route = frame_route(config, lights)
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
        Renderer's device). The soft kernels draw this frame's samples
        from ``frame_seed(config.seed, frame_index)``. Raises if a walk
        overflowed its stack or hit the iteration cap."""
        cfg = self.config
        out = render_frame_fn(self.accel, self.mesh, self.camera,
                              self.lights, cfg, self.attr_tables,
                              seed=frame_seed(cfg.seed, self.frame_index))
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
