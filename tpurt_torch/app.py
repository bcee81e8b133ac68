"""Renderer: the static-scene frames and the per-frame rebuild
(counterpart of the static and rebuild slices of ``tpurt/app.py``).

One fused frame: camera rays -> near-first child ordering of the accel ->
ONE fused kernel launch -> G-buffer decode -> composite. The kernel finds
the closest hit with the winner's shading attributes, then traces the
light set's shadows from the biased hit point. Which kernel runs follows
``tpurt``'s routing order (``render_frame_fn``):

1. fusedN: every light hard (directional; point or cone at spp 1) and at
   least two of them -> one hard walk per light, an occlusion bitmask;
2. fusedSM: a soft light 0 (cone or point at spp > 1) with hard
   directional extras -> light-0 sample counts plus a bitmask;
3. fused0: light 0 (any number of lights) -> its hard shadow, cone samples
   or disk samples;
4. unfused (``fused_shadow=False``, or the raster G-buffer): the
   closest-hit kernel alone, or the tile rasterizer.

Every light that no fused kernel took (lights 1.. after fused0, every
light after unfused) goes through the unfused shadow pass
(``passes/shadow.py``): one any-hit launch per hard light, one in-kernel
cone or disk sampler launch per soft light, on the accel as built (the
G-buffer walks the camera-ordered copy, as in ``tpurt``).

Unlike ``tpurt`` the soft paths are not gated on the backend: the port's
in-kernel generator is real on the CPU too. In ``mode="static"`` the accel
is built once per scene: host SBVH build (or, with ``sah=False``, the
on-device Morton build), 8-wide area collapse, leaf attribute rows. In
``mode="rebuild"`` (config 2) every frame rebuilds it on the device
(``_rebuild_fused``): Morton codes, one payload sort, sub-leaf clustering,
the topology kernel, the breadth-first area collapse kernel and the
attribute rows, with no host sync unless the geometry changed. On the
H100 the accel lives in device memory, so the TPU package's VMEM budgets
and chunked split have no counterpart here.

The primary visibility follows ``tpurt``'s choice of strategy
(``use_raster_gbuffer``): ``gbuffer="auto"`` takes the ray cast on an SBVH
accel and on a clustered rebuild, and otherwise the tile rasterizer on the
card, the compiled backend, and the ray cast on the CPU, where ``tpurt``
keeps the ray cast in interpret mode. The raster G-buffer
(``passes/gbuffer.gbuffer_raster_pass``: on-device binning, one
rasterizer launch, decode) builds no attribute rows, and every light goes
through the unfused shadow pass on the accel as built. A frame whose
binning overflowed the pair capacity is rendered again with a bigger one.

Everything outside this slice raises ``NotImplementedError`` naming the
missing piece; nothing falls back to another path or device.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Optional, Sequence, Union

import torch

from .bvh.lbvh import auto_split_blocks, build_lbvh
from .bvh.sah import build_sah_lbvh
from .bvh.wide import (WideBVH, count_wide, leaf_boxes_from_nodes,
                       make_wide_plan, order_children_for_point,
                       round_up_bucket, wide_depth, widen_area_kernel,
                       widen_from_plan)
from .camera import generate_rays
from .kernels.traverse import (MAX_MASK_LIGHTS, check_stack_bound,
                               check_walk_counts, trace_any,
                               trace_any_point_soft, trace_any_soft,
                               trace_closest_multi_shadow,
                               trace_closest_point_soft_shadow,
                               trace_closest_shadow,
                               trace_closest_soft_multi_shadow,
                               trace_closest_soft_shadow)
from .passes.composite import accumulate, composite_pass
from .passes.gbuffer import (gbuf_from_attr_channels, gbuffer_attr_pass,
                             gbuffer_raster_pass)
from .passes.shadow import cone_cos, shadow_pass
from .passes.shading import (attr_payload_columns, leaf_attr_rows_from_sorted,
                             make_leaf_attr_rows, smooth_normals_device)
from .raster.setup import default_cap_rows
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


def frame_route(cfg: RenderConfig, lights) -> str:
    """The path a frame takes, in ``tpurt``'s order: "fusedN", "fusedSM",
    "fused0" (light 0 whatever the number of lights) or "unfused" (no
    fused kernel)."""
    if fused_multi_applicable(cfg, lights):
        return "fusedN"
    if fused_soft_multi_applicable(cfg, lights):
        return "fusedSM"
    if fused_shadow_applicable(cfg, lights):
        return "fused0"
    return "unfused"


def unfused_lights(route: str, n_lights: int) -> range:
    """Indices of the lights the unfused shadow pass traces on ``route``:
    lights 1.. after fused0, every light after unfused, none after fusedN
    or fusedSM."""
    return {"fused0": range(1, n_lights),
            "unfused": range(n_lights)}.get(route, range(0))


def use_raster_gbuffer(cfg: RenderConfig, mode: str, device,
                       split_blocks: int) -> bool:
    """Does the frame rasterize its G-buffer? ``tpurt``'s resolution
    (``use_raster_gbuffer`` with the Renderer's "auto" rules,
    ``tpurt/app.py:210-217``, ``:651-669``): an explicit "raster" or "ray"
    stands; "auto" takes the ray cast on an SBVH accel (static, ``sah``)
    and on a clustered rebuild (``split_blocks``, the resolved
    ``rebuild_splits``, > 0), and otherwise the rasterizer on the card,
    the port's compiled backend, and the ray cast on the CPU."""
    if cfg.gbuffer != "auto":
        return cfg.gbuffer == "raster"
    if mode != "rebuild" and cfg.sah:
        return False
    if mode == "rebuild" and split_blocks:
        return False
    return cfg.use_pallas and torch.device(device).type == "cuda"


def _soft(light: Light, spp: int) -> bool:
    """Does ``shadow_pass`` sample the light (cone or point at spp > 1)?"""
    return light.kind in (LIGHT_AREA_CONE, LIGHT_POINT) and spp > 1


def check_slice(config: RenderConfig, mode: str, lights: Sequence[Light],
                mesh: Mesh, cache_dir: Optional[str]) -> None:
    """Raise NotImplementedError for anything the port does not cover yet.
    ``config.gbuffer`` is resolved ("ray" or "raster")."""
    if mode not in ("static", "rebuild", "refit"):
        raise ValueError(f"mode={mode!r}")
    missing = []
    if mode == "refit":
        missing.append("mode='refit' (per-frame refit)")
    if mode == "rebuild":
        if config.rebuild_collapse != "area":
            missing.append(f"rebuild_collapse={config.rebuild_collapse!r} "
                           "(the fixed cut needs the topology's depth "
                           "output)")
        if config.top_sah:
            missing.append("top_sah=True (the sweep-SAH priorities kernel)")
    if config.bvh_width != 8:
        missing.append(f"bvh_width={config.bvh_width} (binary traversal)")
    if not config.use_pallas:
        missing.append("use_pallas=False (portable traversal)")
    if config.gbuffer == "raster":
        # tpurt reads neither shade-table flag on the raster G-buffer.
        if config.raster_deferred:
            missing.append("raster_deferred=True (the z-only rasterizer)")
    elif not config.inkernel_attrs or config.seeded_gbuffer:
        missing.append("the shade-table G-buffer (inkernel_attrs=False or "
                       "seeded_gbuffer=True)")
    if mesh.textured:
        missing.append("textured meshes")
    if not lights:
        missing.append("an empty light set")
    else:
        route = frame_route(config, lights)
        if route == "fusedN" and len(lights) > MAX_MASK_LIGHTS:
            missing.append(f"{len(lights)} lights (the occlusion mask holds "
                           f"{MAX_MASK_LIGHTS})")
        elif route == "fusedSM" and len(lights) - 1 > MAX_MASK_LIGHTS:
            missing.append(f"{len(lights) - 1} extra lights (the occlusion "
                           f"mask holds {MAX_MASK_LIGHTS})")
        if config.sort_rays and any(
                not _soft(lights[i], config.spp)
                for i in unfused_lights(route, len(lights))):
            missing.append("sort_rays=True with a hard light in the unfused "
                           "shadow pass (passes/sort.py)")
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
            gb_accel, origins, dirs, light.direction, cone_cos(light),
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
        else ("cone", l0.direction, cone_cos(l0))
    origins, dirs = generate_rays(cam, cfg.width, cfg.height, dev)
    ch, cnt, mask, counts = trace_closest_soft_multi_shadow(
        gb_accel, origins, dirs, light0, [l.direction for l in lights[1:]],
        cfg.spp, seed, cfg.shadow_bias, attr_tables=attr_tables)
    gbuf = gbuf_from_attr_channels(ch, origins, dirs, cam, mesh)
    valid = gbuf["valid"]
    vises = [_visibility(valid, 1.0 - cnt.to(torch.float32) / cfg.spp)]
    vises += _mask_visibility(valid, mask, len(lights) - 1)
    return gbuf, vises, counts


def gbuffer_production(bvh: WideBVH, mesh: Mesh, cam: Camera,
                       cfg: RenderConfig, attr_tables):
    """The unfused frame's G-buffer: the tile rasterizer
    (``gbuffer="raster"``; ``mesh`` on the device, no walk, zero counts)
    or the attribute-tracked closest hit on the camera-ordered accel.
    Returns (gbuf, walk counts)."""
    if cfg.gbuffer == "raster":
        gbuf = gbuffer_raster_pass(mesh, cam, cfg.width, cfg.height,
                                   cap_pairs=cfg.raster_cap_pairs or None)
        return gbuf, torch.zeros(2, dtype=torch.int32,
                                 device=bvh.nodes.device)
    return gbuffer_attr_pass(_gb_accel(bvh, cam, cfg), attr_tables, mesh,
                             cam, cfg.width, cfg.height)


def shadow_production(bvh: WideBVH, gbuf, light: Light, seed: int,
                      light_index: int, cfg: RenderConfig):
    """One light's unfused shadow pass on the accel as built (``tpurt``
    measured camera or light ordering as no gain for the any-hit walks).
    The tracers are ``tpurt``'s ``make_tracers`` any-hit half and its
    ``make_soft_tracer`` / ``make_point_soft_tracer`` without their gates:
    ``check_slice`` refuses the configs they would gate off (no portable
    traversal, no ray sorting), and the port's generator is real on every
    device. Returns (visibility, walk counts)."""
    return shadow_pass(
        functools.partial(trace_any, bvh), gbuf, light, cfg.spp, seed,
        light_index, cfg.shadow_bias,
        scene_bounds=(bvh.root_min, bvh.root_max),
        trace_soft=functools.partial(trace_any_soft, bvh),
        trace_soft_point=functools.partial(trace_any_point_soft, bvh))


def composite_lights(gbuf, shadows, lights: Sequence[Light],
                     cfg: RenderConfig) -> torch.Tensor:
    """Sum of per-light direct terms + one ambient term."""
    img = composite_pass(gbuf, shadows[0], lights[0], cfg.ambient,
                         cfg.background)
    valid = gbuf["valid"][..., None]
    for li in range(1, len(lights)):
        extra = composite_pass(gbuf, shadows[li], lights[li], 0.0,
                               (0.0, 0.0, 0.0))
        img = torch.where(valid, img + extra, img)
    return img


def render_frame_fn(bvh: WideBVH, mesh: Mesh, cam: Camera,
                    lights: Sequence[Light], cfg: RenderConfig,
                    attr_tables, seed: int = 0) -> Dict[str, torch.Tensor]:
    """One frame: G-buffer + the fused route's shadows -> the unfused
    shadow pass for every other light -> composite (sum of per-light
    direct terms + one ambient term). ``seed``: the frame's generator key
    (``frame_seed``); light i samples with the key (seed, i).
    ``walk_counts`` sums the walk counters of every launch of the frame."""
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
        gbuf, counts = gbuffer_production(bvh, mesh, cam, cfg, attr_tables)
        shadows = []
    for li in unfused_lights(route, len(lights)):
        vis, c = shadow_production(bvh, gbuf, lights[li], seed, li, cfg)
        shadows.append(vis)
        counts = counts + c
    return {"image": composite_lights(gbuf, shadows, lights, cfg),
            "shadow": torch.stack(shadows), **gbuf, "walk_counts": counts}


def _rebuild_fused(vertices: torch.Tensor, indices: torch.Tensor, mesh: Mesh,
                   leaf_size: int, nw_pad: int, split_blocks: int = 0,
                   attrs: bool = True):
    """Config 2's per-frame rebuild, no host sync (``tpurt``'s
    ``_rebuild_fused(collapse="area")``): the deferred-box build, the
    breadth-first area collapse into ``nw_pad`` rows and, with ``attrs``
    (``tables="attr"``), the attribute columns riding the sort and the
    attribute rows from them. The raster G-buffer reads no table: its
    rebuild (``tpurt``'s ``tables="sto"``, whose table only the deferred
    rasterizer reads) skips both. Returns (bvh, wide accel, (at0, at1) or
    None, count i32[]): count > nw_pad means the pad overflowed and the
    accel is truncated."""
    payload = attr_payload_columns(mesh, vertices.device) if attrs else ()
    built = build_lbvh(vertices, indices, leaf_size=leaf_size,
                       boxes="defer", extra_payload=payload,
                       split_blocks=split_blocks)
    bvh, cols = built if attrs else (built, ())
    wide, count = widen_area_kernel(bvh, nw_pad)
    at = leaf_attr_rows_from_sorted(cols, bvh.tri_id, bvh.num_blocks,
                                    leaf_size) if attrs else None
    return bvh, wide, at, count


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Renderer:
    """Owns the scene and its accel on ``device`` (the card unless the
    caller asks for ``"cpu"``) and renders frames.

    ``mode="static"`` builds the accel once; ``mode="rebuild"`` (config 2)
    rebuilds it at the start of every frame. ``config.gbuffer`` is
    resolved at construction (``use_raster_gbuffer``).

    ``stats`` holds times in milliseconds. Set-up: ``sah_build_ms`` (host
    SBVH build and conversion, copy to the device included),
    ``lbvh_build_ms`` (on-device Morton build) or, in rebuild mode,
    ``build_and_count_ms`` (a full-box build and the wide-node count that
    fixes the pad), ``collapse_ms`` (8-wide collapse) and
    ``attr_rows_ms`` (not on the raster G-buffer). Per frame in rebuild
    mode: ``build_ms``, the rebuild (CUDA events on the card, read after
    the frame's walk counters), and ``overflow_recoveries``, the rebuilds
    that outgrew the pad. ``raster_cap_growths``: frames rendered again
    because the binning overflowed ``config.raster_cap_pairs``."""

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
        # Rebuild mode counts the pad on the same (clustered) trees its
        # frames build; clustered rebuilds never camera-order the accel
        # (tpurt/app.py:656-675).
        self._rebuild_splits = 0
        if mode == "rebuild" and config.rebuild_splits:
            self._rebuild_splits = (
                auto_split_blocks(mesh.num_triangles, config.leaf_size)
                if config.rebuild_splits < 0 else config.rebuild_splits)
        config = dataclasses.replace(config, gbuffer="raster" if (
            use_raster_gbuffer(config, mode, self.device,
                               self._rebuild_splits)) else "ray")
        check_slice(config, mode, lights, mesh, cache_dir)
        if self._rebuild_splits:
            config = dataclasses.replace(config, order_children=False)
        self.config = config
        self._raster = config.gbuffer == "raster"
        self.mode = mode
        self.mesh = mesh
        self.camera = camera
        self.lights = lights
        self.route = frame_route(config, lights)
        self.frame_index = 0
        self.accum: Optional[torch.Tensor] = None
        self.stats: Dict[str, float] = {"raster_cap_growths": 0}
        self._nw_pad: Optional[int] = None
        self._geom_dirty = False

        if mode == "rebuild":
            self._setup_rebuild()
        else:
            t0 = time.perf_counter()
            if config.sah:
                self.bvh = build_sah_lbvh(mesh, self.device, config.leaf_size)
            else:
                dm = mesh.on(self.device)
                self.bvh = build_lbvh(dm.vertices, dm.indices,
                                      leaf_size=config.leaf_size)
            _sync(self.device)
            t1 = time.perf_counter()
            self.accel = self._make_accel()
            _sync(self.device)
            t2 = time.perf_counter()
            self.stats.update({
                "sah_build_ms" if config.sah else "lbvh_build_ms":
                    (t1 - t0) * 1e3,
                "collapse_ms": (t2 - t1) * 1e3})
            if self._raster:
                # The rasterizer bins the mesh on the device every frame.
                self.mesh = mesh.on(self.device)
                self.attr_tables = None
            else:
                self.attr_tables = make_leaf_attr_rows(self.bvh, mesh)
                _sync(self.device)
                self.stats["attr_rows_ms"] = (time.perf_counter() - t2) * 1e3
        self.depth = wide_depth(self.accel)
        check_stack_bound(self.depth)

    def _make_accel(self) -> WideBVH:
        """8-wide area collapse of a static tree. The leaf slots take the
        builder's stored (on SBVH: clipped) boxes."""
        nw_pad = round_up_bucket(max(count_wide(self.bvh), 1))
        plan = make_wide_plan(self.bvh, nw_pad)
        return widen_from_plan(plan, self.bvh, leaf_boxes_from_nodes(self.bvh))

    def _count_pad(self) -> int:
        """A full-box build of the current geometry and the padded count of
        its area collapse (host sync): the rebuild's ``nw_pad``."""
        self.bvh = build_lbvh(self.mesh.vertices, self.mesh.indices,
                              leaf_size=self.config.leaf_size,
                              split_blocks=self._rebuild_splits)
        return round_up_bucket(max(count_wide(self.bvh), 1))

    def _check_count(self, count: torch.Tensor) -> None:
        """Raise if a collapse outgrew the pad just counted (host sync)."""
        if int(count) > self._nw_pad:
            raise RuntimeError(f"the collapse made {int(count)} wide nodes "
                               f"in a pad of {self._nw_pad}")

    def _setup_rebuild(self) -> None:
        """Rebuild mode's set-up: the mesh on the device, the pad from a
        full-box build, and the set-up accel from that tree through the
        per-frame collapse, so its wide depth is checked against the stack
        once (frames rely on the walk counters)."""
        self.mesh = self.mesh.on(self.device)
        t0 = time.perf_counter()
        self._nw_pad = self._count_pad()
        t1 = time.perf_counter()
        self.accel, count = widen_area_kernel(self.bvh, self._nw_pad)
        self._check_count(count)
        t2 = time.perf_counter()
        self.stats.update(build_and_count_ms=(t1 - t0) * 1e3,
                          collapse_ms=(t2 - t1) * 1e3,
                          overflow_recoveries=0)
        self.attr_tables = None
        if not self._raster:
            self.attr_tables = make_leaf_attr_rows(self.bvh, self.mesh)
            _sync(self.device)
            self.stats["attr_rows_ms"] = (time.perf_counter() - t2) * 1e3

    def _rebuild(self):
        return _rebuild_fused(self.mesh.vertices, self.mesh.indices,
                              self.mesh, self.config.leaf_size,
                              self._nw_pad,
                              split_blocks=self._rebuild_splits,
                              attrs=not self._raster)

    def _update_bvh(self) -> None:
        """Rebuild the accel for this frame. The wide-node count is read
        back only after ``set_vertices``; if it outgrew the pad, the pad is
        recounted on a full-box build and the frame rebuilt with it.
        ``tpurt`` instead renders that full-box build's XLA area collapse:
        the same tree with its wide ids in binary-node order, where the
        rerun keeps the breadth-first ids every other frame has."""
        bvh, accel, at, count = self._rebuild()
        if self._geom_dirty:
            self._geom_dirty = False
            if int(count) > self._nw_pad:
                self._nw_pad = self._count_pad()
                self.stats["overflow_recoveries"] += 1
                bvh, accel, at, count = self._rebuild()
                self._check_count(count)
        self.bvh, self.accel, self.attr_tables = bvh, accel, at

    def set_vertices(self, vertices) -> None:
        """Animate (rebuild mode): new vertex positions f32[V, 3], same
        triangles. The vertex normals are recomputed on the device; the
        next frame's rebuild checks the pad against the new geometry."""
        if self.mode != "rebuild":
            raise NotImplementedError("set_vertices outside mode='rebuild' "
                                      "(the refit path) is not ported")
        v = torch.as_tensor(vertices, dtype=torch.float32,
                            device=self.device)
        self.mesh = dataclasses.replace(
            self.mesh, vertices=v,
            normals=smooth_normals_device(v, self.mesh.indices))
        self._geom_dirty = True

    def render_frame(self) -> Dict[str, torch.Tensor]:
        """Render one frame; returns the output dict (tensors on the
        Renderer's device). Rebuild mode first rebuilds the accel. The soft
        kernels draw this frame's samples from ``frame_seed(config.seed,
        frame_index)``. Raises if a walk overflowed its stack or hit the
        iteration cap. A raster frame whose binning overflowed the pair
        capacity is rendered again with the capacity doubled, and at least
        ``default_cap_rows`` (``tpurt/app.py:1055-1072``), so a frame with
        dropped coverage is never returned; the flag is read in the frame's
        one host read, with the walk counters."""
        cfg = self.config
        if self.mode == "rebuild":
            timer = _Stopwatch(self.device)
            self._update_bvh()
            timer.stop()
        out = render_frame_fn(self.accel, self.mesh, self.camera,
                              self.lights, cfg, self.attr_tables,
                              seed=frame_seed(cfg.seed, self.frame_index))
        flags = out["walk_counts"]
        if self._raster:
            flags = torch.cat([flags, out["raster_overflow"].reshape(1)
                               .to(flags.dtype)])
        flags = flags.cpu()
        if self._raster and bool(flags[2]):
            ntris = self.mesh.num_triangles
            cap = cfg.raster_cap_pairs or default_cap_rows(ntris)
            self.config = dataclasses.replace(
                cfg, raster_cap_pairs=max(2 * cap, default_cap_rows(ntris)))
            self.stats["raster_cap_growths"] += 1
            return self.render_frame()
        check_walk_counts(flags[:2])
        if self.mode == "rebuild":
            self.stats["build_ms"] = timer.ms()
        if cfg.accumulate:
            if self.accum is None:
                self.accum = out["image"]
            else:
                self.accum = accumulate(self.accum, self.frame_index,
                                        out["image"])
            out["image"] = self.accum
        self.frame_index += 1
        return out


class _Stopwatch:
    """Milliseconds of the work between construction and ``stop()``: CUDA
    events on the card (read later, without a sync of its own), the host
    clock on the CPU, where the work has finished when it returns."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._cuda:
            self._end.record()
        else:
            self._t1 = time.perf_counter()

    def ms(self) -> float:
        if self._cuda:
            self._end.synchronize()
            return self._start.elapsed_time(self._end)
        return (self._t1 - self._t0) * 1e3
