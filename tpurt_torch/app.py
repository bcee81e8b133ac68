"""Renderer: the static-scene frames and the per-frame rebuild
(counterpart of the static and rebuild slices of ``tpurt/app.py``).

One fused frame: camera rays -> near-first child ordering of the accel ->
ONE fused kernel launch -> G-buffer decode -> composite. The kernel finds
the closest hit with the winner's shading attributes, then traces the
light set's shadows from the biased hit point. Where the launch takes
every light, with the leaf attribute rows and an untextured mesh
(``resolves``), the decode, the visibility and the composite are ONE
step (``kernels/resolve.frame_resolve``): on the card the resolve kernel
writes every output straight from the launch's packets, on the CPU its
plain version runs the tensor code. The unfused frame of one sampled
light on the same accel and tables (``resolves_unfused``) resolves too:
the closest attribute walk's channels stay in packets, one kernel writes
the sampler's biased origins from them (``unfused_origins`` of
``kernels/resolve.py``), and the resolve takes the sampler's counts. With
``inkernel_attrs=False`` the frame reads the packed shade table instead of
the leaf attribute rows: the kernels (their attrs=0 variants, and the
plain closest hit on the unfused route) return t and the sorted hit index,
and the G-buffer gathers one table row per pixel (``gbuf_from_table``).
Which kernel runs follows ``tpurt``'s routing order (``render_frame_fn``):

1. fusedN: every light hard (directional; point or cone at spp 1) and at
   least two of them -> one hard walk per light, an occlusion bitmask;
2. fusedSM: a soft light 0 (cone or point at spp > 1) with hard
   directional extras -> light-0 sample counts plus a bitmask;
3. fused0: light 0 (any number of lights) -> its hard shadow, cone samples
   or disk samples;
4. unfused (``fused_shadow=False``, or the raster G-buffer): the
   closest-hit kernel alone (attribute-tracked, or the plain one with the
   shade table, seeded by the first-hit walk with ``seeded_gbuffer``), or
   the tile rasterizer.

Every light that no fused kernel took (lights 1.. after fused0, every
light after unfused) goes through the unfused shadow pass
(``passes/shadow.py``): one any-hit launch per hard light, one in-kernel
cone or disk sampler launch per soft light, on the accel as built (the
G-buffer walks the camera-ordered copy, as in ``tpurt``).

Unlike ``tpurt`` the soft paths are not gated on the backend: the port's
in-kernel generator is real on the CPU too. In ``mode="static"`` the accel
is built once per scene: host SBVH build (or, with ``sah=False`` or
without the native library, the on-device Morton build, as ``tpurt``
does), 8-wide area collapse, leaf attribute rows or the shade table. In
``mode="rebuild"`` (config 2) every frame rebuilds it on the device
(``_rebuild_fused``): Morton codes, one payload sort, sub-leaf clustering,
the topology kernel, the breadth-first area collapse kernel (or, with
``rebuild_collapse="fixed"``, the depth-3 cut masked by the topology
kernel's depth output) and the attribute rows or the shade table, with
no host sync unless the geometry changed; ``top_sah`` (on the plain
tree, ``rebuild_splits=0``) steers the top splits by the sweep-SAH
kernel. A textured mesh (``io/obj.py``) renders on every route: the
attribute kernels' attrs=2 variants carry each winner's uv and layer, and
the albedo is sampled from the atlas as a post-pass on every G-buffer
(``passes/texture.py``). On the H100 the accel lives in device memory, so
the TPU package's VMEM budgets and chunked split have no counterpart
here.

The primary visibility follows ``tpurt``'s choice of strategy
(``use_raster_gbuffer``): ``gbuffer="auto"`` takes the ray cast on an SBVH
accel and on a clustered rebuild, and otherwise the tile rasterizer on the
card, the compiled backend, and the ray cast on the CPU, where ``tpurt``
keeps the ray cast in interpret mode. The raster G-buffer
(``passes/gbuffer.gbuffer_raster_pass``: on-device binning, one
rasterizer launch, decode) builds no attribute rows, and every light goes
through the unfused shadow pass on the accel as built. With
``raster_deferred`` the z-only rasterizer returns each pixel's triangle
and barycentrics, and one row of the original-order shade table
(``make_shade_table_orig``, per rebuild in rebuild mode) per pixel gives
the position and shading. A frame whose binning overflowed the pair
capacity is rendered again with a bigger one.

``bvh_width=2`` walks the binary LBVH packed into the binary kernels'
rows (``kernels/pack.py``): the on-device Morton build, packed once per
scene in ``mode="static"`` (``tpurt`` packs per call; the rows are the
same) or rebuilt and packed every frame with ``rebuild_splits=0``. As in
``tpurt``, no fused kernel takes a binary accel: the frame is unfused,
with the shade-table G-buffer (the binary closest hit, then one table
row per pixel), the raster G-buffer where "auto" resolves to it, and the
binary any hit for every light; a soft light loops over its samples
(``tpurt`` gives its in-kernel samplers to the 8-wide accel alone).
``render_frame_fn`` also takes a plain ``LBVH`` with no tables at all
(``tpurt``'s ``__graft_entry__.entry()`` route): the G-buffer then reads
the mesh by triangle id (``passes/gbuffer.shade_attributes``).

``render_frame_fn`` and ``gbuffer_attr_pass`` also take a WideBVHT
(``bvh/wide.build_wide_t``: the same nodes, the leaf triangles
transposed, leaf 8 or 16), as ``tpurt`` does: the frame is unfused, the
G-buffer walks the accel as it is (no child ordering, no seed) with the
w8t closest hit and the shade table or ``shade_attributes``
(``attr_tables`` are ignored), every light takes the w8t any hit, a soft
light the pass's loop over samples. The Renderer never builds one, as
``tpurt``'s does not.

Everything outside this slice raises ``NotImplementedError`` naming the
missing piece; nothing falls back to another path or device.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Optional, Sequence, Union

import torch

from .bvh.lbvh import auto_split_blocks, build_lbvh, delta_range
from .bvh.sah import build_sah_lbvh
from .bvh.wide import (WideBVH, WideBVHT, count_wide,
                       leaf_boxes_from_nodes,
                       make_wide_plan, order_children_for_point,
                       round_up_bucket, wide_count_device, wide_depth,
                       widen_area_kernel, widen_from_plan, widen_lbvh)
from .camera import generate_rays
from .kernels.pack import binary_vmem_bytes, pack_bvh, tree_depth
from .kernels.traverse import (CLOSEST, HARD, MAX_MASK_LIGHTS, MULTI, PSOFT,
                               SOFT, SOFT_MULTI, _fused_launch, as_packed,
                               check_binary_stack_bound,
                               check_stack_bound, check_walk_counts,
                               closest_attrs_inputs,
                               closest_multi_shadow_inputs,
                               closest_point_soft_shadow_inputs,
                               closest_shadow_inputs,
                               closest_soft_multi_shadow_inputs,
                               closest_soft_shadow_inputs, is_binary,
                               trace_any, trace_any_point_soft,
                               trace_any_soft, trace_closest)
from .kernels.resolve import frame_resolve, unfused_origins
from .passes.composite import accumulate, composite_lights
from .frame_block import FrameBlock
from .graphs import (FrameGraphs, RebuildGraph, capture_key, rebuild_key,
                     rebuild_takes_graph, takes_graph)
from .native import available as native_available
from .passes.gbuffer import (gbuf_from_attr_channels, gbuf_from_table,
                             gbuffer_attr_pass, gbuffer_pass,
                             gbuffer_raster_pass)
from .passes.shadow import (COUNTS, COUNTS_MASK, MASK, OCCLUDED, cone_cos,
                            fused_visibility, shadow_pass)
from .passes.shading import (attr_payload_columns, leaf_attr_rows_from_sorted,
                             make_leaf_attr_rows, make_shade_table,
                             make_shade_table_orig, smooth_normals_device)
from .passes.texture import apply_textures
from .raster.setup import default_cap_rows
from .spans import (Spans, count, drop_counts, graph_frame, host_read,
                    rebuild_graph_frame, span)
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


def frame_route(cfg: RenderConfig, lights, accel=None) -> str:
    """The path a frame takes, in ``tpurt``'s order: "fusedN", "fusedSM",
    "fused0" (light 0 whatever the number of lights) or "unfused" (no
    fused kernel). ``accel``: the accel the frame walks, where it is known;
    every fused kernel needs the 8-wide row-layout one (``tpurt``'s gates
    ask for a WideBVH), so a binary accel, a WideBVHT, or ``bvh_width=2``
    where ``accel`` is not given, routes "unfused"."""
    binary = cfg.bvh_width == 2 if accel is None else is_binary(accel)
    if binary or isinstance(accel, WideBVHT):
        return "unfused"
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
    stands; "auto" takes the ray cast on an SBVH accel (static, ``sah``:
    the Renderer passes the effective flag, False without the native
    library) and on a clustered rebuild (``split_blocks``, the resolved
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


# tpurt's budget for the binary kernels' VMEM-resident rows
# (Renderer._check_vmem_budget): past it, tpurt traces with its portable
# traversal instead.
BINARY_BUDGET_BYTES = 20_000_000
BINARY_OVERHEAD_BYTES = 1_500_000


def check_slice(config: RenderConfig, mode: str, lights: Sequence[Light],
                mesh: Mesh, cache_dir: Optional[str],
                split_blocks: int = 0) -> None:
    """Raise NotImplementedError for anything the port does not cover yet.
    ``config.gbuffer`` is resolved ("ray" or "raster"); ``split_blocks``:
    the rebuild's resolved sub-leaf clustering."""
    if mode not in ("static", "rebuild", "refit"):
        raise ValueError(f"mode={mode!r}")
    missing = []
    if mode == "refit":
        missing.append("mode='refit' (per-frame refit)")
    if mode == "rebuild":
        if config.rebuild_collapse not in ("area", "fixed"):
            missing.append(f"rebuild_collapse={config.rebuild_collapse!r} "
                           "(tpurt collapses by 'area' or 'fixed')")
        if config.top_sah and split_blocks:
            missing.append(
                "top_sah with sub-leaf clustering (rebuild_splits="
                f"{config.rebuild_splits}, {split_blocks} blocks): tpurt's "
                "build_lbvh asserts that split_blocks and top_sah are "
                "exclusive; rebuild_splits=0 rebuilds the steered plain tree")
    binary = config.bvh_width == 2
    if config.bvh_width not in (2, 8):
        missing.append(f"bvh_width={config.bvh_width} (tpurt walks 2- or "
                       "8-wide trees)")
    if binary and mode == "rebuild" and config.rebuild_splits != 0:
        missing.append(
            "a clustered binary rebuild (bvh_width=2 with rebuild_splits="
            f"{config.rebuild_splits}): tpurt's pack_bvh fails on a sub-leaf "
            "clustered tree; rebuild_splits=0 rebuilds the plain tree")
    if binary and config.use_pallas:
        need = binary_vmem_bytes(mesh.num_triangles, config.leaf_size) \
            + BINARY_OVERHEAD_BYTES
        if need > BINARY_BUDGET_BYTES:
            missing.append(
                f"a binary scene of {need} bytes past tpurt's "
                f"{BINARY_BUDGET_BYTES}-byte budget at leaf_size="
                f"{config.leaf_size}, where tpurt falls back to its portable "
                "traversal (use_pallas=False)")
    if not config.use_pallas:
        missing.append("use_pallas=False (portable traversal)")
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


def _gb_accel(bvh, cam: Camera, cfg: RenderConfig):
    """The accel the G-buffer walks: the 8-wide one ordered near-first for
    the camera (``order_children``); a binary accel or a WideBVHT as it
    is, since ``tpurt`` orders only WideBVH children."""
    with span("tpurt.order"):
        if not isinstance(bvh, WideBVH) or not cfg.order_children:
            return bvh
        return order_children_for_point(bvh, cam.position)


def _apply_mesh_textures(gbuf, mesh: Mesh):
    """A textured mesh's albedo sampled from its atlas as a post-pass on
    every G-buffer (``tpurt``'s ``_apply_mesh_textures``): from the
    G-buffer's uv and layer where it carries them, else from (tri_id,
    position). ``mesh`` is moved to the G-buffer's device, a no-op for the
    Renderer's, which lives there."""
    if mesh.textured:
        gbuf = {**gbuf, "albedo": apply_textures(
            mesh.on(gbuf["valid"].device), gbuf)}
    return gbuf


def _fused_gbuf(launch, attr_tables, shade_table, mesh: Mesh, cam: Camera,
                cfg: RenderConfig, device):
    """Camera rays -> ``launch(origins, dirs)``, the route's fused launch,
    unpacked -> the G-buffer: from the attribute channels with the leaf
    attribute rows, else from t and the sorted index through the shade
    table (``gbuf_from_table``), then the mesh's textures. Returns (gbuf,
    the launch's shadow outputs, walk counts)."""
    with span("tpurt.rays"):
        origins, dirs = generate_rays(cam, cfg.width, cfg.height, device)
    with span("tpurt.walk"):
        res = launch(origins, dirs).unpacked()
    with span("tpurt.gbuffer"):
        if attr_tables is not None:
            ch, *shadow, counts = res
            gbuf = gbuf_from_attr_channels(ch, origins, dirs, cam, mesh)
        else:
            t, sidx, *shadow, counts = res
            gbuf = gbuf_from_table(t, None, sidx, origins, dirs, cam, mesh,
                                   shade_table)
        return _apply_mesh_textures(gbuf, mesh), shadow, counts


def fused_launch(route: str, gb_accel, lights: Sequence[Light],
                 cfg: RenderConfig, seed, bias, attr_tables, textured: bool):
    """The fused launch of ``route`` on the camera-ordered accel ->
    (``launch(origins, dirs)``, which makes ONE launch of the route's
    fused walk and returns its ``FusedLaunch``; the kind of the launch's
    shadow output, ``passes/shadow.py``). fusedN: one hard walk per light
    (points by position, the rest along their direction); fusedSM: light
    0's disk or cone samples, the extras' directions; fused0: light 0
    disk-sampled (a point light at spp > 1), cone-sampled (an area light
    at spp > 1) or hard (directional, point, or a cone at spp 1 along its
    axis)."""
    def bind(mode, inputs, **spec):
        return (lambda o, d: _fused_launch(
            mode, inputs(gb_accel, o, d, bias=bias, attr_tables=attr_tables,
                         **spec), attr_tables, textured))
    if route == "fusedN":
        spec = [(None, l.position) if l.kind == LIGHT_POINT
                else (l.direction, None) for l in lights]
        return bind(MULTI, closest_multi_shadow_inputs, lights=spec), MASK
    light = lights[0]
    if route == "fusedSM":
        light0 = ("disk", light.position, light.radius) \
            if light.kind == LIGHT_POINT \
            else ("cone", light.direction, cone_cos(light))
        extra = [l.direction for l in lights[1:]]
        return bind(SOFT_MULTI, closest_soft_multi_shadow_inputs,
                    light0=light0, extra_dirs=extra, spp=cfg.spp,
                    seed=seed), COUNTS_MASK
    if light.kind == LIGHT_POINT and cfg.spp > 1:
        return bind(PSOFT, closest_point_soft_shadow_inputs,
                    light_pos=light.position, radius=light.radius,
                    spp=cfg.spp, seed=seed), COUNTS
    if light.kind == LIGHT_AREA_CONE and cfg.spp > 1:
        return bind(SOFT, closest_soft_shadow_inputs,
                    axis_dir=light.direction, cone_cos=cone_cos(light),
                    spp=cfg.spp, seed=seed), COUNTS
    lpos = light.position if light.kind == LIGHT_POINT else None
    return bind(HARD, closest_shadow_inputs, light_dir=light.direction,
                light_pos=lpos), OCCLUDED


def gbuffer_fused_production(route: str, bvh: WideBVH, mesh: Mesh,
                             cam: Camera, cfg: RenderConfig,
                             lights: Sequence[Light], attr_tables, seed=0,
                             shade_table=None, bias=None):
    """ONE kernel launch of ``route``'s fused walk (``fused_launch``)
    returns the hit set and the visibility of each light it takes: every
    light (fusedN, fusedSM) or light 0 (fused0); a sampled light's
    visibility is 1 - counts / spp. The hit set carries its shading
    attributes (``attr_tables``) or keys the shade table (attrs=0).
    ``bias``: the kernel's shadow bias, ``cfg.shadow_bias`` or the block's
    view of it. Returns (gbuf, [visibility per light taken], walk
    counts)."""
    bias = cfg.shadow_bias if bias is None else bias
    gb_accel = _gb_accel(bvh, cam, cfg)
    launch, kind = fused_launch(route, gb_accel, lights, cfg, seed, bias,
                                attr_tables, mesh.textured)
    gbuf, shadow, counts = _fused_gbuf(launch, attr_tables, shade_table,
                                       mesh, cam, cfg, bvh.nodes.device)
    with span("tpurt.shadow"):
        n = 1 if route == "fused0" else len(lights)
        return (gbuf, fused_visibility(kind, gbuf["valid"], shadow, n,
                                       cfg.spp), counts)


def gbuffer_production(bvh, mesh: Mesh, cam: Camera, cfg: RenderConfig,
                       attr_tables, shade_table=None, shade_table_orig=None):
    """The unfused frame's G-buffer: the tile rasterizer
    (``gbuffer="raster"``; ``mesh`` on the device, no walk, zero counts;
    with ``raster_deferred`` the z-only one and ``shade_table_orig``),
    the attribute-tracked closest hit, the plain closest hit (seeded by
    the first-hit walk with ``seeded_gbuffer`` on the 8-wide accel) and
    the shade table's row gather (``attr_tables`` None), or, with neither
    table, the closest hit and ``shade_attributes``' gathers of the mesh
    (moved to the device here); on the camera-ordered accel, or on the
    binary one or a WideBVHT as it is, where ``attr_tables`` are ignored
    and no seed is asked for, as ``tpurt`` gates both on a WideBVH; then
    the mesh's textures. Returns (gbuf, walk counts)."""
    if cfg.gbuffer == "raster":
        with span("tpurt.gbuffer"):
            gbuf = gbuffer_raster_pass(
                mesh, cam, cfg.width, cfg.height, shade_table_orig,
                cap_pairs=cfg.raster_cap_pairs or None,
                deferred=cfg.raster_deferred)
            counts = torch.zeros(2, dtype=torch.int32,
                                 device=bvh.tri_id.device)
    else:
        gb_accel = _gb_accel(bvh, cam, cfg)
        if attr_tables is not None and isinstance(bvh, WideBVH):
            gbuf, counts = gbuffer_attr_pass(gb_accel, attr_tables, mesh, cam,
                                             cfg.width, cfg.height)
        elif shade_table is None:
            gbuf, counts = gbuffer_pass(
                lambda o, d: trace_closest(gb_accel, o, d),
                mesh.on(bvh.tri_id.device), cam, cfg.width, cfg.height)
        else:
            # tpurt's seeded G-buffer exists on the 8-wide accel alone.
            seeded = cfg.seeded_gbuffer and isinstance(gb_accel, WideBVH)
            gbuf, counts = gbuffer_pass(
                lambda o, d: trace_closest(gb_accel, o, d,
                                           return_sorted=True,
                                           gather_tri_id=False,
                                           seeded=seeded),
                mesh, cam, cfg.width, cfg.height, shade_table)
    with span("tpurt.gbuffer"):
        return _apply_mesh_textures(gbuf, mesh), counts


def shadow_production(bvh, gbuf, light: Light, seed,
                      light_index: int, cfg: RenderConfig):
    """One light's unfused shadow pass on the accel as built (``tpurt``
    measured camera or light ordering as no gain for the any-hit walks).
    The tracers are ``tpurt``'s ``make_tracers`` any-hit half and its
    ``make_soft_tracer`` / ``make_point_soft_tracer`` without their
    backend gates: ``check_slice`` refuses the configs they would gate off
    (no portable traversal, no ray sorting), and the port's generator is
    real on every device. As there, the samplers exist for the 8-wide
    row-layout accel alone: on a binary accel or a WideBVHT a soft light
    takes the pass's loop over samples. Returns (visibility, walk
    counts)."""
    wide = isinstance(bvh, WideBVH)
    return shadow_pass(
        functools.partial(trace_any, bvh), gbuf, light, cfg.spp, seed,
        light_index, cfg.shadow_bias,
        scene_bounds=(bvh.root_min, bvh.root_max),
        trace_soft=functools.partial(trace_any_soft, bvh) if wide else None,
        trace_soft_point=(functools.partial(trace_any_point_soft, bvh)
                          if wide else None))


def resolves(route: str, attr_tables, mesh: Mesh, n_lights: int) -> bool:
    """Does the frame resolve its fused launch in one step
    (``_resolved_frame``): a fused route whose launch takes every light,
    with the leaf attribute rows (attrs=1) and an untextured mesh? The
    others keep the decode, the visibility and the composite apart: the
    shade table's row gather (attrs=0), a textured mesh's albedo sampled
    from its atlas after the decode (attrs=2), fused0 with lights for the
    unfused shadow pass, the unfused route and the raster G-buffer."""
    return (route != "unfused" and attr_tables is not None
            and not mesh.textured and not unfused_lights(route, n_lights))


def _resolved_frame(bvh: WideBVH, mesh: Mesh, cam: Camera,
                    lights: Sequence[Light], cfg: RenderConfig, attr_tables,
                    seed, consts, route: str) -> Dict[str, torch.Tensor]:
    """A frame that ``resolves``: camera rays -> the fused launch, its
    outputs left in packets -> ``frame_resolve`` in ``tpurt.gbuffer``
    (the resolve kernel on the card, its plain version on the CPU) writes
    the G-buffer, every light's visibility and the image. ``tpurt.shadow``
    and ``tpurt.composite`` stay stages of the frame and launch nothing
    (a graph replay's output copies and the accumulation are
    ``tpurt.composite``'s)."""
    gb_accel = _gb_accel(bvh, cam, cfg)
    launch, kind = fused_launch(route, gb_accel, lights, cfg, seed,
                                consts.bias, attr_tables, False)
    with span("tpurt.rays"):
        origins, dirs = generate_rays(cam, cfg.width, cfg.height,
                                      bvh.nodes.device)
    with span("tpurt.walk"):
        packets = launch(origins, dirs)
    with span("tpurt.gbuffer"):
        out = frame_resolve(packets, kind, consts, cfg, mesh, origins, dirs)
    with span("tpurt.shadow"):
        pass
    with span("tpurt.composite"):
        return {**out, "walk_counts": packets.counts}


def resolves_unfused(route: str, cfg: RenderConfig, accel, attr_tables,
                     mesh: Mesh, lights: Sequence[Light]) -> bool:
    """Does the unfused frame resolve from its walks' packets
    (``_resolved_unfused_frame``): the unfused route with the ray-cast
    G-buffer on the 8-wide row-layout accel with its attribute rows
    (attrs=1), an untextured mesh, and one light, which the pass's
    in-kernel cone or disk sampler takes (a cone or a point light at spp >
    1)? The others keep the tensor code: a hard light (its ray batch), two
    or more lights, a textured mesh, the raster G-buffer, the shade table,
    a binary accel or a WideBVHT (their walks and the pass's loop over
    samples) and every fused route."""
    return (route == "unfused" and attr_tables is not None
            and isinstance(accel, WideBVH) and cfg.gbuffer != "raster"
            and not mesh.textured and len(lights) == 1
            and _soft(lights[0], cfg.spp))


def _resolved_unfused_frame(bvh: WideBVH, mesh: Mesh, cam: Camera,
                            lights: Sequence[Light], cfg: RenderConfig,
                            attr_tables, seed,
                            consts) -> Dict[str, torch.Tensor]:
    """A frame that ``resolves_unfused``: camera rays -> the closest
    attribute walk on the camera-ordered accel, its channels left in
    packets -> in ``tpurt.gbuffer`` the sampler's biased origins straight
    from them (``unfused_origins``) -> in ``tpurt.shadow`` the cone or disk
    sampler on the accel as built, its counts left in packets -> in
    ``tpurt.gbuffer`` ``frame_resolve`` (kind ``COUNTS``) writes the
    G-buffer, the visibility and the image. On the card two kernels
    replace the tensor code; on the CPU their plain versions run it. The
    stages and the ``shadow_rays`` count are the unfused frame's."""
    gb_accel = _gb_accel(bvh, cam, cfg)
    with span("tpurt.rays"):
        origins, dirs = generate_rays(cam, cfg.width, cfg.height,
                                      bvh.nodes.device)
    with span("tpurt.walk"):
        closest = _fused_launch(CLOSEST, closest_attrs_inputs(
            gb_accel, origins, dirs, attr_tables), attr_tables, False)
    with span("tpurt.gbuffer"):
        block = unfused_origins(closest, consts, mesh, origins, dirs)
    with span("tpurt.shadow"):
        count("shadow_rays", lambda: (block[:, 3] > 0.0).sum() * cfg.spp)
        packed = (block, closest.p, closest.meta)
        light = lights[0]
        with span("tpurt.walk"):
            if light.kind == LIGHT_AREA_CONE:
                cnt, counts = trace_any_soft(
                    bvh, None, None, light.direction, cone_cos(light),
                    cfg.spp, seed, packed=packed)
            else:
                cnt, counts = trace_any_point_soft(
                    bvh, None, None, light.position, light.radius, cfg.spp,
                    seed, packed=packed)
    with span("tpurt.gbuffer"):
        out = frame_resolve(dataclasses.replace(closest, shadow=(cnt,)),
                            COUNTS, consts, cfg, mesh, origins, dirs)
    with span("tpurt.composite"):
        return {**out, "walk_counts": closest.counts + counts}


def render_frame_fn(bvh, mesh: Mesh, cam: Camera,
                    lights: Sequence[Light], cfg: RenderConfig,
                    attr_tables=None, seed: int = 0,
                    shade_table=None,
                    shade_table_orig=None,
                    consts=None) -> Dict[str, torch.Tensor]:
    """One frame: G-buffer + the fused route's shadows -> the unfused
    shadow pass for every other light -> composite (sum of per-light
    direct terms + one ambient term). ``bvh``: the 8-wide accel, or a
    binary one (a PackedBVH, or an LBVH, packed here once for the frame,
    which ``tpurt`` does per call) or a WideBVHT (the w8t walks), which
    no fused kernel takes. The hit set reads the leaf attribute rows
    ``attr_tables`` (the row-layout 8-wide accel only; a WideBVHT ignores
    them, as ``tpurt`` does) or,
    without them, the packed ``shade_table``; with neither (the raster
    G-buffer, or ``tpurt``'s compile-check entry on a plain LBVH) no fused
    kernel runs, as ``tpurt``'s ``tabs`` gate has it, and the ray cast
    reads the mesh by triangle id. ``shade_table_orig``: the
    original-order table the deferred raster G-buffer
    (``raster_deferred``) reads. ``seed``: the frame's generator key
    (``frame_seed``); light i samples with the key (seed, i).
    ``walk_counts`` sums the walk counters of every launch of the
    frame. ``consts``: the frame's views of a block of constants already
    written (``FrameBlock.write``, the Renderer's own); without them the
    frame writes ``cam``, ``lights``, ``cfg`` and ``seed`` into a block
    of its own. The device reads every per-frame value through them."""
    if consts is None:
        consts = FrameBlock(len(lights), bvh.tri_id.device).write(
            cam, lights, cfg, seed)
    cam, lights, seed = consts.camera, consts.lights, consts.seed
    if is_binary(bvh):
        if attr_tables is not None:
            raise ValueError("a binary accel has no leaf attribute rows")
        bvh = as_packed(bvh)
        if bvh.root_min is None:
            raise ValueError("the binary accel needs its scene box "
                             "(root_min, root_max) for the shadow pass")
    tabs = attr_tables is not None or shade_table is not None
    route = frame_route(cfg, lights, bvh) if tabs else "unfused"
    if resolves(route, attr_tables, mesh, len(lights)):
        return _resolved_frame(bvh, mesh, cam, lights, cfg, attr_tables,
                               seed, consts, route)
    if resolves_unfused(route, cfg, bvh, attr_tables, mesh, lights):
        return _resolved_unfused_frame(bvh, mesh, cam, lights, cfg,
                                       attr_tables, seed, consts)
    if route == "unfused":
        gbuf, counts = gbuffer_production(bvh, mesh, cam, cfg, attr_tables,
                                          shade_table, shade_table_orig)
        shadows = []
    else:
        gbuf, shadows, counts = gbuffer_fused_production(
            route, bvh, mesh, cam, cfg, lights, attr_tables, seed,
            shade_table, consts.bias)
    for li in unfused_lights(route, len(lights)):
        with span("tpurt.shadow"):
            vis, c = shadow_production(bvh, gbuf, lights[li], seed, li, cfg)
            shadows.append(vis)
            counts = counts + c
    with span("tpurt.composite"):
        return {"image": composite_lights(gbuf, shadows, lights, cfg,
                                          consts.background),
                "shadow": torch.stack(shadows), **gbuf,
                "walk_counts": counts}


def _rebuild_fused(vertices: torch.Tensor, indices: torch.Tensor, mesh: Mesh,
                   leaf_size: int, nw_pad: int, split_blocks: int = 0,
                   tables: Optional[str] = "attr", collapse: str = "area",
                   top_sah=False):
    """Config 2's per-frame rebuild, no host sync (``tpurt``'s
    ``_rebuild_fused``): the deferred-box build, the 8-wide collapse into
    ``nw_pad`` rows and the shading table the frame reads. ``collapse``:
    "area", the breadth-first area collapse kernel, or "fixed", the
    depth-3 cut (``widen_lbvh(mode="fixed")``) masked by the topology
    kernel's depth output, its count a device scalar. ``top_sah``: the
    sweep-SAH kernel steers the tree's top splits (``build_lbvh``); the
    fixed cut's stack is then left to the walk counters (decision 18).
    ``tables="attr"``: the attribute columns riding the sort (a textured
    mesh's layer and uv columns too) and the attribute rows from them;
    ``"st"``, the packed
    shade table of the rebuilt, payload-sorted tree (``tpurt``'s
    ``tables="st"``, whose original-order table only the deferred
    rasterizer reads); ``"sto"``, that original-order table, which the
    deferred raster G-buffer reads; None for the 32-float raster G-buffer,
    which reads no table. Returns (bvh, wide accel, (at0, at1) or a shade
    table or None, count i32[]): count > nw_pad means the pad overflowed
    and the accel is truncated."""
    if tables not in ("attr", "st", "sto", None):
        raise ValueError(f"tables={tables!r}")
    if collapse not in ("area", "fixed"):
        raise ValueError(f"collapse={collapse!r}")
    attrs = tables == "attr"
    fixed = collapse == "fixed"
    with span("tpurt.rebuild.build"):
        payload = attr_payload_columns(mesh, vertices.device) if attrs \
            else ()
        built = build_lbvh(vertices, indices, leaf_size=leaf_size,
                           boxes="defer", extra_payload=payload,
                           want_depth=fixed, split_blocks=split_blocks,
                           top_sah=top_sah)
    if not isinstance(built, tuple):
        built = (built,)
    bvh = built[0]
    cols = built[1] if attrs else ()
    with span("tpurt.rebuild.collapse"):
        if fixed:
            depth = built[-1]
            if not top_sah:
                # A steered tree's bound passes the stack: its frames rely
                # on the walk counters (decision 18).
                check_stack_bound(FIXED_CUT_DEPTH_BOUND)
            wide = widen_lbvh(bvh, nw_pad, mode="fixed", depths=depth)
            count = wide_count_device(bvh, mode="fixed", depths=depth)
        else:
            wide, count = widen_area_kernel(bvh, nw_pad)
    table = None
    with span("tpurt.rebuild.tables"):
        if attrs:
            table = leaf_attr_rows_from_sorted(cols, bvh.tri_id,
                                               bvh.num_blocks, leaf_size,
                                               mesh.textured)
        elif tables == "st":
            table = make_shade_table(bvh, mesh)
        elif tables == "sto":
            table = make_shade_table_orig(mesh.on(vertices.device))
    return bvh, wide, table, count


def karras_depth_bound(d_max: int) -> int:
    """The deepest internal node of a tree built over priorities in [0,
    d_max) (``bvh.lbvh.delta_range``): they grow strictly from a node to
    its children, so the binary stack bound holds for every rebuilt tree
    without a read of its depth."""
    return d_max - 1


def fixed_cut_depth_bound(d_max: int) -> int:
    """The fixed cut's wide levels over such a tree: its wide nodes are
    the binary ones at depth 0, 3, ...."""
    return karras_depth_bound(d_max) // 3 + 1


# The Morton tree's bounds: 95 binary levels; 32 wide levels, whose
# per-ray stack needs 7 * 32 + 1 = 225 <= STACK_CAPACITY entries, so every
# unsteered fixed rebuild is checked without a read-back. A tree steered
# by top_sah (maxd 21) can be 116 levels deep, 39 wide levels of the fixed
# cut, which would need 274 entries: its frames rely on the walk
# counters, as every area-collapse frame does (decision 18).
KARRAS_DEPTH_BOUND = karras_depth_bound(delta_range())
FIXED_CUT_DEPTH_BOUND = fixed_cut_depth_bound(delta_range())


def _rebuild_binary(vertices: torch.Tensor, indices: torch.Tensor,
                    mesh: Mesh, leaf_size: int, tables: Optional[str] = "st",
                    top_sah=False):
    """``bvh_width=2``'s per-frame rebuild, no host sync (``tpurt``'s
    ``_build_jit`` and ``_make_accel`` on a binary config): the full-box
    Morton build (steered by ``top_sah``), the packed rows and the shade
    table of the rebuilt tree (``tables="st"``), the original-order table
    (``"sto"``, the deferred raster G-buffer) or none (None, the raster
    G-buffer). Returns (bvh, packed accel, table or None)."""
    if tables not in ("st", "sto", None):
        raise ValueError(f"tables={tables!r}")
    bvh = build_lbvh(vertices, indices, leaf_size=leaf_size, top_sah=top_sah)
    check_binary_stack_bound(karras_depth_bound(delta_range(top_sah)))
    table = None
    if tables == "st":
        table = make_shade_table(bvh, mesh)
    elif tables == "sto":
        table = make_shade_table_orig(mesh.on(vertices.device))
    return bvh, pack_bvh(bvh), table


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Renderer:
    """Owns the scene and its accel on ``device`` (the card unless the
    caller asks for ``"cpu"``) and renders frames.

    ``mode="static"`` builds the accel once; ``mode="rebuild"`` (config 2)
    rebuilds it at the start of every frame. ``config.gbuffer`` is
    resolved at construction (``use_raster_gbuffer``).

    ``mode="static"`` takes the host SBVH build when ``config.sah`` is
    set, the accel is 8-wide and the native library builds and loads
    (``native.available``); otherwise it builds on the device, as
    ``tpurt`` does, and "auto" resolves as for ``sah=False``. With
    ``bvh_width=2`` the accel is the packed binary tree, built once or
    (``mode="rebuild"``, ``rebuild_splits=0``) every frame.
    ``rebuild_threshold`` is stored for refit mode, which is not ported.
    ``config.inkernel_attrs=False`` makes the frames read the packed shade
    table (``shade_table``) in place of the leaf attribute rows
    (``attr_tables``).

    ``stats`` holds times in milliseconds. Set-up: ``sah_build_ms`` (host
    SBVH build and conversion, copy to the device included),
    ``lbvh_build_ms`` (on-device Morton build) or, in rebuild mode,
    ``build_and_count_ms`` (a full-box build and the wide-node count that
    fixes the pad), ``collapse_ms`` (8-wide collapse) or, with
    ``bvh_width=2`` (static or rebuild), ``lbvh_build_ms`` and ``pack_ms``
    (the binary rows), and ``attr_rows_ms`` or ``shade_table_ms`` (not on
    the raster G-buffer). ``depth``: the accel's depth the per-ray stack
    was checked against.
    Per frame in rebuild
    mode: ``build_ms``, the rebuild (CUDA events on the card, read after
    the frame's walk counters), and ``overflow_recoveries``, the rebuilds
    that outgrew the pad. ``raster_cap_growths``: frames rendered again
    because the binning overflowed ``config.raster_cap_pairs``.

    ``graph_captures`` and ``graph_replays``: the captures of a frame's
    stages into CUDA graphs and the frames that replayed them.

    In rebuild mode the Renderer owns the mesh's vertex and normals
    buffers for its life: ``set_vertices`` copies each pose into the
    first, and each rebuild after it computes the pose's normals into the
    second. On the card the rebuild, from those buffers to the wide-node
    count, replays as one CUDA graph (``graphs.RebuildGraph``: the first
    rebuild of a capture key runs eagerly, the second captures), whose
    outputs ``bvh``, ``accel`` and the table are, each replay writing
    them in place; the frame's stages run eagerly after it.

    Every frame writes its host constants (camera, lights, bias,
    background, frame seed) into the Renderer's block on the device with
    one copy that does not wait (``frame_block.FrameBlock``), and reads
    them there. A static frame on the card, ray-cast or rasterized,
    replays its stages as CUDA graphs (``graphs.py``: the first frame of
    a capture key runs eagerly, the second captures), and returns copies
    of the graphs' outputs; every other frame runs its stages eagerly.

    ``spans`` (``spans.Spans``) holds the frames rendered while a torch
    profiler records: their count, their host syncs (every read of a
    device value and every copy of host data onto the card), the ones
    that replayed CUDA graphs, those whose rebuild replayed its graph
    (``rebuild_graph_frames``) and, per stage span, the sums of its
    device-timeline ms, self ms, host ms and entries. The spans, each
    also a ``record_function`` on the profiler's timeline:
    ``tpurt.frame``, the whole frame; ``tpurt.rebuild`` (rebuild
    mode, around which ``build_ms`` is timed) with ``.build``,
    ``.collapse``, ``.tables`` (which record nothing where the rebuild
    replays its graph) and ``.count_read``; ``tpurt.order``,
    ``tpurt.rays``, ``tpurt.walk``, ``tpurt.gbuffer``, ``tpurt.shadow``,
    ``tpurt.composite``; ``tpurt.read``, the frame's host read and its
    checks. The raster G-buffer nests ``tpurt.gbuffer.bin`` (the binning)
    and ``tpurt.gbuffer.raster`` (the rasterizer launch) in
    ``tpurt.gbuffer``, and counts the binned (row, tile) pairs
    (``spans.counts["raster_pairs"]``, carried by the frame's host read);
    the unfused shadow pass nests each walk, ``tpurt.walk``, in
    ``tpurt.shadow``, and counts the live shadow rays its walks trace
    (``spans.counts["shadow_rays"]``, carried by the same read). A frame
    that replays CUDA graphs records the same spans, nested as they are,
    and the same counters. Without a profiler the frame records
    nothing."""

    def __init__(self, mesh: Mesh, camera: Camera,
                 lights: Union[Light, Sequence[Light]],
                 config: RenderConfig = RenderConfig(),
                 mode: str = "static", rebuild_threshold: float = 1.6,
                 cache_dir: Optional[str] = None, *, device="cuda"):
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
        # The host SBVH build needs the native library and the 8-wide
        # kernels; without either the static scene builds on the device
        # and "auto" resolves as for sah=False (tpurt/app.py:641-652).
        self._use_sah = (config.sah and mode != "rebuild"
                         and config.use_pallas and config.bvh_width == 8
                         and native_available())
        raster = use_raster_gbuffer(
            dataclasses.replace(config, sah=self._use_sah), mode,
            self.device, self._rebuild_splits)
        config = dataclasses.replace(config,
                                     gbuffer="raster" if raster else "ray")
        check_slice(config, mode, lights, mesh, cache_dir,
                    self._rebuild_splits)
        if self._rebuild_splits:
            config = dataclasses.replace(config, order_children=False)
        self.config = config
        self._raster = config.gbuffer == "raster"
        self._binary = config.bvh_width == 2
        # The table the frames read: none on the raster G-buffer, else the
        # leaf attribute rows or the shade table (tpurt's _use_attrs, whose
        # VMEM budget has no counterpart on the card). Attribute rows
        # exist for the 8-wide accel alone (tpurt's _make_accel), so a
        # binary frame reads the shade table, and so does the seeded
        # G-buffer, which exists on the shade-table path alone. The
        # deferred raster G-buffer reads the original-order table
        # (tpurt's "sto").
        if self._raster:
            self._tables = "sto" if config.raster_deferred else None
        else:
            self._tables = "attr" if (
                config.inkernel_attrs and not self._binary
                and not config.seeded_gbuffer) else "st"
        self.mode = mode
        # tpurt steers only the per-frame rebuild's trees (_build_jit).
        self._top_sah = config.top_sah if mode == "rebuild" else False
        self.rebuild_threshold = rebuild_threshold
        self.mesh = mesh
        self.camera = camera
        self.lights = lights
        self.route = frame_route(config, lights)
        self.frame_index = 0
        self.accum: Optional[torch.Tensor] = None
        self.stats: Dict[str, float] = {"raster_cap_growths": 0,
                                        "graph_captures": 0,
                                        "graph_replays": 0}
        self.spans = Spans(self.device)
        self._block = FrameBlock(len(lights), self.device)
        self._graphs: Optional[FrameGraphs] = None
        self._rebuild_graph: Optional[RebuildGraph] = None
        self._posed = False
        self._nw_pad: Optional[int] = None
        self._geom_dirty = False
        self.attr_tables = None
        self.shade_table = None
        self.shade_table_orig = None

        if mode == "rebuild":
            # The pose buffers (set_vertices, _rebuild): the Renderer's
            # own, at fixed addresses for its life.
            dm = mesh.on(self.device)
            self.mesh = dataclasses.replace(dm, vertices=dm.vertices.clone(),
                                            normals=dm.normals.clone())
        if mode == "rebuild" and not self._binary:
            self._setup_rebuild()
        else:
            t0 = time.perf_counter()
            if self._use_sah:
                self.bvh = build_sah_lbvh(mesh, self.device, config.leaf_size)
            else:
                dm = mesh.on(self.device)
                self.bvh = build_lbvh(dm.vertices, dm.indices,
                                      leaf_size=config.leaf_size,
                                      top_sah=self._top_sah)
            _sync(self.device)
            t1 = time.perf_counter()
            self.accel = self._make_accel()
            _sync(self.device)
            t2 = time.perf_counter()
            self.stats.update({
                "sah_build_ms" if self._use_sah else "lbvh_build_ms":
                    (t1 - t0) * 1e3,
                "pack_ms" if self._binary else "collapse_ms":
                    (t2 - t1) * 1e3})
            if (self._raster or mesh.textured) and mode != "rebuild":
                # The rasterizer bins the mesh on the device every frame,
                # and the texture pass samples its atlas.
                self.mesh = mesh.on(self.device)
            if self._tables:
                self._make_tables(mesh, t2)
        if self._binary:
            self.depth = tree_depth(self.bvh.nodes_child)
            check_binary_stack_bound(self.depth)
        else:
            self.depth = wide_depth(self.accel)
            check_stack_bound(self.depth)

    def _make_tables(self, mesh: Mesh, t0: float) -> None:
        """The static tree's shading table, timed from ``t0``: the leaf
        attribute rows, the shade table or the original-order one."""
        if self._tables == "attr":
            self.attr_tables = make_leaf_attr_rows(self.bvh, mesh)
        elif self._tables == "st":
            self.shade_table = make_shade_table(self.bvh, mesh)
        else:
            self.shade_table_orig = make_shade_table_orig(
                mesh.on(self.device))
        _sync(self.device)
        key = {"attr": "attr_rows_ms", "st": "shade_table_ms",
               "sto": "shade_table_orig_ms"}[self._tables]
        self.stats[key] = (time.perf_counter() - t0) * 1e3

    def _make_accel(self):
        """8-wide area collapse of a static tree (the leaf slots take the
        builder's stored, on SBVH clipped, boxes), or with
        ``bvh_width=2`` the binary kernels' rows."""
        if self._binary:
            return pack_bvh(self.bvh)
        nw_pad = round_up_bucket(max(count_wide(self.bvh), 1))
        plan = make_wide_plan(self.bvh, nw_pad)
        return widen_from_plan(plan, self.bvh, leaf_boxes_from_nodes(self.bvh))

    def _count_pad(self) -> int:
        """A full-box build of the current geometry and the padded count of
        its collapse in ``rebuild_collapse``'s mode (host sync): the
        rebuild's ``nw_pad``."""
        self.bvh = build_lbvh(self.mesh.vertices, self.mesh.indices,
                              leaf_size=self.config.leaf_size,
                              split_blocks=self._rebuild_splits,
                              top_sah=self._top_sah)
        return round_up_bucket(max(count_wide(
            self.bvh, mode=self.config.rebuild_collapse), 1))

    def _check_count(self, count: torch.Tensor) -> None:
        """Raise if a collapse outgrew the pad just counted (host sync)."""
        n = int(host_read(count))
        if n > self._nw_pad:
            raise RuntimeError(f"the collapse made {n} wide nodes in a pad "
                               f"of {self._nw_pad}")

    def _setup_rebuild(self) -> None:
        """Rebuild mode's set-up: the pad from a full-box build of the pose
        buffers, and the set-up accel from that tree through the
        per-frame collapse's mode (the area kernel, or the fixed cut), so
        its wide depth is checked against the stack once (area frames rely
        on the walk counters, unsteered fixed ones on
        ``FIXED_CUT_DEPTH_BOUND``)."""
        t0 = time.perf_counter()
        self._nw_pad = self._count_pad()
        t1 = time.perf_counter()
        if self.config.rebuild_collapse == "fixed":
            self.accel = widen_lbvh(self.bvh, self._nw_pad, mode="fixed")
            count = wide_count_device(self.bvh, mode="fixed")
        else:
            self.accel, count = widen_area_kernel(self.bvh, self._nw_pad)
        self._check_count(count)
        t2 = time.perf_counter()
        self.stats.update(build_and_count_ms=(t1 - t0) * 1e3,
                          collapse_ms=(t2 - t1) * 1e3,
                          overflow_recoveries=0)
        if self._tables:
            self._make_tables(self.mesh, t2)

    def _rebuild(self):
        """The frame's rebuild from the pose buffers: once the Renderer
        has been posed, the pose's normals into their buffer
        (``smooth_normals_device``), then the route's rebuild."""
        m = self.mesh
        if self._posed:
            m.normals.copy_(smooth_normals_device(m.vertices, m.indices))
        if self._binary:
            return _rebuild_binary(m.vertices, m.indices, m,
                                   self.config.leaf_size,
                                   tables=self._tables, top_sah=self._top_sah)
        return _rebuild_fused(m.vertices, m.indices, m, self.config.leaf_size,
                              self._nw_pad,
                              split_blocks=self._rebuild_splits,
                              tables=self._tables,
                              collapse=self.config.rebuild_collapse,
                              top_sah=self._top_sah)

    def _rebuild_step(self):
        """``_rebuild``, replayed as one CUDA graph where
        ``graphs.rebuild_takes_graph`` says so: the first rebuild of a
        capture key runs eagerly, the second is captured, and it and every
        later one replay it, writing the same outputs in place. A new key
        (the pad, the route, the mesh and its pose buffers, the device)
        drops the graph of the last."""
        if not rebuild_takes_graph(self.mode, self.device):
            return self._rebuild()
        m = self.mesh
        objects = (m, m.vertices, m.normals)
        route = (self._binary, self.config.rebuild_collapse, self._tables,
                 self._top_sah, self._rebuild_splits, self.config.leaf_size,
                 self._posed)
        key = rebuild_key(self._nw_pad, route, self.device, *objects)
        g = self._rebuild_graph
        if g is None or g.key != key:
            g = self._rebuild_graph = RebuildGraph(key, objects)
        if not g.warm:
            g.warm = True
            return self._rebuild()
        if not g.captured:
            g.capture(self._rebuild)
        rebuild_graph_frame()
        return g.replay()

    def _update_bvh(self) -> None:
        """Rebuild the accel for this frame. The wide-node count is read
        back only after ``set_vertices``; if it outgrew the pad, the pad is
        recounted on a full-box build and the frame rebuilt with it,
        eagerly: the new pad is a new capture key, whose graph the next
        frame captures.
        ``tpurt`` instead renders that full-box build's XLA area collapse:
        the same tree with its wide ids in binary-node order, where the
        rerun keeps the breadth-first ids every other frame has. A binary
        rebuild has no pad to outgrow."""
        if self._binary:
            self._geom_dirty = False
            self.bvh, self.accel, table = self._rebuild_step()
            self._set_table(table)
            return
        bvh, accel, table, count = self._rebuild_step()
        if self._geom_dirty:
            self._geom_dirty = False
            with span("tpurt.rebuild.count_read"):
                grew = int(host_read(count)) > self._nw_pad
            if grew:
                self._nw_pad = self._count_pad()
                self.stats["overflow_recoveries"] += 1
                bvh, accel, table, count = self._rebuild_step()
                self._check_count(count)
        self.bvh, self.accel = bvh, accel
        self._set_table(table)

    def _set_table(self, table) -> None:
        """Keep a rebuild's table as the one its frames read."""
        if self._tables == "attr":
            self.attr_tables = table
        elif self._tables == "st":
            self.shade_table = table
        elif self._tables == "sto":
            self.shade_table_orig = table

    def set_vertices(self, vertices) -> None:
        """Animate (rebuild mode): new vertex positions f32[V, 3], same
        triangles, copied into the Renderer's vertex buffer with one copy,
        so a later change to the caller's array or tensor leaves the
        frames as they are. The vertex normals follow at the next frame's
        rebuild, which computes them on the device into the normals buffer
        and checks the pad against the new geometry."""
        if self.mode != "rebuild":
            raise NotImplementedError("set_vertices outside mode='rebuild' "
                                      "(the refit path) is not ported")
        buf = self.mesh.vertices
        v = torch.as_tensor(vertices, dtype=torch.float32)
        if v.shape != buf.shape:
            raise ValueError(f"vertices of shape {tuple(v.shape)}, expected "
                             f"{tuple(buf.shape)}")
        buf.copy_(v)
        self._posed = True
        self._geom_dirty = True

    def _frame_fn(self, consts) -> Dict[str, torch.Tensor]:
        """The frame's stages, eagerly, on the block's views."""
        return render_frame_fn(self.accel, self.mesh, self.camera,
                               self.lights, self.config, self.attr_tables,
                               shade_table=self.shade_table,
                               shade_table_orig=self.shade_table_orig,
                               consts=consts)

    def _graph_frame(self, consts) -> Dict[str, torch.Tensor]:
        """A frame that takes the CUDA graphs (``graphs.py``): the first of
        a capture key runs eagerly, the second captures its stages, and
        it and every later one replays them. A new key (route, config,
        lights' count and kinds, accel, tables, mesh, block, device) drops
        the graphs of the last."""
        objects = (self.accel, self.attr_tables, self.shade_table,
                   self.shade_table_orig, self.mesh, self._block)
        key = capture_key(self.route, self.config, self.lights, self.device,
                          *objects)
        g = self._graphs
        if g is None or g.key != key:
            g = self._graphs = FrameGraphs(key, objects)
        if not g.warm:
            g.warm = True
            return self._frame_fn(consts)
        if not g.captured:
            g.capture(lambda: self._frame_fn(consts))
            self.stats["graph_captures"] += 1
        self.stats["graph_replays"] += 1
        graph_frame()
        return g.replay()

    def render_frame(self) -> Dict[str, torch.Tensor]:
        """Render one frame; returns the output dict (tensors on the
        Renderer's device). Rebuild mode first rebuilds the accel. The soft
        kernels draw this frame's samples from ``frame_seed(config.seed,
        frame_index)``. Raises if a walk overflowed its stack or hit the
        iteration cap. A raster frame whose binning overflowed the pair
        capacity is rendered again with the capacity doubled, and at least
        ``default_cap_rows`` (``tpurt/app.py:1055-1072``), so a frame with
        dropped coverage is never returned; the flag is read in the frame's
        one host read, with the walk counters. Under a recording torch
        profiler the frame is traced into ``spans``."""
        with self.spans.frame(self.frame_index):
            return self._render_frame()

    def _render_frame(self) -> Dict[str, torch.Tensor]:
        cfg = self.config
        if self.mode == "rebuild":
            with span("tpurt.rebuild", self.device) as timer:
                self._update_bvh()
        if self._block.n_lights != len(self.lights):
            self._block = FrameBlock(len(self.lights), self.device)
        consts = self._block.write(self.camera, self.lights, cfg,
                                   frame_seed(cfg.seed, self.frame_index))
        if takes_graph(self.mode, self.device):
            out = self._graph_frame(consts)
        else:
            out = self._frame_fn(consts)
        with span("tpurt.read"):
            flags = out["walk_counts"]
            if self._raster:
                flags = torch.cat([flags, out["raster_overflow"].reshape(1)
                                   .to(flags.dtype)])
            flags = host_read(flags)
            grow = self._raster and bool(flags[2])
            if not grow:
                check_walk_counts(flags[:2])
        if grow:
            ntris = self.mesh.num_triangles
            cap = cfg.raster_cap_pairs or default_cap_rows(ntris)
            self.config = dataclasses.replace(
                cfg, raster_cap_pairs=max(2 * cap, default_cap_rows(ntris)))
            self.stats["raster_cap_growths"] += 1
            drop_counts()
            return self._render_frame()
        if self.mode == "rebuild":
            self.stats["build_ms"] = timer.ms()
        if cfg.accumulate:
            with span("tpurt.composite"):
                if self.accum is None:
                    self.accum = out["image"]
                else:
                    self.accum = accumulate(self.accum, self.frame_index,
                                            out["image"])
            out["image"] = self.accum
        self.frame_index += 1
        return out
