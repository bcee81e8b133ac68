"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py               # all phases (one card)
    python3 chip_smoke.py frame_graph   # phases 1, 2 and 20 alone
    python3 chip_smoke.py resolve       # phases 1, 2 and 21 alone

Phases, in order; any failure raises and the exit code is not 0:

1. Device check: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. There is no CPU path.
2. Build the CUDA kernel library (csrc/fused_shadows.cu,
   csrc/shadow_rays.cu, csrc/binary.cu and csrc/transposed.cu, templates
   with a mode per walk kernel, csrc/variants.cu, the stats walk,
   csrc/build.cu, the rebuild's kernels, the node boxes and the sweep,
   csrc/raster.cu, the rasterizer in its 32- and 16-float
   instantiations and the v1 kernel, csrc/resolve.cu, the frame
   resolve, and csrc/unfused_origins.cu, the unfused frame's shadow
   origins; one nvcc per source, in parallel), and print ptxas's
   register and spill report, then the penumbra kernels'
   (psoft_kernel<0, 1, 2>, any_psoft_kernel) on one line and the two
   resolve kernels' on another.
3. Every kernel against its plain PyTorch version on the card: teapot
   scene, 10k triangles, 512x512, leaf 14. closest_shadow with a
   directional and a point light; multi with directional + point +
   directional; soft with a 4 deg sun at spp 8; point-soft with radius 0.4
   at spp 8; soft-multi with a cone + two directional lights and with a
   disk + one directional light. The sampling kernels run once with the
   real generator and once with the zero stream; with the zero stream
   their counts must be spp x closest_shadow's hard occlusion along the
   axis or toward the centre. Then the unfused frame's kernels on the same
   rays: closest_attrs (its channels must equal closest_shadow's bit for
   bit), any with directional and point rays from the G-buffer, and
   any_soft and any_point_soft from its biased origins with the real and
   the zero stream; zero-stream counts must be spp x any's occlusion.
   Then the point-light penumbra kernels, one thread per (ray, sample):
   PSOFT attrs 0, 1, 2 and ANY_PSOFT on the teapot at 128x128 (128 blocks
   of 128 rays) at spp 3, 8, 33 and 130 with the real and the zero
   stream, and at spp 8 with stack_size 4 and an iteration cap of 2
   (dropped pushes and capped walks both non-zero), each equal to its
   plain version in every output: counts, walk counters and phase-1
   channels.
4. Config 1's path at the bench headline's size (Sponza-class hall, 260k
   triangles, 1920x1080, leaf 14, one directional light) through
   Renderer(device="cuda"): one warm-up frame and five timed frames,
   checked for finite values, coverage, shadow share and bit-identical
   repeats; then the kernel against its plain version on every 8th row
   and on the whole frame; where the frame's time goes, from the
   program's spans over three frames under torch.profiler
   (``Renderer.spans``: device-timeline, self and host ms a frame per
   span); one frame under CUDA's sync debug mode, whose syncs must equal
   the frame's own count of host syncs and 1, the frame's one host read
   (2 in phase 9, with the rebuild's count read). Phases 5, 6 and 9 do
   the same.
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
8. The unfused frame at 1920x1080 in the same hall, through the Renderer:
   config 1 and config 3 with fused_shadow=False, the lamp with
   fused_shadow=False, and the mixed set 2 deg sun + lamp (spp 8), which
   takes the fused cone kernel for the sun and the unfused disk sampler
   for the lamp. One warm-up and five timed frames each, with the launches
   of every kernel counted (the sun and the lamp alone resolve from their
   walks' packets: one launch each of closest_attrs, the origins kernel,
   the sampler and the frame resolve a frame); config 1's unfused image against phase 4's
   fused one; the spans of three frames; every kernel of the case against its plain version on
   every 8th row and on the whole frame (the samplers also with the zero
   stream on every 8th row); each fused_shadow=False case timed in turns
   with its fused twin (fused, unfused, unfused, fused).
9. Config 2, the per-frame rebuild (tpurt/cli.py:28): the same hall and
   camera at 1920x1080, leaf 14, Renderer(mode="rebuild"). Each build
   kernel of csrc/build.cu against its plain version on the card, equal
   bit for bit: the Morton codes of the hall's centroids; the topology of
   the hall's clustered leaf codes and of a synthetic 30k-leaf code array
   drawn from 64 values; the area collapse with the Renderer's pad and
   with a forced pad smaller than the count. Then the whole rebuilt accel
   (nodes, leaf rows, tri_id, attribute rows, count) built once with the
   kernels and once with the plain versions on the card, equal. One
   warm-up and five timed frames, one launch of each build kernel and of
   closest_shadow per frame; frames bit-identical; the image against
   config 1's static frame (another tree of the same geometry: at most
   1e-3 of valid pixels may differ by more than 1e-3); the spans of three
   posed frames (set_vertices, then the frame), the rebuild's parts
   among them, and a posed frame's host syncs; the wide depth and
   nw_pad. Then five animated frames
   (set_vertices(deform(mesh, t))), finite, with the count of overflow
   recoveries, and one more after a pad forced below the count, which
   must recover.
10. The raster G-buffer (tpurt's primary visibility wherever the accel is
    neither an SBVH nor a clustered rebuild): the same hall, camera and
    light at 1920x1080, Renderer(gbuffer="raster"). One warm-up and five
    timed frames, one rasterizer and one any-hit launch each, frames
    bit-identical, coverage and image against phase 4's ray-cast frame
    (tests/test_raster.py's bounds: coverage differs on < 0.2% of pixels,
    the image by more than 2e-2 on < 1%); the rasterizer against its plain
    version on the whole frame's bins (ids, u, v and 1/w equal, every
    other channel within 1e-6); the binning's host syncs (must be 0) and
    its pair, big-row and per-tile statistics; the binning and the kernel
    timed alone, beside the frame's spans; the raster and ray frames in
    turns; one binning call and one raster frame under torch.profiler
    (kernel time, launches, the card's idle share, the costliest
    kernels). Then the two "auto" paths that resolve to raster on the card:
    sah=False (three frames) and mode="rebuild" with rebuild_splits=0
    (one warm-up and five timed frames, each with one launch of every
    build kernel), each image against the raster frame's; and a pair
    capacity forced to 4096, which must be grown and the frame rendered
    again, equal to the first.
11. The shade-table G-buffer (inkernel_attrs=False): the attrs=0 variants
    of the five fused kernels and the plain closest hit (tpurt's
    _closest_hit_kernel_w8_b). At 512^2 (phase 3's scene and rays, run
    right after phase 3) each against its plain version, the samplers with the real generator and
    the zero stream, the closest hit also with a per-ray t_max, and each
    against its attrs=1 twin on the same rays (t and the sorted index are
    the attribute block's channels 0-1, the shadow outputs equal). Then at
    1920x1080 in the hall, through Renderer(inkernel_attrs=False): config
    1 fused (HARD attrs=0) and unfused (the plain closest hit + any hit),
    each in turns with phase 4's attribute frame and its image against
    phase 4's (the share of pixels off by more than 2e-2); config 3's sun,
    config 5's three lights, the lamp and the sun with two fills (SOFT,
    MULTI, PSOFT, SOFT_MULTI attrs=0); one warm-up and five timed frames
    each with the launches counted; each kernel against its plain version
    on every 8th row and on the whole frame; the spans of config 1's
    frames, fused and unfused. Last config 2 with the
    flag: the rebuild's host syncs (must be 0), one warm-up and five
    rebuilt frames with the shade table of the rebuilt tree, the image
    against the static one, their spans, HARD attrs=0 on the rebuilt tree
    against its plain version.
12. The binary tree (bvh_width=2; csrc/binary.cu's BIN_CLOSEST and
    BIN_ANY, tpurt's _closest_hit_kernel and _any_hit_kernel over the
    packed LBVH) and the 60-bit Morton codes. (a) Right after phase 11's
    512^2 checks, on phase 3's scene and rays packed at leaf 14 and leaf
    8: both kernels against their plain versions on camera rays, a
    per-ray t_max with inactive rays, directional and point shadow rays
    from the binary G-buffer and flat (N, 3) rays with a t_min. (b) The
    hall at 1920x1080 through Renderer(bvh_width=2, leaf_size=14,
    gbuffer="ray"): the tree's depth and stack bound, one warm-up and
    five timed frames with one launch of each kernel, bit-identical
    repeats, the image against phase 4's (coverage off on < 0.2% of
    pixels, the image off by more than 2e-2 on < 1%), both kernels
    against their plain versions on every 8th row and on the whole frame,
    the spans, and the frame in turns with phase 4's. (c) "auto"
    (the rasterizer and BIN_ANY): three frames, each against (b)'s. (d)
    Config 3's 2 deg sun at spp 8: 8 BIN_ANY launches a frame, a
    penumbra, a second Renderer with the same seed giving bit-identical
    frames. (e) mode="rebuild" with rebuild_splits=0: no host sync in the
    rebuild, five timed frames, the image against (c)'s. (f)
    morton_codes60 against its plain version on the hall's centroids (bit
    for bit), build_lbvh(morton_bits=60) with the kernels against the
    plain versions (equal), and tpurt's compile-check route (teapot 2000,
    256x256, leaf 8, a plain LBVH and no tables) on a 30-bit and a 60-bit
    tree.
13. Textured scenes (attrs=2): the hall written as an OBJ (v, vt per
    corner from a box projection of world position, vn), an MTL of 25
    materials, 20 of them with a 1024^2 procedural diffuse map (PNG) and
    5 flat, loaded through tpurt_torch.io.obj.load_obj with the native
    parser (timed). Through Renderer(device="cuda") at 1920x1080: the
    fused frame (HARD attrs=2, six frames, bit-identical, coverage against
    phase 4's untextured twin, the two in turns, the spans, the texture
    pass inside tpurt.gbuffer), the unfused frame (CLOSEST attrs=2 + any),
    config 5's three lights (MULTI), the 2 deg sun (SOFT), the lamp
    (PSOFT) and the sun with two fills (SOFT_MULTI), two frames each, with
    every launch counted and each attrs=2 kernel against its plain
    version on every 8th row and on the whole frame (t, attributes, uv
    within 1e-6, layer equal); the shade-table and binary frames of the
    textured hall against the fused one (the raster bounds), and the
    raster frame too, there on the pixels where both look up the same
    texels (the raster G-buffer's positions from 1/w are off the ray's
    hits, which a texture shows; the rest is reported); and
    config 2 on it: no host sync in a rebuild, the rebuilt accel and
    textured attribute rows equal to the plain versions', six frames
    against the static textured one (at most 1e-3 of valid pixels off by
    more than 1e-3).
14. Config 2 with rebuild_collapse="fixed": the topology's depth output
    (topology_depth_cuda) against its plain version on config 2's
    clustered deltas and on 30k leaves of 64 codes (equal), timed with
    the topology alone beside it; no host sync in a rebuild; the rebuilt
    accel equal to the plain versions'; six frames, bit-identical, one
    launch of each kernel, the image against phase 9's area rebuild (at
    most 1e-3 of valid pixels off by more than 1e-3), the wide depth
    against the fixed cut's bound (32), closest_shadow on the fixed cut's
    tree against its plain version.
15. The seeded G-buffer (seeded_gbuffer=True, tpurt's
    _first_hit_kernel_w8_b as mode FIRST_HIT): Renderer(seeded_gbuffer=
    True, fused_shadow=False) at 1920x1080, six frames with one launch of
    FIRST_HIT, NEAREST and any each, bit-identical, the frame against its
    unseeded shade-table twin (equal wherever both name the same
    triangle) and in turns with it; FIRST_HIT against its plain version
    on every 8th row and on the whole frame (t1 and s1 equal); the seeded
    closest hit against NEAREST on every ray (t equal, tri_id on >= 99.9%
    of hits, the sorted index may name another SBVH reference of the same
    triangle); every seed an upper bound (t1 >= t, s1 >= 0 exactly where
    a hit exists); NEAREST timed with and without the seed's caps.
16. top_sah (the sweep-SAH priorities kernel, tpurt's _sweep_sah_kernel)
    on mode="rebuild", rebuild_splits=0, gbuffer="ray": the sweep against
    its plain version on the plain rebuild's leaves (gaps, ranks and D'
    equal), the topology on D' (d_max = 96 + 21) equal to its plain
    version; for the area collapse and the fixed cut: no host sync in a
    rebuild, the rebuilt accel equal to the plain versions', six frames
    with one launch of the sweep each, bit-identical, the image against
    the unsteered plain rebuild's (another tree: at most 1e-3 of valid
    pixels off by more than 1e-3), closest_shadow on the steered tree
    against its plain version beside the unsteered tree's.
17. The deferred raster G-buffer (raster_deferred=True, tpurt's
    _raster_kernel16 as the 16-float instantiation of csrc/raster.cu):
    six static frames with one launch of rasterize_rows16 and any each,
    bit-identical, the image against phase 4's ray frame within the
    raster bounds, in turns with phase 10's 32-float raster frame;
    bin_rows(fmt="z16") with no host sync; the z16 rasterizer against its
    plain version (ids, u, v and 1/w equal), the binning and the kernel
    timed alone, beside the frame's spans; the plain rebuild's deferred frames
    (the original-order table per frame, no host sync in a rebuild); the
    textured hall's deferred frame against phase 13's textured ray frame
    (the share of pixels that look up other texels, beside phase 13's).
18. The w8t accel (WideBVHT: the 8-wide nodes with transposed leaf
    triangles; tpurt's _any_hit_kernel_w8t, _closest_hit_kernel_w8t and
    _closest_attr_kernel_w8t_b as csrc/transposed.cu): the hall's Morton
    tree built on the card at leaf 16 and leaf 8 (build_lbvh, build_wide,
    build_wide_t, the transposed attribute rows, the shade table, the
    stack check), and the textured hall's at leaf 8. render_frame_fn with
    the shade table and the sun on the WideBVHT at each leaf size: six
    frames with one launch of the w8t closest and any hit each,
    bit-identical, walk counters zero, coverage and image against phase
    4's frame within the shade-table and binary frames' bounds; the
    leaf-8 frame in turns with its row-layout twin (the same tree's
    WideBVH, fused_shadow=False, order_children=False), which it equals
    bit for bit. gbuffer_attr_pass at each leaf size and on the textured
    hall (one launch of the attribute walk each; its hits those of the
    shade-table frame). Each of the four entry points against its plain
    version on every 8th row and on the whole frame, at leaf 8 and (all
    but the textured one) leaf 16; at leaf 8 each against its row-layout
    twin on every ray (the closest hit against NEAREST: t and the sorted
    index equal; the attribute walk against CLOSEST: every channel equal
    but the layer, -1 against 0; the any hit against ANY: equal), both
    timed.
19. The last six TPU kernels, each through its own entry point, in one
    driven run on the hall at 1920x1080 (phase 4's Renderer, phase 12's
    binary tree rebuilt, config 2's clustered gaps): trace_any_stats on
    the sun's shadow rays (tpurt's _any_hit_kernel_w8_stats as
    csrc/variants.cu, one launch), trace_any(variant="x2") on the SBVH
    accel (one ANY launch), trace_any and trace_closest with
    variant="frustum" on the binary tree (one BIN_ANY, one BIN_CLOSEST),
    topology_and_boxes (csrc/build.cu's topology and bottom-up box
    kernel) and bin_triangles + rasterize_tiles (csrc/raster.cu's v1
    kernel). The stats kernel against its plain version (occlusion and
    iterations equal on every packet) and its occlusion against ANY's;
    the three routed variants equal to their modes' default calls and
    those kernels against their plain versions; topology_and_boxes
    against its plain version (exact) and timed beside topology_cuda +
    the range-table node boxes; the binning's host syncs (none) and
    overflow (false), the v1 rasterizer against its plain version (ids,
    u, v, 1/w equal) and against phase 10's rasterize_rows G-buffer (ids
    on >= 99.4% of covered pixels, coverage off on < 0.2%: the v1 records'
    pixel-scale cross products lose the depth order on some pixels, as
    tpurt's own v1 does).
20. The static frame's CUDA graphs (tpurt_torch/graphs.py) against its
    eager frames at 1920x1080 in the hall: per route (hard fused0, the
    seeded SOFT at spp 8 with accumulation, fusedN with config 5's three
    suns, fusedSM with the 2 deg sun and two fills, the unfused hard
    frame, the unfused 2 deg sun at spp 8 with accumulation (resolved
    from its walks' packets), the shade table, the textured hall, the raster G-buffer with
    the sun, the deferred raster G-buffer with the three suns) six frames
    of one Renderer that takes the graphs and six of one that runs
    eagerly: every output of every frame equal bit for bit, the same
    launches of every kernel, one capture and five replays; every frame's
    frame-2 output unchanged after frame 6; on hard fused0 and the raster
    frame the camera moved between frames 3 and 4 (equal outputs, no
    second capture). Then one graph frame per route under CUDA's sync
    debug mode: 1 host sync, the frame's own count. The frame ms of both
    (CUDA events and the host clock, frames 3-6) per route, and the spans
    of both on hard fused0, three suns and the raster frame.
21. The frame resolve (tpurt_torch/kernels/resolve.py, csrc/resolve.cu)
    in the hall, as the benchmark's static cells render it: 1920x1080
    with the sun (HARD), 1920x1080 with the 2 deg sun at spp 8 and
    accumulation (SOFT) and 3840x2160 with config 5's three suns
    (MULTI). Per case the kernel against its plain version on one
    frame's fused launch, every output equal bit for bit; the kernel's
    ms (CUDA events, 20 launches) beside its byte bound (what the
    function reads and writes once: per pixel the sorted index, the ray
    and the shadow words, per valid pixel 11 more attribute channels;
    out the G-buffer, the shadows and the image) and the plain version's
    ms; then five graph frames under torch.profiler: the launches a
    frame, the resolve launches a frame (1) and the resolve kernel's
    device ms a frame in the trace. Then the unfused frame of the 2 deg
    sun at spp 8 with accumulation (fused_shadow=False, 1920x1080): on
    one frame's closest attribute walk the origins kernel
    (csrc/unfused_origins.cu) against its plain version, bit for bit, and
    its ms beside its byte bound (t, the sorted index and the geometric
    normal, the ray, the 4-channel block out: 60 B a pixel); the cone
    sampler on its block; the frame resolve (kind COUNTS) on the walk's
    channels and the sampler's counts against its plain version and its
    ms beside its byte bound; five graph frames: one launch of each a
    frame. Phase 2 also prints the two kernels' ptxas line (registers,
    spills).
22. Timings on one JSON line, then the kernel table on one JSON line, the
    card's nvidia-smi line, and last {"ok": true, "device": {...}}.

Tolerances of the walk kernels' checks against their plain versions:
valid masks equal; t to rtol
1e-6 / atol 1e-6; tri_id (for the attrs=0 kernels and the plain closest
hit, the accel's id at the sorted index) equal on >= 99.9% of valid
pixels and every other attribute channel within 1e-6 where it is;
occlusion, each bit of a
mask and counts differ on at most 1e-3 of valid (for the shadow-ray
kernels: active) pixels, and nothing is set off them. Both are built
without fused multiply-adds and draw the same random bits, so they agree
bit for bit except where float rounding of division or sqrt could differ.

The kernel table's bound_ms is the larger of two floors computed from this
run's inputs: bytes (every input and output tensor once) over 3.35 TB/s,
and float32 operations over 67 TFLOP/s. The operations are those the
kernel performs, counted by the plain version's walks on the same inputs:
per node pop 8 empty-slot compares, 25 per slab test of a non-empty child
box, and 56 per triangle test, where the closest walk tests every
triangle of a leaf it visits and an any-hit walk stops at the first
occluder; a binary walk's pop is its two slab tests, with no empty-slot
compares. Ray set-up, sampling and integer work are not counted. The
build kernels' operations (integer ones counted at the float32 rate): 52
per Morton code, 104 per 60-bit key; per topology node one sparse-table
min per level, two compares per level of the two searches and 10 to
place it, and for the depth output 2 per step up the parent pointers
(the sum of the depths); per expanded wide node 190 for the six greedy
steps and the emission. The rasterizer: bytes of the pair rows its tiles
read, the big rows every tile reads, the run offsets and the 13 output planes;
operations counted by the plain version on the same bins, 30 per
(record, pixel) test and 29 more where the record takes the pixel (the
z16 rasterizer: 4 output planes, 5 per take). The sweep: the block
boxes and its two outputs; 18 operations per block of a split range and
pass.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import warnings

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
# The TPU kernel each walk kernel replaces, by the line that defines it;
# the kernel's source is its row's (traverse.WALK_KERNELS).
KERNELS = {
    "closest_shadow": 1450,
    "closest_multi_shadow": 1538,
    "closest_soft_shadow": 1032,
    "closest_point_soft_shadow": 1117,
    "closest_soft_multi_shadow": 1622,
    "closest_attrs": 1429,
    "any": 874,
    "any_soft": 890,
    "any_point_soft": 963,
    "closest": 1286,
    "closest_shadow_st": 1450,
    "closest_multi_shadow_st": 1538,
    "closest_soft_shadow_st": 1032,
    "closest_point_soft_shadow_st": 1117,
    "closest_soft_multi_shadow_st": 1622,
    "binary_closest": 287,
    "binary_any": 222,
    "closest_shadow_tex": 1450,
    "closest_multi_shadow_tex": 1538,
    "closest_soft_shadow_tex": 1032,
    "closest_point_soft_shadow_tex": 1117,
    "closest_soft_multi_shadow_tex": 1622,
    "closest_attrs_tex": 1429,
    "first_hit": 1290,
    "w8t_any": 1910,
    "w8t_closest": 1973,
    "w8t_closest_attrs": 2238,
    "w8t_closest_attrs_tex": 2238,
}
# The attrs=0 variants of the fused modes (no attribute rows; t and the
# sorted index out) and the plain closest hit: the shade-table G-buffer's.
SHADE_TABLE_KERNELS = ("closest", "closest_shadow_st",
                       "closest_multi_shadow_st", "closest_soft_shadow_st",
                       "closest_point_soft_shadow_st",
                       "closest_soft_multi_shadow_st")
# The attrs=2 variants (textured meshes): the attribute kernels' walk with
# the winner's interpolated uv (channels 4-5) and layer (channel 7).
TEXTURED_KERNELS = ("closest_shadow_tex", "closest_multi_shadow_tex",
                    "closest_soft_shadow_tex",
                    "closest_point_soft_shadow_tex",
                    "closest_soft_multi_shadow_tex", "closest_attrs_tex")
# The kernels that take given shadow rays or origins, no camera rays.
SHADOW_RAYS = ("any", "any_soft", "any_point_soft")

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


def all_kernels():
    from tpurt_torch.kernels._variants import VARIANT_KERNELS
    from tpurt_torch.kernels.build import BUILD_KERNELS
    from tpurt_torch.kernels.raster import RASTER_KERNELS
    from tpurt_torch.kernels.resolve import (frame_resolve_cuda,
                                             unfused_origins_cuda)
    from tpurt_torch.kernels.traverse import CUDA_KERNELS
    return (*CUDA_KERNELS, *BUILD_KERNELS, *RASTER_KERNELS, *VARIANT_KERNELS,
            frame_resolve_cuda, unfused_origins_cuda)


def reset_launches():
    for fn in all_kernels():
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__[:-len("_cuda")]: fn.launches for fn in all_kernels()}


def resolve_launches(r, n: int) -> dict:
    """The resolve kernels' launches in ``n`` frames of Renderer ``r``, as
    ``render_frame_fn`` picks them from the frame's input: the frame
    resolve on a frame that ``app.resolves``, the origins kernel and the
    frame resolve on one that ``app.resolves_unfused``, none on the
    others."""
    from tpurt_torch import app
    tabs = r.attr_tables is not None or r.shade_table is not None
    route = app.frame_route(r.config, r.lights, r.accel) if tabs \
        else "unfused"
    if app.resolves(route, r.attr_tables, r.mesh, len(r.lights)):
        return {"frame_resolve": n}
    if app.resolves_unfused(route, r.config, r.accel, r.attr_tables, r.mesh,
                            r.lights):
        return {"unfused_origins": n, "frame_resolve": n}
    return {}


def drive(expect: dict, fn):
    """Run one main path with every launch counter at 0 just before it;
    fail unless each kernel named in ``expect`` launched that many times
    and no other kernel launched. Returns (fn's result, the counts of the
    kernels in ``expect``)."""
    reset_launches()
    res = fn()
    torch.cuda.synchronize()
    got = launches()
    want = {k: expect.get(k, 0) for k in got}
    if got != want:
        raise RuntimeError(f"main path launches {got}, want {want}")
    return res, {k: got[k] for k in expect}


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
    if not torch.equal(ko[:, 7][same], po[:, 7][same]):
        raise RuntimeError(f"{what}: texture layers differ")
    shares, mism = output_shares(outputs, kres[1:-1], pres[1:-1], valid,
                                 what)
    max_abs = max(float((kt - pt).abs().max()), attr_err)
    return dict(valid=nvalid, tri_id_equal=tri_frac, mismatch_share=mism,
                mismatch_shares=shares, max_abs_err=max_abs)


def output_shares(outputs, kouts, pouts, valid, what) -> tuple:
    """The shares of valid rays on which each count or mask bit of the
    kernel's i32 outputs differs from the plain version's -> (shares, the
    largest); raises above 1e-3, or where an output is set off the hit
    set."""
    nvalid = int(valid.sum())
    shares = []
    for (kind, n), ki, pi in zip(outputs, kouts, pouts):
        if bool((ki[~valid] != 0).any()):
            raise RuntimeError(f"{what}: shadow output set off the hit set")
        planes = [(ki, pi)] if kind == "count" else \
            [((ki >> b) & 1, (pi >> b) & 1) for b in range(n)]
        for a, b in planes:
            shares.append(int(((a != b) & valid).sum()) / nvalid)
    mism = max(shares, default=0.0)
    if mism > 1e-3:
        raise RuntimeError(f"{what}: shadow outputs differ on {mism:.2e} "
                           f"of valid rays ({shares})")
    return shares, mism


def compare_st(kres, pres, what: str, outputs, tri_id) -> dict:
    """Hold an attrs=0 kernel's or the plain closest hit's (t, sidx, *i32
    outputs, counts) against the plain version's: valid masks equal, t
    within 1e-6, tri_id (``tri_id`` of the accel at sidx) equal on >=
    99.9% of valid rays, the i32 outputs as ``compare`` holds them."""
    kc, pc = kres[-1].tolist(), pres[-1].tolist()
    if kc != [0, 0] or pc != [0, 0]:
        raise RuntimeError(f"{what}: walk counters kernel {kc} plain {pc}")
    ks, ps = kres[1], pres[1]
    kvalid, valid = ks >= 0, ps >= 0
    if not torch.equal(kvalid, valid):
        raise RuntimeError(f"{what}: valid masks differ on "
                           f"{int((kvalid != valid).sum())} rays")
    nvalid = int(valid.sum())
    if nvalid == 0:
        raise RuntimeError(f"{what}: no ray hit the scene")
    kt, pt = kres[0].double()[valid], pres[0].double()[valid]
    if not torch.all((kt - pt).abs() <= 1e-6 + 1e-6 * pt.abs()):
        raise RuntimeError(f"{what}: t differs by up to "
                           f"{float((kt - pt).abs().max())}")
    if not (torch.all(kres[0][~valid] == pres[0][~valid])
            and torch.all(ks[~valid] == -1)):
        raise RuntimeError(f"{what}: misses are not (BIG, -1)")
    n = tri_id.shape[0]
    ktid = tri_id[ks.clamp(0, n - 1).long()]
    ptid = tri_id[ps.clamp(0, n - 1).long()]
    tri_frac = float(((ktid == ptid) & valid).sum()) / nvalid
    if tri_frac < 0.999:
        raise RuntimeError(f"{what}: tri_id equal on only {tri_frac:.5f}")
    shares, mism = output_shares(outputs, kres[2:-1], pres[2:-1], valid,
                                 what)
    return dict(valid=nvalid, tri_id_equal=tri_frac, mismatch_share=mism,
                mismatch_shares=shares,
                max_abs_err=float((kt - pt).abs().max()))


def compare_rays(kres, pres, active, what: str) -> dict:
    """Hold a shadow-ray kernel's (i32 block, counts) against the plain
    version's; ``active``: the rays that walk (t_max > t_min, or a valid
    origin)."""
    kc, pc = kres[-1].tolist(), pres[-1].tolist()
    if kc != [0, 0] or pc != [0, 0]:
        raise RuntimeError(f"{what}: walk counters kernel {kc} plain {pc}")
    k, p = kres[0], pres[0]
    nact = int(active.sum())
    if nact == 0:
        raise RuntimeError(f"{what}: no active ray")
    if bool((k[~active] != 0).any()):
        raise RuntimeError(f"{what}: output set on an inactive ray")
    mism = int(((k != p) & active).sum()) / nact
    if mism > 1e-3:
        raise RuntimeError(f"{what}: outputs differ on {mism:.2e} of "
                           f"active rays")
    return dict(valid=nact, mismatch_share=mism,
                max_abs_err=float((k - p).abs().max()))


def check(name, kres, pres, args, kw, what, tri_id=None) -> dict:
    """The comparison that fits kernel ``name``'s outputs; ``tri_id``: the
    accel's sorted->original ids, for the kernels that return a sorted
    index alone."""
    if name in SHADE_TABLE_KERNELS or name in ("binary_closest",
                                               "first_hit", "w8t_closest"):
        return compare_st(kres, pres, what, outputs_of(name, kw), tri_id)
    if name in SHADOW_RAYS or name in ("binary_any", "w8t_any"):
        rays = args[0]
        active = rays[:, 9] > kw["t_min"] \
            if name in ("any", "binary_any", "w8t_any") \
            else rays[:, 3] > 0.0
        return compare_rays(kres, pres, active, what)
    return compare(kres, pres, what, outputs_of(name, kw))


def bound(stats: dict, args, res, binary: bool = False) -> dict:
    """Least time for the same work on the card: bytes of every input and
    output once over the memory rate, the kernel's float32 operations
    (from the plain version's counted visits) over the float32 peak.
    ``ops_upper`` ignores the kernel's early exits (every child slot
    slab-tested, every triangle of a visited leaf tested) and shows what
    they save. ``binary``: a binary walk's pop tests its two boxes (counted
    in slab_tests) and compares no empty slots."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)] + list(res)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = {k: int(stats.get(k, 0)) for k in (
        "pops", "slab_tests", "closest_tris", "anyhit_tris",
        "anyhit_leaf_tris")}
    # (ops per pop, child slots per pop, ops per slot where every slot is
    # tested: its slab test and, on the wide rows, its empty-slot compare)
    per_pop, slots, per_slot = (0, 2, OPS_PER_SLAB) if binary else \
        (OPS_PER_POP, 8, OPS_PER_SLAB + 1)
    ops = (n["pops"] * per_pop + n["slab_tests"] * OPS_PER_SLAB
           + (n["closest_tris"] + n["anyhit_tris"]) * OPS_PER_TRI)
    ops_upper = (n["pops"] * slots * per_slot
                 + (n["closest_tris"] + n["anyhit_leaf_tris"]) * OPS_PER_TRI)
    bytes_ms = nbytes / HBM_RATE * 1e3
    ops_ms = ops / FP32_PEAK * 1e3
    return dict(bytes=nbytes, ops=ops, ops_upper=ops_upper, **n,
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def variant_stem(name: str) -> str:
    """A kernel's mode without its attrs=0 (_st) or attrs=2 (_tex)
    suffix."""
    for suffix in ("_st", "_tex"):
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return name


def outputs_of(name, kw):
    """The kernel's i32 outputs for ``compare``."""
    name = variant_stem(name)
    if name == "closest_shadow":
        return [("bits", 1)]
    if name == "closest_multi_shadow":
        return [("bits", len(kw["points"]))]
    if name == "closest_soft_multi_shadow":
        return [("count", 0), ("bits", kw["n_extra"])]
    if name in ("closest_attrs", "closest", "binary_closest", "first_hit",
                "w8t_closest", "w8t_closest_attrs"):
        return []
    return [("count", 0)]


def check_pair(name, args, kw, what, tri_id=None) -> tuple:
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
    res = check(name, kres, pres, args, kw, what, tri_id)
    kfn.launches = before
    return res, kres


def time_pair(name, args, kw, reps: int = 10, tri_id=None) -> dict:
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
    cmp = check(name, kres, pres, args, kw, f"{name} whole block", tri_id)
    return dict(ms=ms, plain_ms=plain_ms, compare=cmp,
                **bound(stats, args, kres, name in BINARY_KERNELS))


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version at 512^2
# ---------------------------------------------------------------------------

def inputs(name, acc, attr_tables, o, d, **spec):
    """The kernel's arguments for these rays, as the frame packs them (the
    attrs=0 variants and the plain closest hit take no tables; the attrs=2
    variants take the attrs=1 inputs)."""
    import tpurt_torch.kernels.traverse as tr
    if name in ("closest", "first_hit"):
        return tr.closest_inputs(acc, o, d, **spec)[:2]
    if name.endswith("_st"):
        attr_tables = None
    name = variant_stem(name)
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
        hard[f"{kind} channels"] = kres[0]
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
    out.update(small_unfused(r, mesh, cam, o, d, acc, sun, lpos, cone_cos,
                             hard["directional channels"]))
    return out


def small_unfused(r, mesh, cam, o, d, acc, sun, lpos, cone_cos,
                  hard_channels) -> dict:
    """The unfused frame's kernels at 512^2: the closest hit alone, then
    shadow rays and origins made from its G-buffer on the unordered
    accel, as the unfused shadow pass makes them."""
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.passes.gbuffer import gbuf_from_attr_channels
    from tpurt_torch.passes.shadow import shadow_ray_batch
    from tpurt_torch.types import Light
    out = {}
    args, kw, p, meta = tr.closest_attrs_inputs(acc, o, d, r.attr_tables)
    res, kres = check_pair("closest_attrs", args, kw, "512^2 closest_attrs")
    if not torch.equal(kres[0], hard_channels):
        raise RuntimeError("closest_attrs channels differ from "
                           "closest_shadow's")
    res.update(time_pair("closest_attrs", args, kw, 20))
    out["closest_attrs"] = res
    log(f"phase 3 closest_attrs: {json.dumps(res)}")
    gbuf = gbuf_from_attr_channels(tr._attr_channels(kres[0], p, meta), o, d,
                                   cam, mesh)
    bounds = (r.accel.root_min, r.accel.root_max)
    lights = {"directional": Light.directional(sun),
              "point": Light.point(lpos)}
    occ = {}
    for kind, light in lights.items():
        so, sd, stm = shadow_ray_batch(gbuf, light, BIAS, None, bounds)
        args, kw = tr.any_inputs(r.accel, so, sd, stm)[:2]
        res, kres = check_pair("any", args, kw, f"512^2 any {kind}")
        occ[kind] = kres[0]
        res.update(time_pair("any", args, kw, 20))
        out[f"any/{kind}"] = res
        log(f"phase 3 any {kind}: {json.dumps(res)}")
    origins = gbuf["position"] + gbuf["gnormal"] * BIAS
    samplers = (("any_soft", dict(axis_dir=lights["directional"].direction,
                                  cone_cos=cone_cos), "directional"),
                ("any_point_soft", dict(light_pos=lpos, radius=0.4),
                 "point"))
    for name, spec, hard_kind in samplers:
        for zero in (False, True):
            what = f"512^2 {name} zero_stream={zero}"
            args, kw = getattr(tr, f"{name}_inputs")(
                r.accel, origins, gbuf["valid"], spp=SPP, seed=11, light=1,
                zero_stream=zero, **spec)[:2]
            res, kres = check_pair(name, args, kw, what)
            active = args[0][:, 3] > 0.0
            if zero:
                share = int(((kres[0] != SPP * occ[hard_kind]) & active)
                            .sum()) / int(active.sum())
                if share > 1e-3:
                    raise RuntimeError(f"{what}: counts differ from spp x "
                                       f"any's occlusion on {share:.2e}")
                res["zero_vs_hard_mismatch"] = share
            else:
                cnt = kres[0][active]
                res["penumbra_share"] = float(
                    ((cnt > 0) & (cnt < SPP)).float().mean())
                if not res["penumbra_share"] > 0:
                    raise RuntimeError(f"{what}: no penumbra")
                res.update(time_pair(name, args, kw, 20))
            out[f"{name}/zero={zero}"] = res
            log(f"phase 3 {what}: {json.dumps(res)}")
    return out


# The penumbra kernels' (ray, sample) grouping: spp values that divide a
# warp, that do not, and one above a block's 128 rays.
PSOFT_SPPS = (3, 8, 33, 130)
PSOFT_RES = 128
PSOFT_KERNELS = ("closest_point_soft_shadow", "closest_point_soft_shadow_st",
                 "closest_point_soft_shadow_tex", "any_point_soft")


def exact_pair(name, args, kw, what) -> list:
    """The kernel and its plain version on the same inputs, every output
    (phase-1 channels, counts, walk counters) equal bit for bit -> the
    kernel's outputs."""
    kfn, pfn = kernel(name)
    before = kfn.launches
    kres = kfn(*args, **kw)
    torch.cuda.synchronize()
    if kfn.launches != before + 1:
        raise RuntimeError(f"{name}: launch counter did not grow")
    kfn.launches = before
    pres = pfn(*args, **kw)
    for i, (a, b) in enumerate(zip(kres, pres)):
        if a.shape != b.shape or not torch.equal(a, b):
            raise RuntimeError(f"{what}: output {i} differs from the plain "
                               f"version on {int((a != b).sum())} elements")
    return kres


def small_psoft_spp(dev) -> dict:
    """PSOFT (attrs 0, 1, 2) and ANY_PSOFT, one thread per (ray, sample),
    against their plain versions on phase 3's teapot at 128x128 (16
    packets, 128 blocks): spp 3, 8, 33 and 130 with the real and the zero
    stream, then stack_size 4 with an iteration cap of 2, where pushes are
    dropped and walks capped. Every output equal."""
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.app import Renderer
    from tpurt_torch.bvh.wide import order_children_for_point
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.passes.gbuffer import gbuf_from_attr_channels
    from tpurt_torch.scenes import default_camera_for, teapot_scene
    from tpurt_torch.types import Light, RenderConfig
    t0 = time.perf_counter()
    mesh = teapot_scene(SMALL_TRIS)
    cam = default_camera_for(mesh)
    bmin, bmax = mesh.bounds()
    lpos = 0.5 * (bmin + bmax) + np.float32([2.0, 6.0, 1.0])
    r = Renderer(mesh, cam, Light.point(lpos),
                 RenderConfig(width=PSOFT_RES, height=PSOFT_RES,
                              leaf_size=14), device=dev)
    acc = order_children_for_point(r.accel, cam.position)
    o, d = generate_rays(cam, PSOFT_RES, PSOFT_RES, dev)
    args, kw, p, meta = tr.closest_attrs_inputs(acc, o, d, r.attr_tables)
    gbuf = gbuf_from_attr_channels(
        tr._attr_channels(tr.closest_attrs_reference(*args, **kw)[0], p,
                          meta), o, d, cam, mesh)
    origins = gbuf["position"] + gbuf["gnormal"] * BIAS

    def args_of(name, spp, zero, stack_size=tr.STACK_CAPACITY):
        if name == "any_point_soft":
            return tr.any_point_soft_inputs(
                r.accel, origins, gbuf["valid"], lpos, 0.4, spp, 11, 1,
                zero_stream=zero, stack_size=stack_size)[:2]
        return inputs(name, acc, r.attr_tables, o, d, light_pos=lpos,
                      radius=0.4, spp=spp, seed=11, zero_stream=zero,
                      stack_size=stack_size)

    out = {}
    for spp in PSOFT_SPPS:
        for zero in (False, True):
            for name in PSOFT_KERNELS:
                what = f"{PSOFT_RES}^2 {name} spp {spp} zero_stream={zero}"
                kres = exact_pair(name, *args_of(name, spp, zero), what)
                cnt = kres[-2]
                if kres[-1].tolist() != [0, 0]:
                    raise RuntimeError(f"{what}: walk counters "
                                       f"{kres[-1].tolist()}")
                if zero and not bool(((cnt == 0) | (cnt == spp)).all()):
                    raise RuntimeError(f"{what}: a zero-stream count is "
                                       f"neither 0 nor spp")
                if not zero and not bool(((cnt > 0) & (cnt < spp)).any()):
                    raise RuntimeError(f"{what}: no penumbra")
                out[f"{name}/spp={spp}/zero={zero}"] = dict(
                    occluded_samples=int(cnt.sum()),
                    penumbra_rays=int(((cnt > 0) & (cnt < spp)).sum()))
    for name in PSOFT_KERNELS:
        what = f"{PSOFT_RES}^2 {name} stack_size 4, max_iters 2"
        args, kw = args_of(name, SPP, False, stack_size=4)
        kres = exact_pair(name, args, dict(kw, max_iters=2), what)
        overflow, capped = kres[-1].tolist()
        if not (overflow > 0 and capped > 0):
            raise RuntimeError(f"{what}: counters {[overflow, capped]} are "
                               f"not both non-zero")
        out[f"{name}/stack_size=4"] = dict(overflow=overflow, capped=capped)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 3 penumbra grouping: {json.dumps(out)}")
    return out


def ptxas_report(log_text: str) -> dict:
    """ptxas's lines per kernel entry -> {mangled name: registers, spill
    stores and loads, stack frame bytes}."""
    import re
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_frame=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
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
    8th row of it, on the accel the frame walks (camera-ordered unless
    the config turns that off)."""
    from tpurt_torch.app import _gb_accel
    from tpurt_torch.camera import generate_rays
    acc = _gb_accel(r.accel, r.camera, r.config)
    o, d = generate_rays(r.camera, w, h, r.device)
    full = inputs(name, acc, r.attr_tables, o, d, **spec)
    sub = inputs(name, acc, r.attr_tables, o[::8].contiguous(),
                 d[::8].contiguous(), **spec)
    return full, sub


def kernel_vs_plain(name, r, w, h, what, **spec) -> dict:
    from tpurt_torch.app import _gb_accel
    return vs_plain(name, *frame_inputs(name, r, w, h, **spec), what,
                    tri_id=_gb_accel(r.accel, r.camera, r.config).tri_id)


def vs_plain(name, full_inputs, sub_inputs, what, tri_id=None) -> dict:
    """The kernel against its plain version on every 8th row, then timed
    and compared on the whole frame."""
    (args, kw), (sargs, skw) = full_inputs, sub_inputs
    sub, _ = check_pair(name, sargs, skw, f"{what} every 8th row", tri_id)
    log(f"{what} every 8th row: {json.dumps(sub)}")
    full = time_pair(name, args, kw, tri_id=tri_id)
    log(f"{what} whole frame: {json.dumps(full)}")
    full["subsample"] = sub
    full["max_abs_err"] = max(sub["max_abs_err"],
                              full["compare"]["max_abs_err"])
    full["mismatch_share"] = max(sub["mismatch_share"],
                                 full["compare"]["mismatch_share"])
    return full


def span_ms(r, n: int = 3, pose=None) -> dict:
    """Where a frame's time goes, from the program's own spans: n frames
    (each after ``pose(i)``) under torch.profiler -> per span of
    ``Renderer.spans``, its device-timeline ms, self ms, host ms and
    entries a frame over those frames, and the host syncs a frame."""
    from torch.profiler import ProfilerActivity, profile
    sp = r.spans
    before, frames, syncs = sp.totals, sp.frames, sp.syncs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for i in range(n):
            if pose is not None:
                pose(i)
            r.render_frame()
        torch.cuda.synchronize()
    n = sp.frames - frames
    out = {name: {k: (v - before.get(name, {}).get(k, 0.0)) / n
                  for k, v in t.items()}
           for name, t in sp.totals.items()}
    out["host_syncs_per_frame"] = (sp.syncs - syncs) / n
    return out


def counted_syncs(r, what: str, want: int) -> dict:
    """One frame under torch.profiler and CUDA's sync debug mode: the
    syncs the debug mode finds must be the frame's own count
    (``Renderer.spans.syncs``), and ``want``."""
    from torch.profiler import ProfilerActivity, profile
    sp = r.spans
    syncs = sp.syncs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        found = host_syncs(r.render_frame)
        torch.cuda.synchronize()
    counted = sp.syncs - syncs
    if not counted == len(found) == want:
        raise RuntimeError(f"{what}: the frame counted {counted} host syncs, "
                           f"the sync debug mode found {len(found)}, want "
                           f"{want}: {found}")
    res = dict(host_syncs=counted, where=found)
    log(f"{what} host syncs a frame: {json.dumps(res)}")
    return res


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
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    light = Light.directional(SUN_DIR)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14)
    r = Renderer(mesh, cam, light, cfg, device=dev)
    log(f"phase 4 setup: tris={mesh.num_triangles} {json.dumps(setup_stats(r))}")
    torch.cuda.reset_peak_memory_stats()
    (kept, frame_ms), n = drive({"closest_shadow": 6, "frame_resolve": 6},
                                lambda: frames(r, 6))
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
    nvalid = int(valid.sum())
    return dict(launches=n["closest_shadow"],
                resolve_launches=n["frame_resolve"], frame_ms=frame_ms,
                frame_ms_mean=mean_ms, kernel=kp, spans=span_ms(r),
                syncs=counted_syncs(r, "phase 4", 1),
                image=kept[0]["image"], valid=valid, renderer=r,
                valid_share=valid_share,
                occluded_share=occ_share,
                peak_mem_mb=peak_mb, tris=mesh.num_triangles,
                **rays_per_s(MAIN_W * MAIN_H, nvalid, nvalid, mean_ms),
                **setup_stats(r))


def phase_config3(dev, mesh) -> dict:
    """Config 3: 2 deg sun, spp 8, accumulation, 1080p."""
    from tpurt_torch.app import Renderer, frame_seed
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    sun = Light.sun(SUN_DIR, angular_radius_deg=2.0)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, spp=SPP, accumulate=True,
                       leaf_size=14)
    r = Renderer(mesh, cam, sun, cfg, device=dev)
    if r.route != "fused0":
        raise RuntimeError(f"config 3 takes route {r.route}")
    (kept, frame_ms), n = drive({"closest_soft_shadow": 6,
                                 "frame_resolve": 6}, lambda: frames(r, 6))
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
    nvalid = int(valid.sum())
    return dict(launches=n["closest_soft_shadow"], frame_ms=frame_ms,
                frame_ms_mean=mean_ms, kernel=kp, spans=span_ms(r),
                syncs=counted_syncs(r, "phase 5", 1),
                penumbra_share=penumbra,
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
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import RenderConfig
    cam = sponza_interior_camera()
    lights = config5_lights()
    cfg = RenderConfig(width=UHD_W, height=UHD_H, leaf_size=14)
    r = Renderer(mesh, cam, lights, cfg, device=dev)
    if r.route != "fusedN":
        raise RuntimeError(f"config 5 takes route {r.route}")
    torch.cuda.reset_peak_memory_stats()
    (kept, frame_ms), n = drive({"closest_multi_shadow": 6,
                                 "frame_resolve": 6}, lambda: frames(r, 6))
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
    nvalid = int(valid.sum())
    return dict(launches=n["closest_multi_shadow"], frame_ms=frame_ms,
                frame_ms_mean=mean_ms, kernel=kp, spans=span_ms(r),
                syncs=counted_syncs(r, "phase 6", 1),
                occluded_shares=shares,
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
        (kept, frame_ms), n = drive({name: 2, "frame_resolve": 2},
                                    lambda: frames(r, 2))
        for f in kept:
            check_image(f, MAIN_W, MAIN_H, name)
        valid = kept[0]["valid"]
        vis = kept[0]["shadow"][0][valid]
        penumbra = float(((vis > 0) & (vis < 1)).float().mean())
        if not penumbra > 0:
            raise RuntimeError(f"{name}: no penumbra")
        kp = kernel_vs_plain(name, r, MAIN_W, MAIN_H, f"phase 7 {name}",
                             **spec)
        out[name] = dict(launches=n[name], frame_ms=frame_ms, kernel=kp,
                         penumbra_share=penumbra,
                         occluded_shares=[float((s[valid] < 1).float()
                                                .mean())
                                          for s in kept[0]["shadow"]])
    return out


def unfused_inputs(name, r, light_index: int, step: int):
    """Kernel ``name``'s inputs in the Renderer's unfused frame, on every
    ``step``-th row: the closest hit on the camera-ordered accel, shadow
    rays or origins from its G-buffer on the accel as built."""
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.app import _gb_accel, frame_seed, gbuffer_production
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.passes.shadow import cone_cos, shadow_ray_batch
    cfg = r.config

    def rows(x):
        return x[::step].contiguous()
    if name in ("closest_attrs", "closest_attrs_tex"):
        o, d = generate_rays(r.camera, cfg.width, cfg.height, r.device)
        return tr.closest_attrs_inputs(_gb_accel(r.accel, r.camera, cfg),
                                       rows(o), rows(d), r.attr_tables)[:2]
    gbuf, _ = gbuffer_production(r.accel, r.mesh, r.camera, cfg,
                                 r.attr_tables)
    light = r.lights[light_index]
    if name == "any":
        so, sd, stm = shadow_ray_batch(gbuf, light, cfg.shadow_bias, None,
                                       (r.accel.root_min, r.accel.root_max))
        return tr.any_inputs(r.accel, rows(so), rows(sd), rows(stm))[:2]
    origins = rows(gbuf["position"] + gbuf["gnormal"] * cfg.shadow_bias)
    valid = rows(gbuf["valid"])
    seed = frame_seed(cfg.seed, 0)
    if name == "any_soft":
        return tr.any_soft_inputs(r.accel, origins, valid, light.direction,
                                  cone_cos(light), cfg.spp, seed,
                                  light_index)[:2]
    return tr.any_point_soft_inputs(r.accel, origins, valid, light.position,
                                    float(light.radius), cfg.spp, seed,
                                    light_index)[:2]


def in_turns(ra, rb, n: int = 5) -> dict:
    """Frame ms of two Renderers in turns (a, b, b, a, repeated n times;
    CUDA events around each frame), so that both see the same host and
    card state."""
    ms = {"a": [], "b": []}
    for _ in range(n):
        for key, r in (("a", ra), ("b", rb), ("b", rb), ("a", ra)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r.render_frame()
            end.record()
            torch.cuda.synchronize()
            ms[key].append(start.elapsed_time(end))
    return {k: dict(mean=float(np.mean(v)), min=float(np.min(v)), ms=v)
            for k, v in ms.items()}


def phase_unfused(dev, mesh, fused_config1_image) -> dict:
    """The unfused frame at 1080p: configs 1 and 3 and the lamp with
    fused_shadow=False, and the mixed set sun + lamp (fused0 + unfused)."""
    from tpurt_torch.app import Renderer
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import LIGHT_DIRECTIONAL, Light, RenderConfig
    cam = sponza_interior_camera()
    sun = Light.sun(SUN_DIR, angular_radius_deg=2.0)
    lamp = Light.point(LAMP_POS, radius=LAMP_RADIUS)
    unfused = dict(fused_shadow=False)
    # label: (lights, config fields, route, launches per frame by kernel,
    # the unfused kernels to hold against their plain versions with the
    # index of the light they trace). The three fused_shadow=False cases
    # are also timed in turns with their fused twin. The sun and the lamp
    # alone resolve from their walks' packets (app.resolves_unfused): the
    # origins kernel between the walks, the frame resolve after them.
    cases = {
        "config1_unfused": ([Light.directional(SUN_DIR)], dict(unfused),
                            "unfused", {"closest_attrs": 1, "any": 1},
                            [("closest_attrs", 0), ("any", 0)]),
        "config3_unfused": ([sun], dict(unfused, spp=SPP), "unfused",
                            {"closest_attrs": 1, "unfused_origins": 1,
                             "any_soft": 1, "frame_resolve": 1},
                            [("any_soft", 0)]),
        "lamp_unfused": ([lamp], dict(unfused, spp=SPP), "unfused",
                         {"closest_attrs": 1, "unfused_origins": 1,
                          "any_point_soft": 1, "frame_resolve": 1},
                         [("any_point_soft", 0)]),
        "sun_lamp_mixed": ([sun, lamp], dict(spp=SPP), "fused0",
                           {"closest_soft_shadow": 1, "any_point_soft": 1},
                           [("any_point_soft", 1)]),
    }
    out = {}
    for label, (lights, fields, route, per_frame, checked) in cases.items():
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14,
                           **fields)
        r = Renderer(mesh, cam, lights, cfg, device=dev)
        if r.route != route:
            raise RuntimeError(f"{label}: route {r.route}, want {route}")
        (kept, frame_ms), n = drive({k: 6 * v for k, v in per_frame.items()},
                                    lambda: frames(r, 6))
        for f in kept:
            check_image(f, MAIN_W, MAIN_H, label)
        valid = kept[0]["valid"]
        res = dict(route=route, launches=n, frame_ms=frame_ms,
                   frame_ms_mean=float(np.mean(frame_ms)),
                   occluded_shares=[float((s[valid] < 1).float().mean())
                                    for s in kept[0]["shadow"]])
        for li, light in enumerate(lights):
            if light.kind != LIGHT_DIRECTIONAL:
                vis = kept[0]["shadow"][li][valid]
                pen = float(((vis > 0) & (vis < 1)).float().mean())
                if not pen > 0:
                    raise RuntimeError(f"{label} light {li}: no penumbra")
                res[f"penumbra_share_light{li}"] = pen
        if label == "config1_unfused":
            img = kept[0]["image"]
            differ = (img != fused_config1_image).any(-1) & valid
            share = float(differ.sum()) / int(valid.sum())
            if share > 1e-3:
                raise RuntimeError(f"config 1 unfused image differs from the "
                                   f"fused one on {share:.2e} of valid pixels")
            res["vs_fused_image_share"] = share
        res["kernels"] = {
            name: vs_plain(name, unfused_inputs(name, r, li, 1),
                           unfused_inputs(name, r, li, 8),
                           f"phase 8 {label} {name}")
            for name, li in checked}
        for name, li in checked:
            if name in ("any_soft", "any_point_soft"):
                args, kw = unfused_inputs(name, r, li, 8)
                res["kernels"][name]["zero_stream_every_8th_row"] = \
                    check_pair(name, args, dict(kw, zero_stream=True),
                               f"phase 8 {label} {name} zero stream")[0]
        res["spans"] = span_ms(r)
        if not cfg.fused_shadow:
            twin = Renderer(mesh, cam, lights,
                            dataclasses.replace(cfg, fused_shadow=True),
                            device=dev)
            turns = in_turns(twin, r)
            res["in_turns_ms"] = {"fused": turns["a"], "unfused": turns["b"]}
        out[label] = res
        log(f"phase 8 {label}: {json.dumps(res)}")
    return out


# ---------------------------------------------------------------------------
# Phase 9: config 2, the per-frame rebuild
# ---------------------------------------------------------------------------

BUILD_TPU = "tpurt/kernels/build.py:"
BUILD_KERNEL_LINES = {"morton_codes": 353, "topology": 265,
                      "collapse_area": 742, "topology_depth": 265,
                      "sweep_sah_priorities": 582}
OPS_PER_CODE = 52
OPS_PER_TOPOLOGY_PLACE = 10
OPS_PER_WIDE_NODE = 190
# The depth output: per step up the parent pointers a compare and an add.
OPS_PER_DEPTH_STEP = 2


class plain_build_kernels:
    """Within the block the build wrappers take their plain versions on
    CUDA tensors too (the twin of a rebuild made with the kernels)."""

    NAMES = ("morton_codes", "topology", "collapse_area", "morton_codes60",
             "topology_depth", "sweep_sah_priorities")

    def __enter__(self):
        import tpurt_torch.kernels.build as b
        self.saved = {n: getattr(b, f"{n}_cuda") for n in self.NAMES}
        for n in self.NAMES:
            setattr(b, f"{n}_cuda", getattr(b, f"{n}_reference"))

    def __exit__(self, *exc):
        import tpurt_torch.kernels.build as b
        for n, fn in self.saved.items():
            setattr(b, f"{n}_cuda", fn)


def host_syncs(fn) -> list:
    """Run fn under CUDA's sync debug mode; each call that waits for the
    card warns, and is returned as the port's innermost frame that made
    it."""
    import traceback
    found = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if "tpurt_torch" in f.filename]
        found.append(f"{frames[-1].filename.split('tpurt_torch/')[-1]}:"
                     f"{frames[-1].lineno} {frames[-1].line}"
                     if frames else str(message))
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def build_pair(name, args, what) -> dict:
    """A build kernel and its plain version on the same inputs: every
    output equal exactly -> (comparison, kernel result)."""
    import tpurt_torch.kernels.build as b
    kfn, pfn = getattr(b, f"{name}_cuda"), getattr(b, f"{name}_reference")
    before = kfn.launches
    kres = kfn(*args)
    torch.cuda.synchronize()
    if kfn.launches != before + 1:
        raise RuntimeError(f"{name}: launch counter did not grow")
    kfn.launches = before
    pres = pfn(*args)
    torch.cuda.synchronize()
    kres = kres if isinstance(kres, tuple) else (kres,)
    pres = pres if isinstance(pres, tuple) else (pres,)
    err = 0
    for i, (k, p) in enumerate(zip(kres, pres)):
        if k.shape != p.shape or k.dtype != p.dtype or not torch.equal(k, p):
            bad = int((k != p).sum()) if k.shape == p.shape else -1
            raise RuntimeError(f"{what}: output {i} differs from the plain "
                               f"version ({bad} entries)")
        err = max(err, float((k.double() - p.double()).abs().max())
                  if k.numel() else 0.0)
    return dict(max_abs_err=err, mismatch_share=0.0)


def rebuild_frames(r, n: int):
    """n rebuild-mode frames with CUDA events around each -> (kept
    outputs, frame ms and rebuild ms of all but the first)."""
    kept, ms, build = [], [], []
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
            build.append(r.stats["build_ms"])
    return kept, ms, build


def build_bound(nbytes: int, ops: int) -> dict:
    bytes_ms = nbytes / HBM_RATE * 1e3
    ops_ms = ops / FP32_PEAK * 1e3
    return dict(bytes=nbytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def time_build(name, args, reps: int = 20) -> dict:
    """Kernel ms (CUDA events) and plain ms (host clock) on the same
    inputs."""
    import tpurt_torch.kernels.build as b
    kfn, pfn = getattr(b, f"{name}_cuda"), getattr(b, f"{name}_reference")
    before = kfn.launches
    ms = cuda_ms(lambda: kfn(*args), reps)
    kfn.launches = before
    _, plain_ms = host_ms(lambda: pfn(*args))
    return dict(ms=ms, plain_ms=plain_ms)


def build_kernel_inputs(r):
    """_rebuild_fused's intermediates on the Renderer's geometry -> the
    three build kernels' inputs at config 2's shapes: unit coordinates of
    the centroids, the clustered leaf codes' deltas, the deferred tree's
    child array and node areas."""
    from tpurt_torch.bvh import lbvh as L
    from tpurt_torch.bvh import wide as W
    from tpurt_torch.bvh.morton import unit_coords
    from tpurt_torch.kernels.build import morton_codes
    m, k, splits = r.mesh, r.config.leaf_size, r._rebuild_splits
    tpad = r.bvh.num_sorted_tris
    tri, v0, e1, e2, cen, smin, smax = L._triangle_data(m.vertices,
                                                        m.indices, tpad)
    codes = morton_codes(cen, smin, smax)
    order = torch.arange(tpad, dtype=torch.int32, device=r.device)
    chs, srt = L._sort_payload(codes, [order, v0, e1, e2, tri])
    sv0, se1, se2 = srt[1:4]
    split = L._subleaf_split(chs, *L._leaf_boxes(sv0, se1, se2, k)[2:], k,
                             splits)
    d = L.adjacent_deltas(split[1]).contiguous()
    bvh = L.build_lbvh(m.vertices, m.indices, leaf_size=k, boxes="defer",
                       split_blocks=splits)
    boxes = W._leaf_boxes_from_tris(bvh)
    tab = L.range_table(*boxes)
    area = W.node_areas(bvh, tab)
    return (unit_coords(cen, smin, smax).contiguous(), d,
            bvh.nodes_child.contiguous(), area)


def phase_config2(dev, mesh, static_image) -> dict:
    """Config 2: the per-frame rebuild at 1080p."""
    import tpurt_torch.kernels.build as B
    from tpurt_torch.app import Renderer
    from tpurt_torch.bvh.lbvh import adjacent_deltas
    from tpurt_torch.scenes import deform, sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    light = Light.directional(SUN_DIR)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14)
    t0 = time.perf_counter()
    r = Renderer(mesh, cam, light, cfg, mode="rebuild", device=dev)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    if r.route != "fused0" or r.config.order_children:
        raise RuntimeError(f"config 2 takes route {r.route}, ordered "
                           f"{r.config.order_children}")
    nl, nb = r.bvh.num_leaves, r.bvh.num_blocks
    log(f"phase 9 setup: {setup_ms:.1f} ms; blocks={nb} leaves={nl} "
        f"splits={r._rebuild_splits} nw_pad={r._nw_pad} "
        f"wide_depth={r.depth} {json.dumps(r.stats)}")

    # Each build kernel against its plain version, exactly.
    unit, d, child, area = build_kernel_inputs(r)
    rng = np.random.default_rng(2)
    values = rng.integers(0, 1 << 30, 64)
    synth = torch.from_numpy(np.sort(rng.choice(values, 30_000)).astype(
        np.int32)).to(dev)
    d30k = adjacent_deltas(synth).contiguous()
    count = int(B.collapse_area_reference(child, area, r._nw_pad)[2])
    checks = {
        "morton_codes": [build_pair("morton_codes", (unit,),
                                    "morton codes, config 2")],
        "topology": [build_pair("topology", (d,), "topology, config 2"),
                     build_pair("topology", (d30k,),
                                "topology, 30k leaves of 64 codes")],
        "collapse_area": [
            build_pair("collapse_area", (child, area, r._nw_pad),
                       "collapse, config 2 pad"),
            build_pair("collapse_area", (child, area, count // 2),
                       f"collapse, forced pad {count // 2} < {count}")],
    }
    log(f"phase 9 build kernels vs plain: count={count} "
        f"{json.dumps(checks)}")
    ni = int(child.shape[0])
    levels = max(1, ni.bit_length())
    n = int(unit.shape[0])
    kernels = {
        "morton_codes": dict(args=(unit,), **build_bound(
            n * 12 + n * 4, n * OPS_PER_CODE)),
        "topology": dict(args=(d,), **build_bound(
            ni * 4 + ni * 8 + ni * 8,
            (levels - 1) * ni + 2 * levels * ni
            + OPS_PER_TOPOLOGY_PLACE * (ni + 1))),
        "collapse_area": dict(args=(child, area, r._nw_pad), **build_bound(
            ni * 12 + r._nw_pad * 36 + 4,
            min(count, r._nw_pad) * OPS_PER_WIDE_NODE)),
    }
    for name, kk in kernels.items():
        kk.update(time_build(name, kk.pop("args")))
        kk["checks"] = checks[name]
        kk["max_abs_err"] = max(c["max_abs_err"] for c in checks[name])
        kk["mismatch_share"] = 0.0
        log(f"phase 9 {name}: {json.dumps(kk)}")

    # The whole rebuilt accel, kernels against plain versions; the kernels'
    # rebuild once more under CUDA's sync debug mode, which warns at every
    # call that waits for the card.
    syncs = host_syncs(r._rebuild)
    log(f"phase 9 host syncs in one rebuild: {len(syncs)} {syncs}")
    _, kw, kat, kcnt = r._rebuild()
    with plain_build_kernels():
        _, pw, pat, pcnt = r._rebuild()
    torch.cuda.synchronize()
    pairs = (("nodes", kw.nodes, pw.nodes), ("tris", kw.tris, pw.tris),
             ("tri_id", kw.tri_id, pw.tri_id), ("at0", kat[0], pat[0]),
             ("at1", kat[1], pat[1]), ("count", kcnt, pcnt))
    for what, a, b in pairs:
        if not torch.equal(a, b):
            raise RuntimeError(f"rebuilt accel: {what} differs between the "
                               f"kernels and the plain versions")
    log("phase 9 rebuilt accel: kernels == plain versions "
        "(nodes, tris, tri_id, at0, at1, count)")

    # Config 2 frames through the Renderer.
    (kept, frame_ms, build_ms), n = drive(
        {"closest_shadow": 6, "morton_codes": 6, "topology": 6,
         "collapse_area": 6, **resolve_launches(r, 6)},
        lambda: rebuild_frames(r, 6))
    valid_share = check_image(kept[0], MAIN_W, MAIN_H, "config 2")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("config 2 frames are not bit-identical")
    valid = kept[0]["valid"]
    diff = (kept[0]["image"] - static_image).abs().amax(-1)
    nvalid = int(valid.sum())
    share = float(((diff > 1e-3) & valid).sum()) / nvalid
    exact = float(((diff > 0) & valid).sum()) / nvalid
    if share > 1e-3:
        raise RuntimeError(f"config 2 image differs from config 1's static "
                           f"one on {share:.2e} of valid pixels")
    hard = kernel_vs_plain("closest_shadow", r, MAIN_W, MAIN_H,
                           "phase 9 closest_shadow on the rebuilt tree",
                           light_dir=light.direction)
    mean_ms = float(np.mean(frame_ms))
    # Where the time of a posed frame goes, the rebuild's parts
    # (tpurt.rebuild.*) among them, and its host syncs.
    spans = span_ms(r, pose=lambda i: r.set_vertices(deform(mesh, 0.1 * i)))
    r.set_vertices(deform(mesh, 0.4))
    syncs_posed = counted_syncs(r, "phase 9 posed", 2)
    res = dict(launches=n, frame_ms=frame_ms, frame_ms_mean=mean_ms,
               build_ms=build_ms, build_ms_mean=float(np.mean(build_ms)),
               spans=spans, syncs=syncs_posed, closest_shadow=hard,
               valid_share=valid_share,
               vs_static_share=share, vs_static_any_bit_share=exact,
               occluded_share=float((kept[0]["shadow"][0][valid] < 1.0)
                                    .float().mean()),
               nw_pad=r._nw_pad, wide_count=count, wide_depth=r.depth,
               rebuild_host_syncs=len(syncs),
               blocks=nb, leaves=nl, splits=r._rebuild_splits,
               setup_ms=setup_ms, setup=dict(r.stats),
               kernels={k: {kk: vv for kk, vv in v.items()
                            if kk != "checks"}
                        for k, v in kernels.items()},
               **rays_per_s(MAIN_W * MAIN_H, nvalid, nvalid, mean_ms))
    log(f"phase 9 config 2: {json.dumps(res)}")

    # Five animated frames.
    anim = []
    for step in range(1, 6):
        r.set_vertices(deform(mesh, 0.2 * step))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = r.render_frame()
        end.record()
        torch.cuda.synchronize()
        check_image(out, MAIN_W, MAIN_H, f"config 2 animated frame {step}")
        anim.append(dict(frame_ms=start.elapsed_time(end),
                         build_ms=r.stats["build_ms"], nw_pad=r._nw_pad))
    res["animated"] = dict(frames=anim, overflow_recoveries=int(
        r.stats["overflow_recoveries"]))
    # The recovery on the card: a pad forced below the count, one more
    # animated frame.
    before = r.stats["overflow_recoveries"]
    r._nw_pad = count // 2
    r.set_vertices(deform(mesh, 1.2))
    out, ms = host_ms(r.render_frame)
    check_image(out, MAIN_W, MAIN_H, "config 2 frame after a forced overflow")
    if r.stats["overflow_recoveries"] != before + 1:
        raise RuntimeError("the forced overflow was not recovered")
    res["animated"]["forced_overflow"] = dict(
        pad=count // 2, new_pad=r._nw_pad, frame_host_ms=ms)
    log(f"phase 9 animated: {json.dumps(res['animated'])}")
    res["image"], res["valid"] = kept[0]["image"], valid
    return res


# ---------------------------------------------------------------------------
# Phase 10: the raster G-buffer
# ---------------------------------------------------------------------------

RASTER_TPU = "tpurt/kernels/raster.py:217"
RASTER16_TPU = "tpurt/kernels/raster.py:360"
# Float32 operations of the rasterizer per (record, pixel) test: three
# edge values (2 mul, 2 add each), the d-sum (2 add), the two-sided
# coverage test (6 compares, 5 logic), 1/w (1 mul), the z-test and its
# gates (2 compares, 2 logic); and where the record takes the pixel, the
# d-weighted normal (3 x (3 mul, 2 add)) and 14 state writes.
OPS_PER_TEST = 30
OPS_PER_TAKE = 29


def raster_compare(kres, pres, what: str) -> dict:
    """The rasterizer against its plain version on the same bins: ids, u,
    v and 1/w equal, every other channel within 1e-6."""
    (kt, ka), (pt, pa) = kres, pres
    if not torch.equal(kt, pt):
        raise RuntimeError(f"{what}: tri_id differs on "
                           f"{int((kt != pt).sum())} pixels")
    if not torch.equal(ka[0:3], pa[0:3]):
        raise RuntimeError(f"{what}: u, v or 1/w differ by up to "
                           f"{float((ka[0:3] - pa[0:3]).abs().max())}")
    err = float((ka - pa).abs().max())
    if err > 1e-6:
        raise RuntimeError(f"{what}: channels differ by {err}")
    return dict(valid=int((kt >= 0).sum()), max_abs_err=err,
                mismatch_share=0.0)


def profile_device(fn, top: int = 8) -> dict:
    """One call of fn under torch.profiler (CPU and CUDA activity): the
    host milliseconds around it (synchronised, the profiler's overhead
    included), the kernels' summed device time, their launches, the idle
    share of the card over the call, and the kernels that took the most
    device time. kernel_ms 0 means the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    by_time = sorted(kernels, key=lambda e: -e.self_device_time_total)
    return dict(host_ms=wall, kernel_ms=busy,
                launches=sum(e.count for e in kernels),
                idle_share=1.0 - busy / wall if busy else None,
                top=[[e.key[:72], e.count, e.self_device_time_total / 1e3]
                     for e in by_time[:top]])


def bins_stats(bins) -> dict:
    """The binning's load: pair rows, big rows and pair rows per tile."""
    counts = bins.row_counts.double()
    q = torch.quantile(counts, torch.tensor(
        [0.5, 0.9, 0.99], dtype=torch.float64, device=counts.device))
    return dict(cap_rows=int(bins.pair_rows.shape[0]),
                pair_rows=int(counts.sum()), big_nrows=int(bins.big_nrows),
                tiles=int(counts.numel()),
                empty_tiles=int((counts == 0).sum()),
                rows_per_tile=dict(zip(("mean", "median", "p90", "p99", "max"),
                                       [float(counts.mean()), *q.tolist(),
                                        float(counts.max())])),
                overflow=bool(bins.overflow))


def phase_raster(dev, mesh, c1) -> dict:
    """The raster G-buffer at 1080p; c1: phase 4's image, valid mask and
    Renderer."""
    import tpurt_torch.kernels.raster as R
    from tpurt_torch.app import Renderer
    from tpurt_torch.raster.setup import bin_rows, default_cap_rows
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    w, h = MAIN_W, MAIN_H
    cam = sponza_interior_camera()
    light = Light.directional(SUN_DIR)
    cfg = RenderConfig(width=w, height=h, leaf_size=14, gbuffer="raster")
    r = Renderer(mesh, cam, light, cfg, device=dev)
    if r.route != "unfused" or r.attr_tables is not None:
        raise RuntimeError(f"raster frame: route {r.route}, attribute rows "
                           f"{r.attr_tables is not None}")
    (kept, frame_ms), n = drive({"rasterize_rows": 6, "any": 6},
                                lambda: frames(r, 6))
    valid_share = check_image(kept[0], w, h, "raster")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("raster frames are not bit-identical")
    valid = kept[0]["valid"]
    coverage = float((valid != c1["valid"]).float().mean())
    diff = (kept[0]["image"] - c1["image"]).abs().amax(-1)
    image_share = float((diff > 2e-2).float().mean())
    if coverage >= 0.002 or image_share >= 0.01:
        raise RuntimeError(f"raster frame against the ray-cast one: "
                           f"coverage differs on {coverage:.2e}, the image "
                           f"on {image_share:.2e} of pixels")
    mean_ms = float(np.mean(frame_ms))
    res = dict(launches=n, frame_ms=frame_ms, frame_ms_mean=mean_ms,
               valid_share=valid_share, vs_ray_coverage_share=coverage,
               vs_ray_image_share=image_share,
               occluded_share=float((kept[0]["shadow"][0][valid] < 1.0)
                                    .float().mean()),
               setup=dict(r.stats))
    log(f"phase 10 raster frames: {json.dumps(res)}")

    # The kernel against its plain version on the frame's bins.
    cap = default_cap_rows(mesh.num_triangles)
    bins = bin_rows(cam, r.mesh, w, h, cap)
    syncs = host_syncs(lambda: bin_rows(cam, r.mesh, w, h, cap))
    if syncs:
        raise RuntimeError(f"bin_rows waited for the card: {syncs}")
    res["bins"] = bins_stats(bins)
    res["bin_rows_host_syncs"] = len(syncs)
    log(f"phase 10 bins: {json.dumps(res['bins'])}")
    before = R.rasterize_rows_cuda.launches
    kres = R.rasterize_rows_cuda(bins, w, h)
    torch.cuda.synchronize()
    if R.rasterize_rows_cuda.launches != before + 1:
        raise RuntimeError("rasterize_rows: launch counter did not grow")
    ms = cuda_ms(lambda: R.rasterize_rows_cuda(bins, w, h), 20)
    R.rasterize_rows_cuda.launches = before
    stats = {}
    pres, plain_ms = host_ms(lambda: R.rasterize_rows_reference(
        bins, w, h, stats=stats))
    cmp = raster_compare(kres, pres, "phase 10 rasterizer, whole frame")
    ntiles = int(bins.row_starts.numel())
    nbytes = ((res["bins"]["pair_rows"] + res["bins"]["big_nrows"] * ntiles)
              * 512 + 2 * ntiles * 4 + 13 * w * h * 4)
    ops = OPS_PER_TEST * stats["record_tests"] + OPS_PER_TAKE * stats["takes"]
    res["kernel"] = dict(ms=ms, plain_ms=plain_ms, compare=cmp,
                         max_abs_err=cmp["max_abs_err"], mismatch_share=0.0,
                         **stats, **build_bound(nbytes, ops))
    log(f"phase 10 rasterizer: {json.dumps(res['kernel'])}")

    # Where the frame's time goes: the program's spans, and inside
    # tpurt.gbuffer the binning and the rasterizer (mean of 5 calls each).
    st = {"binning": cuda_ms(lambda: bin_rows(cam, r.mesh, w, h, cap), 5),
          "raster_kernel": cuda_ms(lambda: R.rasterize_rows_cuda(bins, w, h),
                                   5),
          "spans": span_ms(r)}
    res["stages_ms"] = st
    turns = in_turns(c1["renderer"], r)
    res["in_turns_ms"] = {"ray": turns["a"], "raster": turns["b"]}
    log(f"phase 10 stages: {json.dumps(st)}; in turns "
        f"{json.dumps(res['in_turns_ms'])}")
    res["profile"] = {"binning": profile_device(
        lambda: bin_rows(cam, r.mesh, w, h, cap)),
        "raster_frame": profile_device(r.render_frame)}
    log(f"phase 10 profile: {json.dumps(res['profile'])}")

    # The "auto" paths that take the rasterizer on the card.
    def against_raster(img, v):
        d = (img - kept[0]["image"]).abs().amax(-1)
        return float(((d > 1e-3) & v).sum()) / int(v.sum())
    r2 = Renderer(mesh, cam, light, RenderConfig(
        width=w, height=h, leaf_size=14, sah=False), device=dev)
    if r2.config.gbuffer != "raster":
        raise RuntimeError("sah=False with gbuffer='auto' took the ray cast")
    (k2, ms2), n2 = drive({"rasterize_rows": 3, "any": 3},
                          lambda: frames(r2, 3))
    share2 = against_raster(k2[0]["image"], k2[0]["valid"])
    if share2 > 1e-3:
        raise RuntimeError(f"sah=False raster frame differs on {share2:.2e}")
    res["sah_false_auto"] = dict(launches=n2, frame_ms=ms2,
                                 vs_raster_share=share2, setup=r2.stats)
    rb = Renderer(mesh, cam, light, RenderConfig(
        width=w, height=h, leaf_size=14, rebuild_splits=0), mode="rebuild",
        device=dev)
    if rb.config.gbuffer != "raster" or rb.attr_tables is not None:
        raise RuntimeError("rebuild_splits=0 with gbuffer='auto' did not "
                           "take the rasterizer without attribute rows")
    (k3, ms3, build3), n3 = drive(
        {"rasterize_rows": 6, "any": 6, "morton_codes": 6, "topology": 6,
         "collapse_area": 6}, lambda: rebuild_frames(rb, 6))
    for f in k3[1:]:
        if not torch.equal(f["image"], k3[0]["image"]):
            raise RuntimeError("raster rebuild frames are not bit-identical")
    share3 = against_raster(k3[0]["image"], k3[0]["valid"])
    if share3 > 1e-3:
        raise RuntimeError(f"raster rebuild frame differs on {share3:.2e}")
    res["rebuild_plain_morton"] = dict(
        launches=n3, frame_ms=ms3, frame_ms_mean=float(np.mean(ms3)),
        build_ms=build3, build_ms_mean=float(np.mean(build3)),
        vs_raster_share=share3, nw_pad=rb._nw_pad, wide_depth=rb.depth,
        setup=dict(rb.stats))
    log(f"phase 10 auto paths: sah=False {json.dumps(res['sah_false_auto'])}"
        f"; rebuild {json.dumps(res['rebuild_plain_morton'])}")

    # A pair capacity too small for the view must be grown.
    r.config = dataclasses.replace(r.config, raster_cap_pairs=4096)
    grown = r.stats["raster_cap_growths"]
    out, host = host_ms(r.render_frame)
    if r.stats["raster_cap_growths"] != grown + 1 or \
            not torch.equal(out["image"], kept[0]["image"]):
        raise RuntimeError("the forced pair capacity was not recovered")
    res["forced_cap"] = dict(cap=4096, new_cap=r.config.raster_cap_pairs,
                             frame_host_ms=host)
    log(f"phase 10 forced capacity: {json.dumps(res['forced_cap'])}")
    res["renderer"] = r
    return res


# ---------------------------------------------------------------------------
# Phase 11: the shade-table G-buffer
# ---------------------------------------------------------------------------

def with_attrs1_twin(name, kres, args1, kw1) -> None:
    """Fail unless the attrs=0 kernel's result ``kres`` (t, sidx, *i32
    outputs, counts) is the attrs=1 kernel's on the same rays: t and sidx
    its attribute block's channels 0-1, the i32 outputs equal."""
    base = name[:-len("_st")] if name != "closest" else "closest_attrs"
    kfn = kernel(base)[0]
    before = kfn.launches
    ares = kfn(*args1, **kw1)
    kfn.launches = before
    torch.cuda.synchronize()
    same = (torch.equal(kres[0], ares[0][:, 0])
            and torch.equal(kres[1], ares[0][:, 1].to(torch.int32))
            and all(torch.equal(a, b) for a, b in zip(kres[2:-1],
                                                      ares[1:-1])))
    if not same:
        raise RuntimeError(f"{name}: differs from the attrs=1 kernel "
                           f"{base} on the same rays")


def small_shade_table(dev) -> dict:
    """Row 6 and the five attrs=0 modes against their plain versions at
    phase 3's size (teapot 10k, 512x512, leaf 14), and against their
    attrs=1 twins."""
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
    sampled = dict(spp=SPP, seed=11)
    specs = {
        "closest_shadow_st": [
            ("directional", dict(light_dir=sun)),
            ("point", dict(light_dir=sun, light_pos=lpos))],
        "closest_multi_shadow_st": [
            ("3 lights", dict(lights=[(sun, None), (None, lpos),
                                      (fill, None)]))],
        "closest_soft_shadow_st": [
            ("cone", dict(axis_dir=sun, cone_cos=cone_cos, **sampled))],
        "closest_point_soft_shadow_st": [
            ("disk", dict(light_pos=lpos, radius=0.4, **sampled))],
        "closest_soft_multi_shadow_st": [
            ("cone+2", dict(light0=("cone", sun, cone_cos),
                            extra_dirs=[fill, fill2], **sampled)),
            ("disk+1", dict(light0=("disk", lpos, 0.4), extra_dirs=[fill],
                            **sampled))],
    }
    out = {}
    for name, cases in specs.items():
        for label, spec in cases:
            zeros = (False, True) if "spp" in spec else (None,)
            for zero in zeros:
                sp = spec if zero is None else dict(spec, zero_stream=zero)
                what = f"512^2 {name} {label} zero_stream={zero}"
                args, kw = inputs(name, acc, None, o, d, **sp)
                res, kres = check_pair(name, args, kw, what, acc.tri_id)
                with_attrs1_twin(name, kres, *inputs(
                    name[:-len("_st")], acc, r.attr_tables, o, d, **sp))
                if not zero:
                    res.update(time_pair(name, args, kw, 20, acc.tri_id))
                out[f"{name}/{label}/zero={zero}"] = res
                log(f"phase 11 {what}: {json.dumps(res)}")
    # Row 6: the plain closest hit, then with a per-ray t_max of half the
    # closest t on every other row (those rays must miss) and 1.001 times
    # it on the others.
    import tpurt_torch.kernels.traverse as tr
    args, kw = inputs("closest", acc, None, o, d)
    res, kres = check_pair("closest", args, kw, "512^2 closest", acc.tri_id)
    with_attrs1_twin("closest", kres,
                     *tr.closest_attrs_inputs(acc, o, d, r.attr_tables)[:2])
    res.update(time_pair("closest", args, kw, 20, acc.tri_id))
    out["closest"] = res
    log(f"phase 11 512^2 closest: {json.dumps(res)}")
    t = tr.trace_closest(acc, o, d)[0]
    scale = torch.full_like(t, 1.001)
    scale[::2] = 0.5
    t_max = torch.where(torch.isfinite(t), t * scale, 1e3)
    args, kw = inputs("closest", acc, None, o, d, t_max=t_max)
    res, kres = check_pair("closest", args, kw, "512^2 closest, t_max",
                           acc.tri_id)
    capped = tr._unpack(kres[1], ("img", SMALL_RES, SMALL_RES))[::2]
    if bool((capped >= 0).any()):
        raise RuntimeError("closest: a ray capped at half its t hit")
    out["closest/t_max"] = res
    log(f"phase 11 512^2 closest, per-ray t_max: {json.dumps(res)}")
    return out


def phase_shade_table(dev, mesh, c1) -> dict:
    """The shade-table frames at 1080p (static, every route) and config 2
    with the flag; c1: phase 4's image, valid mask and Renderer."""
    from tpurt_torch.app import Renderer, frame_seed
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    hard = Light.directional(SUN_DIR)
    sun = Light.sun(SUN_DIR, angular_radius_deg=2.0)
    fills = config5_lights()[1:]
    lamp = Light.point(LAMP_POS, radius=LAMP_RADIUS)
    seed = frame_seed(0, 0)
    cone = float(np.cos(sun.angular_radius))
    # label: (lights, config fields, route, the kernel of the case and
    # its spec, the launches per frame by kernel)
    cases = {
        "config1": ([hard], {}, "fused0", "closest_shadow_st",
                    dict(light_dir=hard.direction),
                    {"closest_shadow_st": 1}),
        "config1_unfused": ([hard], dict(fused_shadow=False), "unfused",
                            "closest", {}, {"closest": 1, "any": 1}),
        "config3": ([sun], dict(spp=SPP), "fused0", "closest_soft_shadow_st",
                    dict(axis_dir=sun.direction, cone_cos=cone, spp=SPP,
                         seed=seed), {"closest_soft_shadow_st": 1}),
        "config5_lights": (config5_lights(), {}, "fusedN",
                           "closest_multi_shadow_st",
                           dict(lights=[(l.direction, None)
                                        for l in config5_lights()]),
                           {"closest_multi_shadow_st": 1}),
        "lamp": ([lamp], dict(spp=SPP), "fused0",
                 "closest_point_soft_shadow_st",
                 dict(light_pos=lamp.position, radius=LAMP_RADIUS, spp=SPP,
                      seed=seed), {"closest_point_soft_shadow_st": 1}),
        "sun_fills": ([sun] + fills, dict(spp=SPP), "fusedSM",
                      "closest_soft_multi_shadow_st",
                      dict(light0=("cone", sun.direction, cone),
                           extra_dirs=[l.direction for l in fills], spp=SPP,
                           seed=seed), {"closest_soft_multi_shadow_st": 1}),
    }
    out, kernels, launched = {}, {}, {}
    static = None
    for label, (lights, fields, route, name, spec, per_frame) in \
            cases.items():
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14,
                           inkernel_attrs=False, **fields)
        r = Renderer(mesh, cam, lights, cfg, device=dev)
        if (r.route != route or r.attr_tables is not None
                or r.shade_table is None):
            raise RuntimeError(f"shade table {label}: route {r.route}")
        (kept, frame_ms), n = drive({k: 6 * v for k, v in per_frame.items()},
                                    lambda: frames(r, 6))
        for f in kept:
            check_image(f, MAIN_W, MAIN_H, f"shade table {label}")
        valid = kept[0]["valid"]
        res = dict(route=route, launches=n, frame_ms=frame_ms,
                   frame_ms_mean=float(np.mean(frame_ms)),
                   setup=dict(r.stats),
                   occluded_shares=[float((s[valid] < 1).float().mean())
                                    for s in kept[0]["shadow"]])
        if "spp" in fields:
            vis = kept[0]["shadow"][0][valid]
            res["penumbra_share"] = float(((vis > 0) & (vis < 1)).float()
                                          .mean())
            if not res["penumbra_share"] > 0:
                raise RuntimeError(f"shade table {label}: no penumbra")
        if label.startswith("config1"):
            for f in kept[1:]:
                if not torch.equal(f["image"], kept[0]["image"]):
                    raise RuntimeError(f"shade table {label}: frames are "
                                       f"not bit-identical")
            diff = (kept[0]["image"] - c1["image"]).abs().amax(-1)
            res["vs_attr_image_share"] = float((diff > 2e-2).float().mean())
            res["vs_attr_coverage_share"] = float(
                (valid != c1["valid"]).float().mean())
            if res["vs_attr_image_share"] > 1e-2:
                raise RuntimeError(f"shade table {label}: image differs "
                                   f"from phase 4's on "
                                   f"{res['vs_attr_image_share']:.2e}")
            turns = in_turns(c1["renderer"], r)
            res["in_turns_ms"] = {"attr": turns["a"],
                                  "shade_table": turns["b"]}
        if label == "config1":
            static = kept[0]["image"]
        if label in ("config1", "config1_unfused"):
            res["spans"] = span_ms(r)
        kernels[name] = kernel_vs_plain(name, r, MAIN_W, MAIN_H,
                                        f"phase 11 {label} {name}", **spec)
        launched[name] = n[name]
        res["kernel"] = kernels[name]
        out[label] = res
        log(f"phase 11 {label}: {json.dumps(res)}")

    # Config 2 with the shade table: the rebuilt tree's table every frame.
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14,
                       inkernel_attrs=False)
    r = Renderer(mesh, cam, hard, cfg, mode="rebuild", device=dev)
    if r.route != "fused0" or r.shade_table is None:
        raise RuntimeError(f"shade table config 2: route {r.route}")
    syncs = host_syncs(r._rebuild)
    if syncs:
        raise RuntimeError(f"the shade-table rebuild waited for the card: "
                           f"{syncs}")
    (kept, frame_ms, build_ms), n = drive(
        {"closest_shadow_st": 6, "morton_codes": 6, "topology": 6,
         "collapse_area": 6}, lambda: rebuild_frames(r, 6))
    valid_share = check_image(kept[0], MAIN_W, MAIN_H,
                              "shade table config 2")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("shade table config 2 frames are not "
                               "bit-identical")
    valid = kept[0]["valid"]
    diff = (kept[0]["image"] - static).abs().amax(-1)
    share = float(((diff > 1e-3) & valid).sum()) / int(valid.sum())
    if share > 1e-3:
        raise RuntimeError(f"shade table config 2 image differs from the "
                           f"static one on {share:.2e} of valid pixels")
    mean_ms = float(np.mean(frame_ms))
    rebuilt = dict(
        launches=n, frame_ms=frame_ms, frame_ms_mean=mean_ms,
        build_ms=build_ms, build_ms_mean=float(np.mean(build_ms)),
        rebuild_host_syncs=len(syncs), valid_share=valid_share,
        vs_static_share=share, nw_pad=r._nw_pad, setup=dict(r.stats),
        spans=span_ms(r),
        closest_shadow_st=kernel_vs_plain(
            "closest_shadow_st", r, MAIN_W, MAIN_H,
            "phase 11 config 2 closest_shadow_st on the rebuilt tree",
            light_dir=hard.direction))
    out["config2"] = rebuilt
    log(f"phase 11 config 2: {json.dumps(rebuilt)}")
    out["kernels"] = kernels
    out["launches"] = launched
    return out


# ---------------------------------------------------------------------------
# Phase 12: the binary tree
# ---------------------------------------------------------------------------

# The binary walks' modes (csrc/binary.cu) and their TPU kernels.
BINARY_KERNELS = ("binary_closest", "binary_any")
# The 60-bit codes: two interleaves per coordinate, twice the 30-bit
# code's operations.
OPS_PER_CODE60 = 2 * OPS_PER_CODE


def binary_accel(mesh_dev, leaf: int, morton_bits: int = 30):
    """The on-device Morton build of ``mesh_dev`` and its packed rows."""
    from tpurt_torch.bvh.lbvh import build_lbvh
    from tpurt_torch.kernels.pack import pack_bvh
    bvh = build_lbvh(mesh_dev.vertices, mesh_dev.indices, leaf_size=leaf,
                     morton_bits=morton_bits)
    return bvh, pack_bvh(bvh)


def binary_gbuf(packed, mesh_dev, cam, w, h, table):
    """The binary frame's G-buffer: the closest hit, then the shade
    table's rows."""
    from tpurt_torch.app import gbuffer_production
    from tpurt_torch.types import RenderConfig
    cfg = RenderConfig(width=w, height=h, bvh_width=2, gbuffer="ray")
    return gbuffer_production(packed, mesh_dev, cam, cfg, None, table)[0]


def binary_shadow_inputs(packed, gbuf, light, step: int = 1):
    """BIN_ANY's inputs for the shadow rays the unfused pass makes from
    ``gbuf`` toward ``light``, on every ``step``-th row."""
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.passes.shadow import shadow_ray_batch
    so, sd, stm = shadow_ray_batch(gbuf, light, BIAS, None,
                                   (packed.root_min, packed.root_max))
    return tr.binary_any_inputs(packed, so[::step].contiguous(),
                                sd[::step].contiguous(),
                                stm[::step].contiguous())[:2]


def small_binary(dev) -> dict:
    """(a) BIN_CLOSEST and BIN_ANY against their plain versions at phase
    3's size (teapot 10k, 512x512) on the packed Morton tree at leaf 14
    and at leaf 8: camera rays, a per-ray t_max with inactive rays,
    directional and point shadow rays from the binary G-buffer, and flat
    (N, 3) rays with a t_min."""
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.passes.shading import make_shade_table
    from tpurt_torch.scenes import default_camera_for, teapot_scene
    from tpurt_torch.types import Light
    mesh = teapot_scene(SMALL_TRIS)
    mdev = mesh.on(dev)
    cam = default_camera_for(mesh)
    bmin, bmax = mesh.bounds()
    lpos = 0.5 * (bmin + bmax) + np.float32([2.0, 6.0, 1.0])
    sun = Light.directional((0.45, 0.8, 0.3))
    o, d = generate_rays(cam, SMALL_RES, SMALL_RES, dev)
    img = ("img", SMALL_RES, SMALL_RES)
    out = {}
    for leaf in (14, 8):
        bvh, pk = binary_accel(mdev, leaf)

        def run(name, args, kw, label, timed=False):
            what = f"512^2 leaf {leaf} {name} {label}"
            res, kres = check_pair(name, args, kw, what, pk.tri_id)
            if timed:
                res.update(time_pair(name, args, kw, 20, pk.tri_id))
            out[f"{name}/leaf{leaf}/{label}"] = res
            log(f"phase 12 {what}: {json.dumps(res)}")
            return kres
        args, kw = tr.binary_closest_inputs(pk, o, d)[:2]
        kres = run("binary_closest", args, kw, "camera rays", timed=True)
        t = tr._unpack(kres[0], img)
        scale = torch.full_like(t, 1.001)
        scale[::2] = 0.5
        t_max = torch.where(tr._unpack(kres[1], img) >= 0, t * scale, 1e3)
        t_max[:, ::5] = 0.0                                # inactive
        args, kw = tr.binary_closest_inputs(pk, o, d, t_max)[:2]
        sidx = tr._unpack(run("binary_closest", args, kw,
                              "per-ray t_max, inactive")[1], img)
        if bool((sidx[::2] >= 0).any()) or bool((sidx[:, ::5] >= 0).any()):
            raise RuntimeError("binary_closest: a capped or inactive ray "
                               "hit")
        gbuf = binary_gbuf(pk, mdev, cam, SMALL_RES, SMALL_RES,
                           make_shade_table(bvh, mdev))
        for kind, light in (("directional", sun),
                            ("point", Light.point(lpos))):
            args, kw = binary_shadow_inputs(pk, gbuf, light)
            run("binary_any", args, kw, kind, timed=kind == "directional")
        # Flat rays: from the hit points toward the sun as (N, 3), N not
        # a multiple of 1024, with a t_min.
        n = SMALL_RES * SMALL_RES - 1001
        origins = gbuf["position"].reshape(-1, 3)[:n].contiguous()
        dirs = torch.as_tensor(sun.direction, device=dev).expand(n, 3)
        tm = torch.where(gbuf["valid"].reshape(-1)[:n], 1e3, 0.0)
        for name, fn in (("binary_closest", tr.binary_closest_inputs),
                         ("binary_any", tr.binary_any_inputs)):
            args, kw = fn(pk, origins, dirs.contiguous(), tm,
                          t_min=1e-3)[:2]
            run(name, args, kw, "flat rays")
    return out


def image_against(img, valid, ref_img, ref_valid) -> dict:
    """Coverage and image against a reference frame (tests/test_raster.py's
    bounds: coverage off on < 0.2% of pixels, the image off by more than
    2e-2 on < 1%)."""
    coverage = float((valid != ref_valid).float().mean())
    diff = (img - ref_img).abs().amax(-1)
    share = float((diff > 2e-2).float().mean())
    return dict(coverage_share=coverage, image_share=share,
                ok=coverage < 0.002 and share < 0.01)


def phase_binary(dev, mesh, c1) -> dict:
    """The binary tree at 1080p in the hall ((b)-(e)) and the 60-bit codes
    ((f)); c1: phase 4's image, valid mask and Renderer."""
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.app import Renderer
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    w, h = MAIN_W, MAIN_H
    cam = sponza_interior_camera()
    light = Light.directional(SUN_DIR)
    out = {}

    # (b) The ray G-buffer: BIN_CLOSEST, the shade table, BIN_ANY.
    cfg = RenderConfig(width=w, height=h, bvh_width=2, leaf_size=14,
                       gbuffer="ray")
    r = Renderer(mesh, cam, light, cfg, device=dev)
    if r.route != "unfused" or r.shade_table is None:
        raise RuntimeError(f"binary frame: route {r.route}")
    setup = dict(num_internal=r.accel.num_internal, depth=r.depth,
                 stack_bound=r.depth + 1,
                 stack_capacity=tr.STACK_CAPACITY, **r.stats)
    log(f"phase 12 setup: {json.dumps(setup)}")
    (kept, frame_ms), n = drive({"binary_closest": 6, "binary_any": 6},
                                lambda: frames(r, 6))
    valid_share = check_image(kept[0], w, h, "binary")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("binary frames are not bit-identical")
    vs4 = image_against(kept[0]["image"], kept[0]["valid"], c1["image"],
                        c1["valid"])
    if not vs4["ok"]:
        raise RuntimeError(f"binary frame against phase 4's: {vs4}")
    mean_ms = float(np.mean(frame_ms))
    o, d = generate_rays(cam, w, h, dev)
    gbuf = binary_gbuf(r.accel, r.mesh, cam, w, h, r.shade_table)
    kernels = {
        "binary_closest": vs_plain(
            "binary_closest", tr.binary_closest_inputs(r.accel, o, d)[:2],
            tr.binary_closest_inputs(r.accel, o[::8].contiguous(),
                                     d[::8].contiguous())[:2],
            "phase 12 binary_closest", tri_id=r.accel.tri_id),
        "binary_any": vs_plain(
            "binary_any", binary_shadow_inputs(r.accel, gbuf, light),
            binary_shadow_inputs(r.accel, gbuf, light, 8),
            "phase 12 binary_any")}
    res = dict(launches=n, frame_ms=frame_ms, frame_ms_mean=mean_ms,
               valid_share=valid_share, vs_phase4=vs4, setup=setup,
               occluded_share=float((kept[0]["shadow"][0][kept[0]["valid"]]
                                     < 1.0).float().mean()),
               spans=span_ms(r))
    turns = in_turns(c1["renderer"], r)
    res["in_turns_ms"] = {"wide_fused": turns["a"], "binary": turns["b"]}
    out["ray_1080p"] = res
    log(f"phase 12 binary 1080p: {json.dumps(res)}")

    # (c) "auto": the rasterizer and BIN_ANY.
    ra = Renderer(mesh, cam, light, RenderConfig(
        width=w, height=h, bvh_width=2, leaf_size=14), device=dev)
    if ra.config.gbuffer != "raster" or ra.shade_table is not None:
        raise RuntimeError("binary auto did not take the rasterizer")
    (ka, ms_a), na = drive({"rasterize_rows": 3, "binary_any": 3},
                           lambda: frames(ra, 3))
    against = [image_against(f["image"], f["valid"], kept[0]["image"],
                             kept[0]["valid"]) for f in ka]
    if not all(a["ok"] for a in against):
        raise RuntimeError(f"binary raster frames against the ray frame: "
                           f"{against}")
    out["auto_raster"] = dict(launches=na, frame_ms=ms_a,
                              vs_binary_ray=against, setup=dict(ra.stats))
    log(f"phase 12 auto: {json.dumps(out['auto_raster'])}")

    # (d) Config 3's 2 deg sun at spp 8: the pass's loop over samples.
    sun = Light.sun(SUN_DIR, angular_radius_deg=2.0)
    cfg3 = RenderConfig(width=w, height=h, bvh_width=2, leaf_size=14,
                        spp=SPP, accumulate=True, gbuffer="ray")
    r3 = Renderer(mesh, cam, sun, cfg3, device=dev)
    (k3, ms3), n3 = drive({"binary_closest": 4, "binary_any": 4 * SPP},
                          lambda: frames(r3, 4))
    v3 = k3[0]["valid"]
    vis = k3[0]["shadow"][0][v3]
    pen = float(((vis > 0) & (vis < 1)).float().mean())
    if not pen > 0:
        raise RuntimeError("binary sun: no penumbra")
    if torch.equal(k3[0]["shadow"], k3[1]["shadow"]):
        raise RuntimeError("binary sun: successive frames drew the same "
                           "samples")
    again, _ = frames(Renderer(mesh, cam, sun, cfg3, device=dev), 4)
    for i, (a, b) in enumerate(zip(k3, again)):
        if not torch.equal(a["image"], b["image"]):
            raise RuntimeError(f"binary sun frame {i}: same seed, other "
                               f"image")
    out["sun_spp8"] = dict(launches=n3, frame_ms=ms3,
                           frame_ms_mean=float(np.mean(ms3)),
                           penumbra_share=pen,
                           occluded_share=float((vis < 1).float().mean()))
    log(f"phase 12 sun spp 8: {json.dumps(out['sun_spp8'])}")

    # (e) The rebuild, rebuild_splits=0: Morton tree, packed rows and the
    # rasterizer every frame.
    rb = Renderer(mesh, cam, light, RenderConfig(
        width=w, height=h, bvh_width=2, leaf_size=14, rebuild_splits=0),
        mode="rebuild", device=dev)
    if rb.config.gbuffer != "raster":
        raise RuntimeError("binary rebuild did not take the rasterizer")
    syncs = host_syncs(rb._rebuild)
    if syncs:
        raise RuntimeError(f"the binary rebuild waited for the card: "
                           f"{syncs}")
    (kb, ms_b, build_b), nb = drive(
        {"rasterize_rows": 6, "binary_any": 6, "morton_codes": 6,
         "topology": 6}, lambda: rebuild_frames(rb, 6))
    for f in kb[1:]:
        if not torch.equal(f["image"], kb[0]["image"]):
            raise RuntimeError("binary rebuild frames are not "
                               "bit-identical")
    diff = (kb[0]["image"] - ka[0]["image"]).abs().amax(-1)
    vb = kb[0]["valid"]
    share = float(((diff > 1e-3) & vb).sum()) / int(vb.sum())
    if share > 1e-3:
        raise RuntimeError(f"binary rebuild frame differs from the static "
                           f"one on {share:.2e}")
    out["rebuild"] = dict(launches=nb, frame_ms=ms_b,
                          frame_ms_mean=float(np.mean(ms_b)),
                          build_ms=build_b,
                          build_ms_mean=float(np.mean(build_b)),
                          rebuild_host_syncs=len(syncs),
                          vs_static_share=share, setup=dict(rb.stats))
    log(f"phase 12 rebuild: {json.dumps(out['rebuild'])}")

    out.update(phase_morton60(dev, mesh))
    out["kernels"] = kernels
    return out


def phase_morton60(dev, mesh) -> dict:
    """(f) The 60-bit codes: the kernel against its plain version on the
    hall's centroids, build_lbvh(morton_bits=60) with the kernels against
    the plain versions, then entry()'s route (teapot 2000, 256x256, leaf
    8, no tables) on a 30-bit and a 60-bit tree."""
    import tpurt_torch.kernels.build as B
    from tpurt_torch.app import render_frame_fn
    from tpurt_torch.bvh import lbvh as L
    from tpurt_torch.bvh.morton import unit_coords
    from tpurt_torch.kernels.pack import tree_depth
    from tpurt_torch.scenes import default_camera_for, teapot_scene
    from tpurt_torch.types import Light, RenderConfig
    mdev = mesh.on(dev)
    tpad = L._round_up(max(mesh.num_triangles, 28), 14)
    cen, smin, smax = L._triangle_data(mdev.vertices, mdev.indices,
                                       tpad)[4:]
    unit = unit_coords(cen, smin, smax).contiguous()
    kp = build_pair("morton_codes60", (unit,), "phase 12 morton_codes60")
    kp.update(time_build("morton_codes60", (unit,)))
    n = unit.shape[0]
    kp.update(build_bound(20 * n, OPS_PER_CODE60 * n))
    codes30 = B.morton_codes(cen, smin, smax)
    kp["dup_share_30"] = 1.0 - float(torch.unique(codes30).numel()) / n
    hi, lo = B.morton_codes60(cen, smin, smax)
    kp["dup_share_60"] = 1.0 - float(torch.unique(
        (hi.long() << 30) | lo.long()).numel()) / n
    log(f"phase 12 morton_codes60: {json.dumps(kp)}")

    def build60():
        return L.build_lbvh(mdev.vertices, mdev.indices, leaf_size=14,
                            morton_bits=60)
    kb, nb = drive({"morton_codes60": 1, "topology": 1}, build60)
    with plain_build_kernels():
        pb = build60()
    for name in ("nodes_box", "nodes_child", "nodes_first", "nodes_last",
                 "tri_v0", "tri_e1", "tri_e2", "tri_sorted", "tri_id",
                 "root_min", "root_max"):
        if not torch.equal(getattr(kb, name), getattr(pb, name)):
            raise RuntimeError(f"60-bit build: {name} differs from the "
                               f"plain build")
    depths = {"depth_60": tree_depth(kb.nodes_child),
              "depth_30": tree_depth(binary_accel(mdev, 14)[0].nodes_child)}
    log(f"phase 12 60-bit build: launches {nb}, {json.dumps(depths)}")

    tmesh = teapot_scene(2000)
    tdev = tmesh.on(dev)
    cam = default_camera_for(tmesh)
    cfg = RenderConfig(width=256, height=256, leaf_size=8)
    light = Light.directional((0.45, 0.8, 0.3))
    entry = {}
    for bits in (30, 60):
        bvh = binary_accel(tdev, 8, bits)[0]
        res, ne = drive({"binary_closest": 1, "binary_any": 1},
                        lambda: render_frame_fn(bvh, tdev, cam, [light],
                                                cfg))
        check_image(res, 256, 256, f"entry route, {bits}-bit")
        if res["walk_counts"].tolist() != [0, 0]:
            raise RuntimeError(f"entry route {bits}-bit: walk counters")
        entry[bits] = res
    e = image_against(entry[60]["image"], entry[60]["valid"],
                      entry[30]["image"], entry[30]["valid"])
    if not e["ok"]:
        raise RuntimeError(f"entry route: 60-bit against 30-bit {e}")
    res = {"morton_codes60": kp, "build60_launches": nb, **depths,
           "entry_route": dict(launches=ne, vs_30bit=e,
                               valid_share=float(entry[60]["valid"].float()
                                                 .mean()))}
    log(f"phase 12 entry route: {json.dumps(res['entry_route'])}")
    return res


# ---------------------------------------------------------------------------
# Phase 13: textured scenes (attrs=2)
# ---------------------------------------------------------------------------

# The hall's materials, as Crytek Sponza's: 25, of which 20 carry a diffuse
# map (procedural content, 1024^2 PNG) and 5 a flat Kd. uv is a box
# projection of world position in scene units (the triangle's dominant
# normal axis dropped), so it runs far outside [0, 1) and REPEAT wraps.
HALL_MATERIALS = 25
HALL_MAPS = 20
MAP_RES = 1024
UV_PER_UNIT = 0.5


def write_textured_hall(mesh, root: str) -> dict:
    """The hall as an OBJ (v, vt per triangle corner, vn; faces grouped by
    material) with its MTL and diffuse maps under ``root``. Harness code:
    the scene a user would load, written here because the repo carries
    no assets."""
    import os
    from tpurt_torch.io.image import write_png
    v = np.asarray(mesh.vertices, np.float32)
    nrm = np.asarray(mesh.normals, np.float32)
    idx = np.asarray(mesh.indices, np.int64)
    p = v[idx]                                              # [T, 3, 3]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    keep = np.array([[1, 2], [0, 2], [0, 1]])[np.abs(fn).argmax(1)]
    uv = np.take_along_axis(p, keep[:, None, :].repeat(3, 1), axis=2)
    uv = (uv * UV_PER_UNIT).astype(np.float32)              # [T, 3, 2]
    cell = np.floor(p.mean(1) / 3.0).astype(np.int64)
    mat = (cell[:, 0] * 73856093 ^ cell[:, 1] * 19349663
           ^ cell[:, 2] * 83492791) % HALL_MATERIALS
    t0 = time.perf_counter()
    yy, xx = np.mgrid[0:MAP_RES, 0:MAP_RES].astype(np.float32) / MAP_RES
    with open(os.path.join(root, "hall.mtl"), "w") as f:
        for m in range(HALL_MATERIALS):
            f.write(f"newmtl m{m:02d}\nKd 0.7 0.7 0.7\n")
            if m < HALL_MAPS:
                f.write(f"map_Kd m{m:02d}.png\n")
                k = 2.0 + m
                img = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * k * xx),
                                0.5 + 0.5 * np.sin(2 * np.pi * (k + 1) * yy),
                                0.5 + 0.5 * np.cos(2 * np.pi * k * (xx + yy))
                                ], -1)
                write_png(os.path.join(root, f"m{m:02d}.png"),
                          (img * 255 + 0.5).astype(np.uint8))
    maps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    order = np.argsort(mat, kind="stable")
    t = idx.shape[0]
    with open(os.path.join(root, "hall.obj"), "w") as f:
        f.write("mtllib hall.mtl\n")
        np.savetxt(f, v, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, nrm, fmt="vn %.9g %.9g %.9g")
        np.savetxt(f, uv.reshape(-1, 2), fmt="vt %.9g %.9g")
        corner = np.arange(3 * t).reshape(t, 3) + 1
        faces = np.stack([idx + 1, corner, idx + 1], axis=2).reshape(t, 9)
        for m in range(HALL_MATERIALS):
            sel = order[mat[order] == m]
            f.write(f"usemtl m{m:02d}\n")
            np.savetxt(f, faces[sel], fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
    return dict(path=os.path.join(root, "hall.obj"), maps_s=maps_s,
                obj_s=time.perf_counter() - t0,
                obj_mb=os.path.getsize(os.path.join(root, "hall.obj")) / 2**20)


def raster_texture_against(r, fused) -> dict:
    """The textured raster frame against the fused ray-cast one. The raster
    G-buffer reconstructs its positions from 1/w, which moves them off the
    ray's hit along the view ray (untextured, the raster bounds hold), and a
    texture turns a position error into an albedo error as large as the
    texels' contrast. So the raster bounds (coverage off on < 0.2% of
    pixels, the image off by more than 2e-2 on < 1%) are held where both
    frames look up the same texels: the same triangle and uv within half
    a texel of the atlas. The share of pixels where the lookups differ,
    the image share over every pixel and the depth error are reported."""
    from tpurt_torch.io.obj import ATLAS_RES
    from tpurt_torch.passes.texture import interpolate_uv
    ras = r.render_frame()
    ray = fused["renderer"].render_frame()
    both = ras["valid"] & ray["valid"]
    same_tri = both & (ras["tri_id"] == ray["tri_id"])
    uv = interpolate_uv(r.mesh, ras["tri_id"], ras["position"])
    same_texels = same_tri & ((uv - ray["uv"]).abs().amax(-1)
                              < 0.5 / ATLAS_RES)
    off = (ras["image"] - ray["image"]).abs().amax(-1) > 2e-2
    depth_rel = ((ras["depth"] - ray["depth"]).abs()
                 / ray["depth"].abs())[same_tri].double()
    npix = off.numel()
    res = dict(coverage_share=float((ras["valid"] != ray["valid"]).float()
                                    .mean()),
               tri_id_equal=float(same_tri.sum()) / int(both.sum()),
               other_texels_share=float((both & ~same_texels).sum()) / npix,
               image_share_same_texels=float((off & same_texels).sum())
               / npix,
               image_share_all=float(off.float().mean()),
               depth_rel_err_p50_p99_max=[
                   float(torch.quantile(depth_rel[:1_000_000], q))
                   for q in (0.5, 0.99)] + [float(depth_rel.max())])
    pos_rel = ((ras["position"] - ray["position"]).norm(dim=-1)
               / ray["t"])[same_tri].double()
    res["position_rel_err_p50_p99_max"] = [
        float(torch.quantile(pos_rel[:1_000_000], q))
        for q in (0.5, 0.99)] + [float(pos_rel.max())]
    res["ok"] = (res["coverage_share"] < 0.002
                 and res["tri_id_equal"] >= 0.999
                 and res["image_share_same_texels"] < 0.01)
    return res


def phase_textured(dev, mesh, c1) -> dict:
    """The textured hall at 1080p: written as OBJ/MTL/PNG, loaded through
    the port's loader, then every route that reads a texture; c1: phase
    4's image, valid mask and Renderer (the untextured twin)."""
    import tempfile
    from tpurt_torch.app import Renderer, frame_seed
    from tpurt_torch.io.obj import load_obj
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    hard = Light.directional(SUN_DIR)
    sun = Light.sun(SUN_DIR, angular_radius_deg=2.0)
    fills = config5_lights()[1:]
    lamp = Light.point(LAMP_POS, radius=LAMP_RADIUS)
    seed = frame_seed(0, 0)
    cone = float(np.cos(sun.angular_radius))
    with tempfile.TemporaryDirectory() as root:
        files = write_textured_hall(mesh, root)
        t0 = time.perf_counter()
        tmesh = load_obj(files["path"], use_native=True)
        files["load_s"] = time.perf_counter() - t0
    layers = set(np.unique(np.asarray(tmesh.tri_tex)).tolist())
    if not (tmesh.textured and tmesh.num_triangles == mesh.num_triangles
            and tmesh.tex_atlas.shape[0] == HALL_MAPS
            and layers == set(range(-1, HALL_MAPS))):
        raise RuntimeError(f"textured hall loaded as {tmesh.num_triangles} "
                           f"triangles, layers {sorted(layers)}")
    files.update(vertices=tmesh.num_vertices, triangles=tmesh.num_triangles,
                 atlas=list(tmesh.tex_atlas.shape))
    log(f"phase 13 textured hall: {json.dumps(files)}")

    # label: (lights, config fields, route, the attrs=2 kernel and its
    # spec, launches per frame by kernel, frames)
    cases = {
        "fused": ([hard], {}, "fused0", "closest_shadow_tex",
                  dict(light_dir=hard.direction),
                  {"closest_shadow_tex": 1}, 6),
        "unfused": ([hard], dict(fused_shadow=False), "unfused",
                    "closest_attrs_tex", None,
                    {"closest_attrs_tex": 1, "any": 1}, 2),
        "three_lights": (config5_lights(), {}, "fusedN",
                         "closest_multi_shadow_tex",
                         dict(lights=[(l.direction, None)
                                      for l in config5_lights()]),
                         {"closest_multi_shadow_tex": 1}, 2),
        "sun": ([sun], dict(spp=SPP), "fused0", "closest_soft_shadow_tex",
                dict(axis_dir=sun.direction, cone_cos=cone, spp=SPP,
                     seed=seed), {"closest_soft_shadow_tex": 1}, 2),
        "lamp": ([lamp], dict(spp=SPP), "fused0",
                 "closest_point_soft_shadow_tex",
                 dict(light_pos=lamp.position, radius=LAMP_RADIUS, spp=SPP,
                      seed=seed), {"closest_point_soft_shadow_tex": 1}, 2),
        "sun_fills": ([sun] + fills, dict(spp=SPP), "fusedSM",
                      "closest_soft_multi_shadow_tex",
                      dict(light0=("cone", sun.direction, cone),
                           extra_dirs=[l.direction for l in fills], spp=SPP,
                           seed=seed), {"closest_soft_multi_shadow_tex": 1},
                      2),
    }
    out, kernels, launched = {"scene": files}, {}, {}
    fused = None
    for label, (lights, fields, route, name, spec, per_frame, nf) in \
            cases.items():
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14,
                           **fields)
        r = Renderer(tmesh, cam, lights, cfg, device=dev)
        if r.route != route or r.attr_tables is None:
            raise RuntimeError(f"textured {label}: route {r.route}")
        (kept, frame_ms), n = drive({k: nf * v for k, v in per_frame.items()},
                                    lambda: frames(r, nf))
        for f in kept:
            check_image(f, MAIN_W, MAIN_H, f"textured {label}")
        valid = kept[0]["valid"]
        res = dict(route=route, launches=n, frame_ms=frame_ms,
                   frame_ms_mean=float(np.mean(frame_ms)),
                   setup=dict(r.stats),
                   occluded_shares=[float((s[valid] < 1).float().mean())
                                    for s in kept[0]["shadow"]])
        if label == "fused":
            for f in kept[1:]:
                if not torch.equal(f["image"], kept[0]["image"]):
                    raise RuntimeError("textured frames are not "
                                       "bit-identical")
            fused = dict(image=kept[0]["image"], valid=valid, renderer=r)
            res["vs_untextured"] = image_against(
                kept[0]["image"], valid, c1["image"], c1["valid"])
            if res["vs_untextured"]["coverage_share"] >= 0.002:
                raise RuntimeError("textured frame: coverage differs from "
                                   "the untextured one")
            turns = in_turns(c1["renderer"], r)
            res["in_turns_ms"] = {"untextured": turns["a"],
                                  "textured": turns["b"]}
            res["spans"] = span_ms(r)
        if spec is None:
            kernels[name] = vs_plain(name, unfused_inputs(name, r, 0, 1),
                                     unfused_inputs(name, r, 0, 8),
                                     f"phase 13 {label} {name}")
        else:
            kernels[name] = kernel_vs_plain(name, r, MAIN_W, MAIN_H,
                                            f"phase 13 {label} {name}",
                                            **spec)
        # The attrs=1 twin on the same inputs: what the texture lanes cost.
        args, kw = unfused_inputs(name, r, 0, 1) if spec is None else \
            frame_inputs(name, r, MAIN_W, MAIN_H, **spec)[0]
        twin = kernel(variant_stem(name))[0]
        before = twin.launches
        kernels[name]["attrs1_twin_ms"] = cuda_ms(
            lambda: twin(*args, **kw), 10)
        twin.launches = before
        launched[name] = n[name]
        res["kernel"] = kernels[name]
        out[label] = res
        log(f"phase 13 textured {label}: {json.dumps(res)}")

    # The other G-buffers of the textured hall, each against the fused
    # textured frame within the raster bounds.
    others = {
        "shade_table": (dict(inkernel_attrs=False), "static",
                        {"closest_shadow_st": 1}),
        "raster": (dict(gbuffer="raster"), "static",
                   {"rasterize_rows": 1, "any": 1}),
        "binary": (dict(bvh_width=2, gbuffer="ray"), "static",
                   {"binary_closest": 1, "binary_any": 1}),
    }
    for label, (fields, mode, per_frame) in others.items():
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14,
                           **fields)
        r = Renderer(tmesh, cam, hard, cfg, mode=mode, device=dev)
        (kept, frame_ms), n = drive({k: 3 * v for k, v in per_frame.items()},
                                    lambda: frames(r, 3))
        for f in kept:
            check_image(f, MAIN_W, MAIN_H, f"textured {label}")
        against = image_against(kept[0]["image"], kept[0]["valid"],
                                fused["image"], fused["valid"])
        if label == "raster":
            against = raster_texture_against(r, fused)
        if not against["ok"]:
            raise RuntimeError(f"textured {label} frame against the fused "
                               f"one: {against}")
        out[label] = dict(route=r.route, launches=n, frame_ms=frame_ms,
                          frame_ms_mean=float(np.mean(frame_ms)),
                          vs_fused=against, setup=dict(r.stats))
        log(f"phase 13 textured {label}: {json.dumps(out[label])}")

    # Config 2 on the textured hall: the payload carries the layer and uv.
    r = Renderer(tmesh, cam, hard, RenderConfig(width=MAIN_W, height=MAIN_H,
                                                leaf_size=14),
                 mode="rebuild", device=dev)
    syncs = host_syncs(r._rebuild)
    if syncs:
        raise RuntimeError(f"textured rebuild host syncs: {syncs}")
    _, kw, kat, _ = r._rebuild()
    with plain_build_kernels():
        _, pw, pat, _ = r._rebuild()
    if not (torch.equal(kw.nodes, pw.nodes) and torch.equal(kat[0], pat[0])
            and torch.equal(kat[1], pat[1])):
        raise RuntimeError("textured rebuild: kernels differ from the plain "
                           "versions")
    (kept, frame_ms, build_ms), n = drive(
        {"closest_shadow_tex": 6, "morton_codes": 6, "topology": 6,
         "collapse_area": 6}, lambda: rebuild_frames(r, 6))
    check_image(kept[0], MAIN_W, MAIN_H, "textured rebuild")
    valid = kept[0]["valid"]
    diff = (kept[0]["image"] - fused["image"]).abs().amax(-1)
    share = float(((diff > 1e-3) & valid).sum()) / int(valid.sum())
    if share > 1e-3:
        raise RuntimeError(f"textured rebuild image differs from the static "
                           f"one on {share:.2e} of valid pixels")
    out["rebuild"] = dict(launches=n, frame_ms=frame_ms,
                          frame_ms_mean=float(np.mean(frame_ms)),
                          build_ms=build_ms,
                          build_ms_mean=float(np.mean(build_ms)),
                          host_syncs=len(syncs), vs_static_share=share,
                          nw_pad=r._nw_pad)
    log(f"phase 13 textured rebuild: {json.dumps(out['rebuild'])}")
    out["kernels"], out["launches"] = kernels, launched
    out["textured"] = dict(mesh=tmesh, fused=fused)
    return out


# ---------------------------------------------------------------------------
# Phase 14: the rebuild's fixed cut
# ---------------------------------------------------------------------------

def clustered_deltas(r):
    """The adjacent deltas of the rebuild's clustered leaf codes, as
    _rebuild_fused computes them on the Renderer's geometry."""
    return clustered_split(r)[0]


def phase_fixed_cut(dev, mesh, area) -> dict:
    """Config 2 with rebuild_collapse="fixed" at 1080p; area: phase 9's
    image and valid mask (the area collapse's rebuild)."""
    import tpurt_torch.kernels.build as B
    from tpurt_torch.app import FIXED_CUT_DEPTH_BOUND, Renderer
    from tpurt_torch.bvh.lbvh import adjacent_deltas
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    light = Light.directional(SUN_DIR)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14,
                       rebuild_collapse="fixed")
    t0 = time.perf_counter()
    r = Renderer(mesh, cam, light, cfg, mode="rebuild", device=dev)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    if r.depth > FIXED_CUT_DEPTH_BOUND:
        raise RuntimeError(f"fixed cut: wide depth {r.depth} past the bound")
    d = clustered_deltas(r)
    rng = np.random.default_rng(2)
    synth = torch.from_numpy(np.sort(rng.choice(
        rng.integers(0, 1 << 30, 64), 30_000)).astype(np.int32)).to(dev)
    checks = [build_pair("topology_depth", (d,), "depth, config 2"),
              build_pair("topology_depth", (adjacent_deltas(synth)
                                            .contiguous(),),
                         "depth, 30k leaves of 64 codes")]
    depth = B.topology_depth_reference(d)[3]
    ni = int(d.shape[0])
    levels = max(1, ni.bit_length())
    steps = int(depth.sum())
    kp = dict(gaps=ni, max_depth=int(depth.max()), depth_steps=steps,
              **build_bound(ni * 4 + ni * 8 + ni * 8 + ni * 4,
                            (levels - 1) * ni + 2 * levels * ni
                            + OPS_PER_TOPOLOGY_PLACE * (ni + 1)
                            + OPS_PER_DEPTH_STEP * steps))
    kp.update(time_build("topology_depth", (d,)))
    kp["topology_alone_ms"] = time_build("topology", (d,))["ms"]
    kp["depth_kernel_ms"] = kp["ms"] - kp["topology_alone_ms"]
    kp.update(checks=checks, max_abs_err=0.0, mismatch_share=0.0)
    log(f"phase 14 topology_depth: {json.dumps(kp)}")

    syncs = host_syncs(r._rebuild)
    if syncs:
        raise RuntimeError(f"fixed rebuild host syncs: {syncs}")
    _, kw, kat, kcnt = r._rebuild()
    with plain_build_kernels():
        _, pw, pat, pcnt = r._rebuild()
    for what, a, b in (("nodes", kw.nodes, pw.nodes), ("at0", kat[0], pat[0]),
                       ("at1", kat[1], pat[1]), ("count", kcnt, pcnt)):
        if not torch.equal(a, b):
            raise RuntimeError(f"fixed rebuild: {what} differs between the "
                               f"kernels and the plain versions")
    (kept, frame_ms, build_ms), n = drive(
        {"closest_shadow": 6, "morton_codes": 6, "topology_depth": 6,
         **resolve_launches(r, 6)}, lambda: rebuild_frames(r, 6))
    check_image(kept[0], MAIN_W, MAIN_H, "fixed cut")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("fixed-cut frames are not bit-identical")
    valid = kept[0]["valid"]
    diff = (kept[0]["image"] - area["image"]).abs().amax(-1)
    share = float(((diff > 1e-3) & valid).sum()) / int(valid.sum())
    if share > 1e-3:
        raise RuntimeError(f"fixed-cut image differs from the area "
                           f"rebuild's on {share:.2e} of valid pixels")
    # The fused kernel on the fixed cut's tree (more wide nodes than the
    # area collapse's, each less full).
    hard = kernel_vs_plain("closest_shadow", r, MAIN_W, MAIN_H,
                           "phase 14 closest_shadow on the fixed-cut tree",
                           light_dir=light.direction)
    res = dict(launches=n, frame_ms=frame_ms,
               frame_ms_mean=float(np.mean(frame_ms)), build_ms=build_ms,
               build_ms_mean=float(np.mean(build_ms)), host_syncs=len(syncs),
               closest_shadow={k: hard[k] for k in (
                   "ms", "plain_ms", "bound_ms", "pops", "closest_tris",
                   "anyhit_tris", "max_abs_err", "mismatch_share")},
               vs_area_share=share, nw_pad=r._nw_pad, wide_count=int(kcnt),
               wide_depth=r.depth, depth_bound=FIXED_CUT_DEPTH_BOUND,
               setup_ms=setup_ms, setup=dict(r.stats),
               kernel={k: v for k, v in kp.items() if k != "checks"})
    log(f"phase 14 fixed cut: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# Phase 15: the seeded G-buffer
# ---------------------------------------------------------------------------

def same_hits(a, b, what: str) -> dict:
    """Two closest hits (t, tri_id, sidx) of the same rays: the hit set
    and t equal on every ray, tri_id on >= 99.9% of hits. A different
    sidx naming the same triangle is another SBVH reference of it (a
    clipped leaf box can lie beyond the hit, and the seeded walk's tighter
    cap culls it); a different triangle at the same t is a tie the walks
    broke in another order (decision 2)."""
    hit = a[2] >= 0
    if not (torch.equal(hit, b[2] >= 0) and torch.equal(a[0], b[0])):
        raise RuntimeError(f"{what}: t or the hit set differ")
    nhit = int(hit.sum())
    other_tri = int((a[1] != b[1]).sum())
    if other_tri > 1e-3 * nhit:
        raise RuntimeError(f"{what}: tri_id differs on {other_tri} of "
                           f"{nhit} hits")
    return dict(hits=nhit, other_triangle=other_tri,
                other_reference=int((a[2] != b[2]).sum()) - other_tri)


def phase_seeded(dev, mesh) -> dict:
    """seeded_gbuffer=True at 1080p: FIRST_HIT against its plain version,
    the seeded closest hit against NEAREST on every ray, the seed's
    invariants, and the unfused seeded frame in turns with its unseeded
    shade-table twin."""
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.app import Renderer, _gb_accel
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    hard = Light.directional(SUN_DIR)
    fields = dict(width=MAIN_W, height=MAIN_H, leaf_size=14,
                  fused_shadow=False)
    r = Renderer(mesh, cam, hard, RenderConfig(seeded_gbuffer=True, **fields),
                 device=dev)
    if (r.route != "unfused" or r.attr_tables is not None
            or r.shade_table is None):
        raise RuntimeError(f"seeded frame: route {r.route}, tables "
                           f"{r.attr_tables is not None}")
    (kept, frame_ms), n = drive({"first_hit": 6, "closest": 6, "any": 6},
                                lambda: frames(r, 6))
    check_image(kept[0], MAIN_W, MAIN_H, "seeded")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("seeded frames are not bit-identical")
    twin = Renderer(mesh, cam, hard, RenderConfig(inkernel_attrs=False,
                                                  **fields), device=dev)
    a, b = twin.render_frame(), r.render_frame()
    same = a["tri_id"] == b["tri_id"]
    if not (torch.equal(a["image"][same], b["image"][same])
            and float(same.float().mean()) >= 0.999):
        raise RuntimeError("the seeded frame differs from the unseeded "
                           "shade-table frame")
    frame_vs_twin = dict(other_triangle_pixels=int((~same).sum()),
                         image_equal=torch.equal(a["image"], b["image"]))
    turns = in_turns(twin, r)

    # The kernels on the frame's rays.
    acc = _gb_accel(r.accel, cam, r.config)
    o, d = generate_rays(cam, MAIN_W, MAIN_H, r.device)
    args, kw = inputs("first_hit", acc, None, o, d)
    sub = inputs("first_hit", acc, None, o[::8].contiguous(),
                 d[::8].contiguous())
    kp = vs_plain("first_hit", (args, kw), sub, "phase 15 first_hit",
                  tri_id=acc.tri_id)
    t1, s1, c1 = tr.first_hit_cuda(*args, **kw)
    pt1, ps1, _ = tr.first_hit_reference(*args, **kw)
    tr.first_hit_cuda.launches -= 1
    if not (torch.equal(t1, pt1) and torch.equal(s1, ps1)):
        raise RuntimeError("first_hit: t1 or s1 differ from the plain "
                           "version")
    t, s, c = tr.closest_cuda(*args, **kw)
    tr.closest_cuda.launches -= 1
    tr.check_walk_counts(c1 + c)
    hit = s >= 0
    if not (torch.equal(s1 >= 0, hit) and bool((t1[hit] >= t[hit]).all())):
        raise RuntimeError("the seed is not an upper bound on every ray")
    seeded = tr.trace_closest(acc, o, d, return_sorted=True, seeded=True)
    plain = tr.trace_closest(acc, o, d, return_sorted=True)
    tr.first_hit_cuda.launches -= 1
    tr.closest_cuda.launches -= 2
    vs_nearest = same_hits(plain, seeded, "the seeded closest hit")
    capped = args[0].clone()
    capped[:, 9] = tr.seed_cap(args[0], t1, s1)
    before = tr.closest_cuda.launches
    nearest_ms = cuda_ms(lambda: tr.closest_cuda(*args, **kw), 10)
    second_ms = cuda_ms(lambda: tr.closest_cuda(capped, *args[1:], **kw), 10)
    tr.closest_cuda.launches = before
    kp.update(nearest_ms=nearest_ms, nearest_seeded_ms=second_ms,
              two_walks_ms=kp["ms"] + second_ms,
              seed_tighter_share=float((t1[hit] > t[hit]).float().mean()))
    res = dict(launches=n, frame_ms=frame_ms,
               frame_ms_mean=float(np.mean(frame_ms)),
               in_turns_ms={"unseeded": turns["a"], "seeded": turns["b"]},
               vs_nearest=vs_nearest, frame_vs_twin=frame_vs_twin,
               kernel=kp, setup=dict(r.stats))
    log(f"phase 15 seeded: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# Phase 16: top_sah, the sweep-SAH priorities
# ---------------------------------------------------------------------------

# The sweep's operations per block of a split range and pass: the box
# union (6) and the SA (3 sub, 3 max, 1 mul, 2 fma), and in the forward
# pass the cost (1 mul, 1 fma) and its compare; 18 on average.
OPS_PER_SWEEP_STEP = 18


def plain_leaf_boxes(r):
    """The plain (unclustered) rebuild's adjacent deltas and leaf boxes on
    the Renderer's geometry, as build_lbvh computes them."""
    from tpurt_torch.bvh import lbvh as L
    from tpurt_torch.kernels.build import morton_codes
    m, k = r.mesh, r.config.leaf_size
    tpad = r.bvh.num_sorted_tris
    _, v0, e1, e2, cen, smin, smax = L._triangle_data(m.vertices, m.indices,
                                                      tpad)
    chs, (sv0, se1, se2) = L._sort_payload(morton_codes(cen, smin, smax),
                                           [v0, e1, e2])
    lmin, lmax, _, _ = L._leaf_boxes(sv0, se1, se2, k)
    return L.adjacent_deltas(chs[::k]).contiguous(), lmin, lmax


def phase_top_sah(dev, mesh) -> dict:
    """mode="rebuild", top_sah=True, rebuild_splits=0 at 1080p on the ray
    G-buffer: the sweep kernel and the topology on its priorities against
    their plain versions, no host sync in a rebuild, the area collapse's
    and the fixed cut's frames against the unsteered plain rebuild's, and
    HARD on the steered tree beside HARD on the unsteered one."""
    import tpurt_torch.kernels.build as B
    from tpurt_torch.app import FIXED_CUT_DEPTH_BOUND, Renderer, \
        fixed_cut_depth_bound
    from tpurt_torch.bvh.lbvh import delta_range
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    hard = Light.directional(SUN_DIR)
    fields = dict(width=MAIN_W, height=MAIN_H, leaf_size=14, rebuild_splits=0,
                  gbuffer="ray")

    def renderer(**extra):
        return Renderer(mesh, cam, hard, RenderConfig(**fields, **extra),
                        mode="rebuild", device=dev)
    r = renderer(top_sah=True)
    d, lmin, lmax = plain_leaf_boxes(r)
    ni = int(d.shape[0])
    bx = B.block_boxes(lmin, lmax, B.SWEEP_BLOCK)
    nb = bx.shape[0] // 6
    sweep_args = (bx, ni, B.SWEEP_BLOCK, B.SWEEP_MAXD, B.SWEEP_MIN_BLOCKS)
    checks = [build_pair("sweep_sah_priorities", sweep_args,
                         "sweep, the plain rebuild's leaves")]
    dprime = B.sweep_sah_priorities(d, lmin, lmax)
    with plain_build_kernels():
        pprime = B.sweep_sah_priorities(d, lmin, lmax)
    if not torch.equal(dprime, pprime):
        raise RuntimeError("sweep: D' differs from the plain version's")
    d_max = delta_range(True)
    checks.append(build_pair("topology", (dprime, d_max), "topology on D'"))
    stats = {}
    gaps, _ = B.sweep_sah_priorities_reference(*sweep_args, stats=stats)
    maxn = int(gaps.shape[0])
    kp = dict(blocks=nb, maxn=maxn, splits=int((gaps < ni).sum()),
              max_priority=int(dprime.max()), **stats,
              **build_bound(nb * 24 + maxn * 8,
                            OPS_PER_SWEEP_STEP * stats["sweep_steps"]))
    kp.update(time_build("sweep_sah_priorities", sweep_args))
    kp.update(checks=checks, max_abs_err=0.0, mismatch_share=0.0)
    log(f"phase 16 sweep: {json.dumps(kp)}")

    out = {"kernel": {k: v for k, v in kp.items() if k != "checks"}}
    plain = renderer()
    (pk, _, _), _ = drive({"closest_shadow": 2, "morton_codes": 2,
                           "topology": 2, "collapse_area": 2,
                           **resolve_launches(plain, 2)},
                          lambda: rebuild_frames(plain, 2))
    hard_plain = kernel_vs_plain("closest_shadow", plain, MAIN_W, MAIN_H,
                                 "phase 16 closest_shadow, unsteered",
                                 light_dir=hard.direction)
    for label, extra, per_frame in (
            ("area", {}, {"collapse_area": 1, "topology": 1}),
            ("fixed", dict(rebuild_collapse="fixed"),
             {"topology_depth": 1})):
        if label == "fixed":
            r = renderer(top_sah=True, **extra)
        syncs = host_syncs(r._rebuild)
        if syncs:
            raise RuntimeError(f"steered {label} rebuild host syncs: "
                               f"{syncs}")
        _, kw, kat, kcnt = r._rebuild()
        with plain_build_kernels():
            _, pw, pat, pcnt = r._rebuild()
        for what, a, b in (("nodes", kw.nodes, pw.nodes),
                           ("at0", kat[0], pat[0]), ("count", kcnt, pcnt)):
            if not torch.equal(a, b):
                raise RuntimeError(f"steered {label} rebuild: {what} "
                                   f"differs between the kernels and the "
                                   f"plain versions")
        expect = {"closest_shadow": 6, "morton_codes": 6,
                  "sweep_sah_priorities": 6}
        expect.update({k: 6 * v for k, v in per_frame.items()})
        expect.update(resolve_launches(r, 6))
        (kept, frame_ms, build_ms), n = drive(
            expect, lambda: rebuild_frames(r, 6))
        check_image(kept[0], MAIN_W, MAIN_H, f"steered {label}")
        for f in kept[1:]:
            if not torch.equal(f["image"], kept[0]["image"]):
                raise RuntimeError(f"steered {label} frames are not "
                                   f"bit-identical")
        valid = kept[0]["valid"]
        diff = (kept[0]["image"] - pk[0]["image"]).abs().amax(-1)
        share = float(((diff > 1e-3) & valid).sum()) / int(valid.sum())
        if share > 1e-3:
            raise RuntimeError(f"steered {label} image differs from the "
                               f"unsteered rebuild's on {share:.2e}")
        hk = kernel_vs_plain("closest_shadow", r, MAIN_W, MAIN_H,
                             f"phase 16 closest_shadow, steered {label}",
                             light_dir=hard.direction)
        out[label] = dict(
            launches=n, frame_ms=frame_ms,
            frame_ms_mean=float(np.mean(frame_ms)), build_ms=build_ms,
            build_ms_mean=float(np.mean(build_ms)), host_syncs=len(syncs),
            vs_unsteered_share=share, nw_pad=r._nw_pad,
            wide_count=int(kcnt), wide_depth=r.depth, setup=dict(r.stats),
            closest_shadow={k: hk[k] for k in (
                "ms", "plain_ms", "bound_ms", "pops", "closest_tris",
                "anyhit_tris", "max_abs_err", "mismatch_share")})
        log(f"phase 16 steered {label}: {json.dumps(out[label])}")
    out["fixed"]["depth_bound"] = fixed_cut_depth_bound(d_max)
    out["fixed"]["unsteered_depth_bound"] = FIXED_CUT_DEPTH_BOUND
    out["unsteered"] = dict(wide_depth=plain.depth, nw_pad=plain._nw_pad,
                            closest_shadow={k: hard_plain[k] for k in (
                                "ms", "plain_ms", "bound_ms", "pops",
                                "closest_tris", "anyhit_tris")})
    log(f"phase 16 unsteered: {json.dumps(out['unsteered'])}")
    out["launches"] = out["area"]["launches"]["sweep_sah_priorities"]
    return out


# ---------------------------------------------------------------------------
# Phase 17: the deferred raster G-buffer
# ---------------------------------------------------------------------------

# The z-only rasterizer's state writes where a record takes the pixel:
# 1/w, d1, d2, d-sum, id.
OPS_PER_TAKE16 = 5


def phase_deferred(dev, mesh, c1, ras32, textured) -> dict:
    """raster_deferred=True at 1080p; c1: phase 4's image and valid mask;
    ras32: phase 10's 32-float raster Renderer; textured: phase 13's
    textured hall and fused frame."""
    import tpurt_torch.kernels.raster as R
    from tpurt_torch.app import Renderer
    from tpurt_torch.raster.setup import bin_rows, default_cap_rows
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    w, h = MAIN_W, MAIN_H
    cam = sponza_interior_camera()
    hard = Light.directional(SUN_DIR)
    cfg = RenderConfig(width=w, height=h, leaf_size=14, gbuffer="raster",
                       raster_deferred=True)
    r = Renderer(mesh, cam, hard, cfg, device=dev)
    if r.route != "unfused" or r.shade_table_orig is None:
        raise RuntimeError(f"deferred frame: route {r.route}")
    (kept, frame_ms), n = drive({"rasterize_rows16": 6, "any": 6},
                                lambda: frames(r, 6))
    valid_share = check_image(kept[0], w, h, "deferred")
    for f in kept[1:]:
        if not torch.equal(f["image"], kept[0]["image"]):
            raise RuntimeError("deferred frames are not bit-identical")
    against = image_against(kept[0]["image"], kept[0]["valid"], c1["image"],
                            c1["valid"])
    if not against["ok"]:
        raise RuntimeError(f"deferred frame against the ray frame: "
                           f"{against}")
    turns = in_turns(ras32, r)
    res = dict(launches=n, frame_ms=frame_ms,
               frame_ms_mean=float(np.mean(frame_ms)),
               valid_share=valid_share, vs_ray=against,
               in_turns_ms={"raster32": turns["a"], "deferred": turns["b"]},
               setup=dict(r.stats))
    log(f"phase 17 deferred frames: {json.dumps(res)}")

    cap = default_cap_rows(mesh.num_triangles)
    bins = bin_rows(cam, r.mesh, w, h, cap, fmt="z16")
    syncs = host_syncs(lambda: bin_rows(cam, r.mesh, w, h, cap, fmt="z16"))
    if syncs:
        raise RuntimeError(f"bin_rows(fmt='z16') waited for the card: "
                           f"{syncs}")
    res["bins"] = bins_stats(bins)
    res["bin_rows_host_syncs"] = len(syncs)
    before = R.rasterize_rows16_cuda.launches
    kres = R.rasterize_rows16_cuda(bins, w, h)
    torch.cuda.synchronize()
    if R.rasterize_rows16_cuda.launches != before + 1:
        raise RuntimeError("rasterize_rows16: launch counter did not grow")
    ms = cuda_ms(lambda: R.rasterize_rows16_cuda(bins, w, h), 20)
    stages = {"binning": cuda_ms(lambda: bin_rows(cam, r.mesh, w, h, cap,
                                                  fmt="z16"), 5),
              "raster_kernel": cuda_ms(
                  lambda: R.rasterize_rows16_cuda(bins, w, h), 5),
              "spans": span_ms(r)}
    R.rasterize_rows16_cuda.launches = before
    stats = {}
    pres, plain_ms = host_ms(lambda: R.rasterize_rows16_reference(
        bins, w, h, stats=stats))
    for name, k, p in zip(("tri_id", "u", "v", "1/w"), kres, pres):
        if not torch.equal(k, p):
            raise RuntimeError(f"rasterize_rows16: {name} differs from the "
                               f"plain version on {int((k != p).sum())} "
                               f"pixels")
    ntiles = int(bins.row_starts.numel())
    nbytes = ((res["bins"]["pair_rows"] + res["bins"]["big_nrows"] * ntiles)
              * 512 + 2 * ntiles * 4 + 4 * w * h * 4)
    ops = OPS_PER_TEST * stats["record_tests"] \
        + OPS_PER_TAKE16 * stats["takes"]
    res["kernel"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
                         mismatch_share=0.0, valid=int((kres[0] >= 0).sum()),
                         **stats, **build_bound(nbytes, ops))
    res["stages_ms"] = stages
    log(f"phase 17 rasterize_rows16: {json.dumps(res['kernel'])}; bins "
        f"{json.dumps(res['bins'])}; stages {json.dumps(stages)}")

    # The plain rebuild's deferred frame (the original-order table per
    # frame), against the static deferred one.
    rb = Renderer(mesh, cam, hard, RenderConfig(
        width=w, height=h, leaf_size=14, rebuild_splits=0,
        raster_deferred=True), mode="rebuild", device=dev)
    if rb.config.gbuffer != "raster" or rb.shade_table_orig is None:
        raise RuntimeError("the plain rebuild did not take the deferred "
                           "raster G-buffer")
    rsyncs = host_syncs(rb._rebuild)
    if rsyncs:
        raise RuntimeError(f"deferred rebuild host syncs: {rsyncs}")
    (k3, ms3, build3), n3 = drive(
        {"rasterize_rows16": 6, "any": 6, "morton_codes": 6, "topology": 6,
         "collapse_area": 6}, lambda: rebuild_frames(rb, 6))
    for f in k3[1:]:
        if not torch.equal(f["image"], k3[0]["image"]):
            raise RuntimeError("deferred rebuild frames are not "
                               "bit-identical")
    diff = (k3[0]["image"] - kept[0]["image"]).abs().amax(-1)
    v3 = k3[0]["valid"]
    share3 = float(((diff > 1e-3) & v3).sum()) / int(v3.sum())
    if share3 > 1e-3:
        raise RuntimeError(f"deferred rebuild frame differs on {share3:.2e}")
    res["rebuild"] = dict(launches=n3, frame_ms=ms3,
                          frame_ms_mean=float(np.mean(ms3)), build_ms=build3,
                          build_ms_mean=float(np.mean(build3)),
                          host_syncs=len(rsyncs), vs_static_share=share3)
    log(f"phase 17 deferred rebuild: {json.dumps(res['rebuild'])}")

    # The textured hall: the deferred raster frame against the textured ray
    # frame (phase 13's 32-float raster frame looked up other texels on
    # 2.5% of pixels).
    rt = Renderer(textured["mesh"], cam, hard, RenderConfig(
        width=w, height=h, leaf_size=14, gbuffer="raster",
        raster_deferred=True), device=dev)
    (kt, _), nt = drive({"rasterize_rows16": 2, "any": 2},
                        lambda: frames(rt, 2))
    check_image(kt[0], w, h, "textured deferred")
    tex = raster_texture_against(rt, textured["fused"])
    if not tex["ok"]:
        raise RuntimeError(f"textured deferred frame against the ray "
                           f"frame: {tex}")
    res["textured"] = dict(launches=nt, vs_ray=tex)
    log(f"phase 17 textured deferred: {json.dumps(res['textured'])}")
    return res


# ---------------------------------------------------------------------------
# Phase 18: the w8t accel (WideBVHT, transposed leaves)
# ---------------------------------------------------------------------------

W8T_KERNELS = ("w8t_any", "w8t_closest", "w8t_closest_attrs",
               "w8t_closest_attrs_tex")


def w8t_accel(mesh, leaf: int, dev) -> dict:
    """The mesh's Morton tree built on the card at ``leaf``, its 8-wide
    accel, the WideBVHT, the transposed attribute rows and the shade
    table; the per-ray stack checked against the wide depth."""
    from tpurt_torch.bvh.lbvh import build_lbvh
    from tpurt_torch.bvh.wide import build_wide, build_wide_t, wide_depth
    from tpurt_torch.kernels.traverse import check_stack_bound
    from tpurt_torch.passes.shading import (make_leaf_attr_rows_t,
                                            make_shade_table)
    md = mesh.on(dev)
    out, ms = {}, {}
    for key, fn in (
            ("bvh", lambda: build_lbvh(md.vertices, md.indices,
                                       leaf_size=leaf)),
            ("wide", lambda: build_wide(out["bvh"])),
            ("acc", lambda: build_wide_t(out["wide"], out["bvh"])),
            ("at_t", lambda: make_leaf_attr_rows_t(out["bvh"], md)),
            ("st", lambda: make_shade_table(out["bvh"], md))):
        out[key], ms[key + "_ms"] = host_ms(fn)
    depth = wide_depth(out["wide"])
    check_stack_bound(depth)
    out["setup"] = dict(leaf=leaf, wide_rows=out["wide"].num_wide,
                        leaves=out["acc"].num_leaves,
                        blocks=int(out["acc"].tris_t.shape[0]),
                        wide_depth=depth, **ms)
    out["mesh"] = md
    return out


def w8t_frame_fn(acc, a, cam, cfg, light=None):
    """One render_frame_fn call as a Renderer-like object for ``frames``
    and ``in_turns``: the shade-table frame of ``light`` (the hard sun by
    default) on accel ``acc`` (a's mesh and table); its walk counters must
    be zero."""
    import types
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.app import render_frame_fn
    from tpurt_torch.types import Light
    light = light or Light.directional(SUN_DIR)

    def render_frame():
        out = render_frame_fn(acc, a["mesh"], cam, [light], cfg,
                              shade_table=a["st"])
        tr.check_walk_counts(out["walk_counts"])
        return out
    return types.SimpleNamespace(render_frame=render_frame)


def w8t_inputs(name, acc, tables, o, d, shadow, step: int = 1):
    """Kernel ``name``'s inputs on every ``step``-th row: the camera rays,
    or for the any hit the sun's shadow rays ``shadow`` of the frame's
    G-buffer; ``tables`` the attribute rows of ``acc``'s layout."""
    import tpurt_torch.kernels.traverse as tr

    def rows(x):
        return x[::step].contiguous()
    if name in ("any", "w8t_any"):
        return tr.any_inputs(acc, *(rows(x) for x in shadow))[:2]
    if "attrs" in name:
        return tr.closest_attrs_inputs(acc, rows(o), rows(d), tables)[:2]
    return tr.closest_inputs(acc, rows(o), rows(d))[:2]


def w8t_vs_plain(name, acc, tables, o, d, shadow, what) -> dict:
    return vs_plain(name, w8t_inputs(name, acc, tables, o, d, shadow),
                    w8t_inputs(name, acc, tables, o, d, shadow, step=8),
                    what, tri_id=acc.tri_id)


def w8t_vs_row_twin(name, twin, a, tables, twin_tables, o, d,
                    shadow) -> dict:
    """The w8t kernel ``name`` and its row-layout twin on the leaf-8 tree's
    accels, the same rays: equal on every ray (the attribute walks but for
    the layer channel, -1 against 0); both timed."""
    import tpurt_torch.kernels.traverse as tr
    args, kw = w8t_inputs(name, a["acc"], tables, o, d, shadow)
    targs, tkw = w8t_inputs(twin, a["wide"], twin_tables, o, d, shadow)
    kfn, tfn = getattr(tr, f"{name}_cuda"), getattr(tr, f"{twin}_cuda")
    before = (kfn.launches, tfn.launches)
    kres, tres = kfn(*args, **kw), tfn(*targs, **tkw)
    torch.cuda.synchronize()
    if "attrs" in name:
        if not bool((kres[0][:, 7] == -1.0).all()):
            raise RuntimeError(f"{name}: the layer is not -1 on every ray")
        keep = [c for c in range(kres[0].shape[1]) if c != 7]
        kres = (kres[0][:, keep], *kres[1:])
        tres = (tres[0][:, keep], *tres[1:])
    for k, t in zip(kres, tres):
        if not torch.equal(k, t):
            raise RuntimeError(f"{name} differs from {twin} on "
                               f"{int((k != t).sum())} values")
    ms = cuda_ms(lambda: kfn(*args, **kw), 10)
    twin_ms = cuda_ms(lambda: tfn(*targs, **tkw), 10)
    kfn.launches, tfn.launches = before
    return dict(equal=True, ms=ms, twin=twin, twin_ms=twin_ms)


def w8t_soft_frames(a, cam, cfg, launches_) -> dict:
    """A 2 deg sun at spp 4 on the WideBVHT: no in-kernel sampler takes
    that accel, so each frame is one w8t closest hit and spp w8t any-hit
    calls (the shadow pass's loop over samples); two frames of one seed,
    finite, with a penumbra and bit-identical."""
    from tpurt_torch.types import Light
    r = w8t_frame_fn(a["acc"], a, cam, dataclasses.replace(cfg, spp=4),
                     Light.sun(SUN_DIR, angular_radius_deg=2.0))
    (kept, frame_ms), n = drive({"w8t_closest": 2, "w8t_any": 8},
                                lambda: frames(r, 2))
    for k, v in n.items():
        launches_[k] += v
    check_image(kept[0], MAIN_W, MAIN_H, "w8t soft sun")
    if not torch.equal(kept[0]["image"], kept[1]["image"]):
        raise RuntimeError("w8t soft-sun frames of one seed are not "
                           "bit-identical")
    vis = kept[0]["shadow"][0][kept[0]["valid"]]
    penumbra = float(((vis > 0) & (vis < 1)).float().mean())
    if not penumbra > 0:
        raise RuntimeError("w8t soft sun: no penumbra")
    return dict(frame_ms=frame_ms[0], launches=n, penumbra_share=penumbra)


def phase_w8t(dev, mesh, c1, tmesh) -> dict:
    """The w8t accel at 1080p in the hall, leaf 16 and leaf 8; c1: phase
    4's image and valid mask; tmesh: phase 13's textured hall."""
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.passes.gbuffer import gbuffer_attr_pass
    from tpurt_torch.passes.shading import make_leaf_attr_rows
    from tpurt_torch.passes.shadow import shadow_ray_batch
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    t_start = time.perf_counter()
    cam = sponza_interior_camera()
    sun = Light.directional(SUN_DIR)
    accels = {k: w8t_accel(mesh, k, dev) for k in (16, 8)}
    tex = w8t_accel(tmesh, 8, dev)
    res = {"setup": {k: a["setup"] for k, a in accels.items()},
           "textured_setup": tex["setup"]}
    log(f"phase 18 setup: {json.dumps(res)}")
    o, d = generate_rays(cam, MAIN_W, MAIN_H, dev)
    launches_ = {k: 0 for k in W8T_KERNELS}
    res["kernels"] = {}
    for leaf in (16, 8):
        a = accels[leaf]
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=leaf,
                           gbuffer="ray")
        r = w8t_frame_fn(a["acc"], a, cam, cfg)
        (kept, frame_ms), n = drive({"w8t_closest": 6, "w8t_any": 6},
                                    lambda: frames(r, 6))
        for k, v in n.items():
            launches_[k] += v
        check_image(kept[0], MAIN_W, MAIN_H, f"w8t leaf {leaf}")
        for f in kept[1:]:
            if not torch.equal(f["image"], kept[0]["image"]):
                raise RuntimeError(f"w8t leaf {leaf} frames are not "
                                   "bit-identical")
        vs4 = image_against(kept[0]["image"], kept[0]["valid"], c1["image"],
                            c1["valid"])
        if not vs4["ok"]:
            raise RuntimeError(f"w8t leaf {leaf} frame against phase 4's: "
                               f"{vs4}")
        gbuf = r.render_frame()
        # The attribute G-buffer (gbuffer_attr_pass): the same walk.
        (ab, counts), na = drive(
            {"w8t_closest_attrs": 1},
            lambda: gbuffer_attr_pass(a["acc"], a["at_t"], a["mesh"], cam,
                                      MAIN_W, MAIN_H))
        launches_["w8t_closest_attrs"] += na["w8t_closest_attrs"]
        tr.check_walk_counts(counts)
        if not (torch.equal(ab["tri_id"], gbuf["tri_id"])
                and torch.equal(ab["t"], gbuf["t"])):
            raise RuntimeError(f"w8t leaf {leaf}: the attribute G-buffer's "
                               "hits differ from the shade-table frame's")
        shadow = shadow_ray_batch(gbuf, sun, cfg.shadow_bias, None,
                                  (a["acc"].root_min, a["acc"].root_max))
        entry = dict(frame_ms=frame_ms, frame_ms_mean=float(np.mean(
            frame_ms)), vs_phase4=vs4, launches=n)
        for name in ("w8t_closest", "w8t_any", "w8t_closest_attrs"):
            kp = w8t_vs_plain(name, a["acc"], a["at_t"], o, d, shadow,
                              f"phase 18 leaf {leaf} {name}")
            res["kernels"].setdefault(name, {})[leaf] = kp
        if leaf == 8:
            twin = w8t_frame_fn(a["wide"], a, cam, dataclasses.replace(
                cfg, fused_shadow=False, order_children=False))
            tw = twin.render_frame()
            if not torch.equal(tw["image"], gbuf["image"]):
                raise RuntimeError("the leaf-8 w8t frame differs from its "
                                   "row-layout twin")
            turns = in_turns(twin, r)
            entry["in_turns_ms"] = {"row_twin": turns["a"],
                                    "w8t": turns["b"]}
            at_rows = make_leaf_attr_rows(a["bvh"], a["mesh"])
            entry["vs_row_twin"] = {
                name: w8t_vs_row_twin(name, twin_name, a, a["at_t"], at_rows,
                                      o, d, shadow)
                for name, twin_name in (("w8t_closest", "closest"),
                                        ("w8t_closest_attrs",
                                         "closest_attrs"),
                                        ("w8t_any", "any"))}
        if leaf == 16:
            entry["soft_sun_spp4"] = w8t_soft_frames(a, cam, cfg, launches_)
        res[f"leaf{leaf}"] = entry
        log(f"phase 18 leaf {leaf}: {json.dumps(entry)}")
    # The textured hall: gbuffer_attr_pass takes the attrs=2 walk.
    (tb, counts), nt = drive(
        {"w8t_closest_attrs_tex": 1},
        lambda: gbuffer_attr_pass(tex["acc"], tex["at_t"], tex["mesh"], cam,
                                  MAIN_W, MAIN_H))
    launches_["w8t_closest_attrs_tex"] += nt["w8t_closest_attrs_tex"]
    tr.check_walk_counts(counts)
    layers = int(torch.unique(tb["tex_layer"][tb["valid"]]).numel())
    if layers < 2:
        raise RuntimeError(f"textured w8t G-buffer: {layers} layers hit")
    res["textured"] = dict(launches=nt, layers_hit=layers,
                           valid_share=float(tb["valid"].float().mean()))
    res["kernels"]["w8t_closest_attrs_tex"] = {8: w8t_vs_plain(
        "w8t_closest_attrs_tex", tex["acc"], tex["at_t"], o, d, None,
        "phase 18 textured w8t_closest_attrs_tex")}
    res["launches"] = launches_
    res["phase_s"] = time.perf_counter() - t_start
    log(f"phase 18 textured: {json.dumps(res['textured'])}; launches "
        f"{json.dumps(launches_)}; {res['phase_s']:.1f} s")
    return res


def w8t_kernel_row(name, launches_, per_leaf) -> dict:
    """The kernel table's row of a w8t kernel: the leaf-8 numbers, and the
    leaf-16 ones beside them where the kernel ran there."""
    kp = per_leaf[8]
    row = kernel_row(name, launches_, kp, {})
    if 16 in per_leaf:
        k16 = per_leaf[16]
        row["leaf16"] = {k: k16[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "closest_tris", "anyhit_tris")}
        row["max_abs_err"] = max(row["max_abs_err"], k16["max_abs_err"])
    return row


def build_kernel_row(name, launches_, kp) -> dict:
    return {"name": name, "route": "cuda", "source": CSRC + "build.cu",
            "replaces": f"{BUILD_TPU}{BUILD_KERNEL_LINES[name]}",
            "launches": launches_, "max_abs_err": kp["max_abs_err"],
            "mismatch_share": kp["mismatch_share"], "ms": kp["ms"],
            "plain_ms": kp["plain_ms"], "bound_ms": kp["bound_ms"],
            "bound_by": kp["bound_by"], "library_ms": None}


def kernel_row(name, launches_, kp, small) -> dict:
    import tpurt_torch.kernels.traverse as tr
    src, line = tr.WALK_KERNELS[name].source, KERNELS[name]
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


VARIANTS_TPU = "tpurt/kernels/_variants.py:"
# The v1 rasterizer's TPU kernel, and its operations per take: the state
# writes of 1/w, d1, d2, the d-sum and the id.
RASTER_V1_TPU = "tpurt/kernels/raster.py:77"
OPS_PER_TAKE_V1 = 5
# A node box: three mins and three maxes of the union.
OPS_PER_BOX_UNION = 6


def clustered_split(r):
    """The rebuild's clustered leaves as _rebuild_fused computes them on
    the Renderer's geometry -> (adjacent deltas, leaf min, leaf max)."""
    from tpurt_torch.bvh import lbvh as L
    from tpurt_torch.kernels.build import morton_codes
    m, k, splits = r.mesh, r.config.leaf_size, r._rebuild_splits
    tpad = r.bvh.num_sorted_tris
    _, v0, e1, e2, cen, smin, smax = L._triangle_data(m.vertices, m.indices,
                                                      tpad)
    chs, (sv0, se1, se2) = L._sort_payload(morton_codes(cen, smin, smax),
                                           [v0, e1, e2])
    split = L._subleaf_split(chs, *L._leaf_boxes(sv0, se1, se2, k)[2:], k,
                             splits)
    return (L.adjacent_deltas(split[1]).contiguous(),
            split[2].contiguous(), split[3].contiguous())


def variant_row(name, kernel_name, replaces, source, launches_, kp) -> dict:
    """A kernel table row of phase 19: ``kernel_name`` is the kernel the
    entry point launches (a routed variant names its mode's kernel)."""
    row = {"name": name, "kernel": kernel_name, "route": "cuda",
           "source": CSRC + source, "replaces": replaces,
           "launches": launches_}
    row.update({k: kp[k] for k in (
        "max_abs_err", "mismatch_share", "ms", "plain_ms", "bound_ms",
        "bound_by")})
    row["library_ms"] = None
    return row


def phase_variants(dev, mesh, r4) -> dict:
    """Phase 19 on the hall at 1080p; r4: phase 4's config-1 Renderer
    (its SBVH accel, attribute rows and camera)."""
    import tpurt_torch.kernels._variants as V
    import tpurt_torch.kernels.build as B
    import tpurt_torch.kernels.raster as R
    import tpurt_torch.kernels.traverse as tr
    from tpurt_torch.app import Renderer, gbuffer_production
    from tpurt_torch.bvh.lbvh import _assemble_node_boxes
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.passes.shadow import shadow_ray_batch
    from tpurt_torch.raster.setup import (bin_rows, bin_triangles,
                                          default_cap_pairs,
                                          default_cap_rows)
    from tpurt_torch.types import RenderConfig
    t_start = time.perf_counter()
    w, h = MAIN_W, MAIN_H
    cam, sun, acc = r4.camera, r4.lights[0], r4.accel
    gbuf, _ = gbuffer_production(acc, r4.mesh, cam, r4.config,
                                 r4.attr_tables)
    so, sd, stm = shadow_ray_batch(gbuf, sun, BIAS, None,
                                   (acc.root_min, acc.root_max))
    o, d = generate_rays(cam, w, h, dev)
    rb = Renderer(mesh, cam, sun, RenderConfig(
        width=w, height=h, bvh_width=2, leaf_size=14, gbuffer="ray"),
        device=dev)
    packed = rb.accel
    rr = Renderer(mesh, cam, sun, RenderConfig(width=w, height=h,
                                               leaf_size=14),
                  mode="rebuild", device=dev)
    gaps, lmin, lmax = clustered_split(rr)
    md = mesh.on(dev)
    cap = default_cap_pairs(mesh.num_triangles)
    torch.cuda.synchronize()
    log(f"phase 19 setup: binary internal={packed.num_internal} "
        f"gaps={int(gaps.shape[0])} cap_pairs={cap}")

    def run():
        out = {"stats": V.trace_any_stats(acc, so, sd, stm),
               "x2": tr.trace_any(acc, so, sd, stm, variant="x2"),
               "frustum_any": tr.trace_any(packed, so, sd, stm,
                                           variant="frustum"),
               "frustum_closest": tr.trace_closest(
                   packed, o, d, return_sorted=True, variant="frustum"),
               "topology_and_boxes": B.topology_and_boxes(gaps, lmin,
                                                          lmax)}
        bins = bin_triangles(cam, md, w, h, cap)
        out["bins"] = bins
        out["raster"] = R.rasterize_tiles(bins, w, h)
        return out
    res, n = drive({"any_stats": 1, "any": 1, "binary_any": 1,
                    "binary_closest": 1, "topology_and_boxes": 1,
                    "rasterize_tiles": 1}, run)
    out = {"launches": n, "kernels": {}}

    # (a) The stats walk: kernel against plain, and against ANY.
    occ, iters, counts = res["stats"]
    tr.check_walk_counts(counts)
    args, kw, p, meta = V.any_stats_inputs(acc, so, sd, stm)
    before = V.any_stats_cuda.launches
    kres = V.any_stats_cuda(*args, **kw)
    ms = cuda_ms(lambda: V.any_stats_cuda(*args, **kw), 10)
    V.any_stats_cuda.launches = before
    stats = {}
    pres, plain_ms = host_ms(lambda: V.any_stats_reference(
        *args, stats=stats, **kw))
    for what, a, b in (("occlusion", kres[0], pres[0]),
                       ("iterations", kres[1], pres[1]),
                       ("walk counts", kres[2], pres[2])):
        if not torch.equal(a, b):
            raise RuntimeError(f"any_stats: {what} differs from the plain "
                               f"version on {int((a != b).sum())} entries")
    if not torch.equal(kres[1][:p, 0, 0], iters):
        raise RuntimeError("any_stats: the entry point's iterations differ")
    any_occ, any_counts = tr.trace_any(acc, so, sd, stm)
    active = stm > 0.0
    nact = int(active.sum())
    vs_any = int((any_occ != occ).sum())
    if vs_any > 1e-3 * nact:
        raise RuntimeError(f"any_stats: occlusion differs from ANY's on "
                           f"{vs_any} of {nact} active rays")
    it = iters.double()
    live = it > 0
    kp = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
              mismatch_share=vs_any / nact, vs_any_rays=vs_any,
              packets=int(p), mean_iters=float(it.mean()),
              mean_iters_live=float(it[live].mean()),
              max_iters=int(it.max()), live_packets=int(live.sum()),
              **bound(stats, args, kres))
    # The same tests over every lane of each packet (tpurt's SIMD work),
    # beside the bound of the tests the kernel does.
    simd_ops = (int(stats["simd_pops"]) * OPS_PER_POP
                + int(stats["simd_slab_tests"]) * OPS_PER_SLAB
                + int(stats["simd_tris"]) * OPS_PER_TRI)
    kp.update(simd_ops=simd_ops, simd_bound_ms=max(
        kp["bytes_ms"], simd_ops / FP32_PEAK * 1e3))
    out["kernels"]["any_stats"] = kp
    log(f"phase 19 any_stats: {json.dumps(kp)}")

    # (b)-(d) The routed variants: the mode's kernel, equal to the default
    # call, and that kernel against its plain version on the same rays.
    for key, name, default, inputs in (
            ("x2", "any", lambda: tr.trace_any(acc, so, sd, stm),
             lambda: tr.any_inputs(acc, so, sd, stm)[:2]),
            ("frustum_any", "binary_any",
             lambda: tr.trace_any(packed, so, sd, stm),
             lambda: tr.binary_any_inputs(packed, so, sd, stm)[:2]),
            ("frustum_closest", "binary_closest",
             lambda: tr.trace_closest(packed, o, d, return_sorted=True),
             lambda: tr.binary_closest_inputs(packed, o, d)[:2])):
        want = default()
        for a, b in zip(res[key], want):
            if not torch.equal(a, b):
                raise RuntimeError(f"variant {key} differs from {name}'s "
                                   "default call")
        args, kw = inputs()
        kp = time_pair(name, args, kw, tri_id=packed.tri_id)
        kp.update({k: kp["compare"][k] for k in ("max_abs_err",
                                                 "mismatch_share")})
        out["kernels"][key] = kp
        log(f"phase 19 {key} (mode {name}): {json.dumps(kp)}")

    # (e) topology_and_boxes, exact, beside topology + the range boxes.
    kt = res["topology_and_boxes"]
    cmp = build_pair("topology_and_boxes", (gaps, lmin, lmax),
                     "topology_and_boxes, config 2")
    pt = B.topology_and_boxes_reference(gaps, lmin, lmax)
    for i, (a, b) in enumerate(zip(kt, pt)):
        if not torch.equal(a, b):
            raise RuntimeError(f"topology_and_boxes output {i} differs")
    ni = int(gaps.shape[0])
    levels = max(1, ni.bit_length())
    kp = dict(**cmp, **time_build("topology_and_boxes", (gaps, lmin, lmax)),
              **build_bound(
                  ni * 4 + (ni + 1) * 24 + ni * 8 + ni * 8 + ni * 48 + 24,
                  (levels - 1) * ni + 2 * levels * ni
                  + OPS_PER_TOPOLOGY_PLACE * (ni + 1)
                  + OPS_PER_BOX_UNION * ni))
    kp["topology_and_range_boxes_ms"] = cuda_ms(
        lambda: _assemble_node_boxes(lmin, lmax, *B.topology_cuda(gaps)), 20)
    B.topology_cuda.launches = 0
    out["kernels"]["topology_and_boxes"] = kp
    log(f"phase 19 topology_and_boxes: {json.dumps(kp)}")

    # (f) The v1 binning and rasterizer.
    bins = res["bins"]
    syncs = host_syncs(lambda: bin_triangles(cam, md, w, h, cap))
    if syncs or bool(bins.overflow):
        raise RuntimeError(f"bin_triangles: host syncs {syncs}, overflow "
                           f"{bool(bins.overflow)}")
    kr = res["raster"]
    before = R.rasterize_tiles_cuda.launches
    ms = cuda_ms(lambda: R.rasterize_tiles_cuda(bins, w, h), 10)
    R.rasterize_tiles_cuda.launches = before
    stats = {}
    pr, plain_ms = host_ms(lambda: R.rasterize_tiles_reference(
        bins, w, h, stats=stats))
    for what, a, b in zip(("tri_id", "u", "v", "1/w"), kr, pr):
        if not torch.equal(a, b):
            raise RuntimeError(f"rasterize_tiles: {what} differs from the "
                               f"plain version on {int((a != b).sum())} "
                               "pixels")
    before = R.rasterize_rows_cuda.launches
    rows_tri, _ = R.rasterize_rows(
        bin_rows(cam, md, w, h, default_cap_rows(mesh.num_triangles)), w, h)
    R.rasterize_rows_cuda.launches = before
    # Against the production rasterizer: the same coverage, and the same
    # ids but where the v1 records' pixel-scale cross products lose the
    # depth order (ROADMAP decision 24: tpurt's own v1 differs from its
    # own rasterize_rows on 0.45% of covered pixels of this mesh at
    # 160x96, tests/test_torch_raster_tiles.py, and this run measured
    # 0.48%; the limit is just below that).
    cov, rcov = kr[0] >= 0, rows_tri >= 0
    cov_off = float((cov != rcov).float().mean())
    both = cov & rcov
    id_share = float((kr[0] == rows_tri)[both].float().mean())
    if cov_off >= 2e-3 or id_share < 0.994:
        raise RuntimeError(f"rasterize_tiles against rasterize_rows: "
                           f"coverage off on {cov_off}, ids equal on "
                           f"{id_share}")
    ntiles = int(bins.starts.numel())
    pairs = int(bins.counts.sum())
    nbig = int(bins.big_count)
    nbytes = (pairs + nbig * ntiles) * 64 + 2 * ntiles * 4 + 4 * w * h * 4
    ops = OPS_PER_TEST * stats["record_tests"] \
        + OPS_PER_TAKE_V1 * stats["takes"]
    kp = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0, mismatch_share=0.0,
              pairs=pairs, big_count=nbig, cap_pairs=cap,
              binning_ms=cuda_ms(lambda: bin_triangles(cam, md, w, h, cap),
                                 5),
              vs_rows=dict(coverage_off=cov_off, ids_equal=id_share),
              **stats, **build_bound(nbytes, ops))
    out["kernels"]["rasterize_tiles"] = kp
    log(f"phase 19 rasterize_tiles: {json.dumps(kp)}")
    out["phase_s"] = time.perf_counter() - t_start
    log(f"phase 19 launches {json.dumps(n)}; {out['phase_s']:.1f} s")
    return out


def variants_rows(var) -> list:
    """The kernel table's rows of phase 19's six TPU kernels."""
    n, k = var["launches"], var["kernels"]
    return [
        variant_row("any_stats", "any_stats", f"{VARIANTS_TPU}37",
                    "variants.cu", n["any_stats"], k["any_stats"]),
        variant_row("any_x2", "any", f"{VARIANTS_TPU}100", "shadow_rays.cu",
                    n["any"], k["x2"]),
        variant_row("any_frustum", "binary_any", f"{VARIANTS_TPU}229",
                    "binary.cu", n["binary_any"], k["frustum_any"]),
        variant_row("closest_frustum", "binary_closest", f"{VARIANTS_TPU}284",
                    "binary.cu", n["binary_closest"], k["frustum_closest"]),
        variant_row("topology_and_boxes", "topology_and_boxes",
                    f"{BUILD_TPU}288", "build.cu", n["topology_and_boxes"],
                    k["topology_and_boxes"]),
        variant_row("rasterize_tiles", "rasterize_tiles", RASTER_V1_TPU,
                    "raster.cu", n["rasterize_tiles"],
                    k["rasterize_tiles"])]


@contextlib.contextmanager
def eager_frames():
    """Frames rendered inside run their stages eagerly: the graph frames'
    comparison."""
    import tpurt_torch.app as app
    saved = app.takes_graph
    app.takes_graph = lambda *args: False
    try:
        yield
    finally:
        app.takes_graph = saved


def textured_hall(mesh):
    """Phase 13's textured hall, written as OBJ/MTL/PNG and loaded."""
    import tempfile
    from tpurt_torch.io.obj import load_obj
    with tempfile.TemporaryDirectory() as root:
        return load_obj(write_textured_hall(mesh, root)["path"],
                        use_native=True)


def _graph_run(r, n: int, eager: bool, move=None):
    """n frames of ``r`` (eagerly where ``eager``; the camera set to
    ``move`` before frame 4) -> (outputs, the frame-2 outputs' copies
    taken when it returned, CUDA-event ms and host ms of frames 3..n)."""
    outs, held, dev_ms, host_ms = [], None, [], []
    for i in range(n):
        if move is not None and i == 3:
            r.camera = move
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with eager_frames() if eager else contextlib.nullcontext():
            out = r.render_frame()
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
        if i == 1:
            held = {k: v.clone() for k, v in out.items()}
        outs.append(out)
    return outs, held, dev_ms, host_ms


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def phase_frame_graph(dev, mesh, tmesh) -> dict:
    """The static frame's CUDA graphs against its eager frames: per
    route, the outputs bit for bit, the launches, the captures and
    replays, the held frame-2 outputs, the moved camera (hard fused0 and
    the raster frame), the host syncs of a graph frame; both frames' ms
    and spans."""
    from tpurt_torch.app import Renderer
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Camera, Light, RenderConfig
    cam = sponza_interior_camera()
    moved = Camera.look_at(np.asarray(cam.position) + np.float32(
        [0.4, 0.1, -0.3]), cam.target, fov_y_deg=60.0,
        zfar=float(cam.zfar))
    hard = Light.directional(SUN_DIR)
    sun = Light.sun(SUN_DIR, angular_radius_deg=2.0)
    fills = config5_lights()[1:]
    seed = 2 ** 31 + 16_001
    cases = {
        "hard": (mesh, [hard], {}, "fused0"),
        "soft_spp8": (mesh, [sun], dict(spp=SPP, accumulate=True),
                      "fused0"),
        "three_suns": (mesh, config5_lights(), {}, "fusedN"),
        "sun_fills": (mesh, [sun] + fills, dict(spp=SPP), "fusedSM"),
        "unfused": (mesh, [hard], dict(fused_shadow=False), "unfused"),
        "unfused_soft_spp8": (mesh, [sun], dict(
            fused_shadow=False, spp=SPP, accumulate=True), "unfused"),
        "shade_table": (mesh, [hard], dict(inkernel_attrs=False), "fused0"),
        "textured": (tmesh, [hard], {}, "fused0"),
        "raster": (mesh, [hard], dict(gbuffer="raster", sah=False,
                                      fused_shadow=False), "unfused"),
        "raster_z16_suns": (mesh, config5_lights(), dict(
            gbuffer="raster", sah=False, raster_deferred=True), "unfused"),
    }
    res = {}
    for name, (m, lights, fields, route) in cases.items():
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14,
                           seed=seed, **fields)
        move = moved if name in ("hard", "raster") else None
        got = {}
        for side in ("graph", "eager"):
            r = Renderer(m, cam, lights, cfg, device=dev)
            if r.route != route:
                raise RuntimeError(f"frame_graph {name} takes route "
                                   f"{r.route}, want {route}")
            reset_launches()
            outs, held, dev_ms, host_ms = _graph_run(r, 6, side == "eager",
                                                     move)
            got[side] = dict(r=r, outs=outs, held=held, launches=launches(),
                             dev_ms=dev_ms, host_ms=host_ms)
        g, e = got["graph"], got["eager"]
        for i, (a, b) in enumerate(zip(g["outs"], e["outs"])):
            bad = [k for k in b if k not in a or not _same_bits(a[k], b[k])]
            if bad or set(a) != set(b):
                raise RuntimeError(f"frame_graph {name} frame {i + 1}: "
                                   f"graph and eager differ in {bad}")
        for side, x in got.items():
            bad = [k for k, v in x["held"].items()
                   if not _same_bits(x["outs"][1][k], v)]
            if bad:
                raise RuntimeError(f"frame_graph {name} ({side}): frame 2's "
                                   f"{bad} changed by later frames")
        if g["launches"] != e["launches"]:
            raise RuntimeError(f"frame_graph {name}: graph launches "
                               f"{g['launches']}, eager {e['launches']}")
        stats = {k: (g["r"].stats[k], e["r"].stats[k])
                 for k in ("graph_captures", "graph_replays")}
        if stats != {"graph_captures": (1, 0), "graph_replays": (5, 0)}:
            raise RuntimeError(f"frame_graph {name}: {stats}")
        syncs = counted_syncs(g["r"], f"frame_graph {name}", 1)
        if g["r"].spans.graph_frames != 1:
            raise RuntimeError(f"frame_graph {name}: the traced frame did "
                               f"not replay its graphs")
        res[name] = dict(
            route=route, launches={k: v for k, v in g["launches"].items()
                                   if v},
            graph_ms=g["dev_ms"], eager_ms=e["dev_ms"],
            graph_host_ms=g["host_ms"], eager_host_ms=e["host_ms"],
            graph_ms_mean=float(np.mean(g["dev_ms"])),
            eager_ms_mean=float(np.mean(e["dev_ms"])), syncs=syncs,
            graphs=sum(s[0] == "graph" for s in g["r"]._graphs.steps))
        if name in ("hard", "three_suns", "raster"):
            res[name]["spans_graph"] = span_ms(g["r"])
            with eager_frames():
                res[name]["spans_eager"] = span_ms(e["r"])
        log(f"phase 20 frame_graph {name}: {json.dumps(res[name])}")
        del got, g, e
        torch.cuda.empty_cache()
    return res


def _resolve_launch(r):
    """A fresh frame block and the Renderer's fused launch on it, its
    outputs left in packets -> (launch, shadow kind, consts, origins,
    dirs)."""
    from tpurt_torch.app import frame_seed, fused_launch
    from tpurt_torch.bvh.wide import order_children_for_point
    from tpurt_torch.camera import generate_rays
    cfg = r.config
    consts = r._block.write(r.camera, r.lights, cfg,
                            frame_seed(cfg.seed, 7))
    acc = order_children_for_point(r.accel, consts.camera.position)
    launch, kind = fused_launch(r.route, acc, consts.lights, cfg,
                                consts.seed, consts.bias, r.attr_tables,
                                False)
    o, d = generate_rays(consts.camera, cfg.width, cfg.height, r.device)
    return launch(o, d), kind, consts, o, d


# Bytes a pixel of the origins kernel: t, the sorted index and the
# geometric normal (5 channels) and o, d (6) in, the block's 4 channels out.
ORIGINS_BYTES = (5 + 6 + 4) * 4


def resolve_bytes(npix: int, nvalid: int, nshadow: int, nlights: int,
                  block_floats: int) -> int:
    """What the frame resolve reads and writes once: per pixel the sorted
    index, the ray and the shadow words, per valid pixel 11 more attribute
    channels, the frame block; out the G-buffer, the shadows and the
    image."""
    read = npix * (4 + 24 + 4 * nshadow) + nvalid * 44 + 4 * block_floats
    written = npix * (4 * (17 + nlights) + 4 + 1)
    return read + written


def resolve_unfused_case(dev, mesh, cam, seed) -> dict:
    """Phase 21's unfused frame: the hall at 1920x1080 with the 2 deg sun
    at spp 8, accumulation and fused_shadow=False, as the benchmark's
    unfused cell renders it (``app.resolves_unfused``). On one frame's
    closest attribute walk, its channels left in packets: the origins
    kernel against its plain version, bit for bit; the cone sampler on its
    block; the frame resolve (kind COUNTS) on the walk's channels and the
    sampler's counts against its plain version, every output bit for bit.
    Each kernel's ms beside its byte bound, then five graph frames under
    torch.profiler: one launch of each kernel a frame, and each one's
    device ms a frame in the trace."""
    import tpurt_torch.kernels.resolve as rs
    import tpurt_torch.kernels.traverse as tr
    from bench_torch.profile import profile_frames
    from tpurt_torch import app
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.passes.shadow import COUNTS, cone_cos
    from tpurt_torch.types import Light, RenderConfig
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, leaf_size=14, seed=seed,
                       spp=SPP, accumulate=True, fused_shadow=False)
    r = app.Renderer(mesh, cam, [Light.sun(SUN_DIR, angular_radius_deg=2.0)],
                     cfg, device=dev)
    if not app.resolves_unfused(r.route, r.config, r.accel, r.attr_tables,
                                r.mesh, r.lights):
        raise RuntimeError(f"resolve unfused: route {r.route} does not "
                           f"resolve")
    r.render_frame()
    consts = r._block.write(r.camera, r.lights, cfg,
                            app.frame_seed(cfg.seed, 7))
    acc = app._gb_accel(r.accel, consts.camera, cfg)
    o, d = generate_rays(consts.camera, cfg.width, cfg.height, r.device)
    closest = tr._fused_launch(tr.CLOSEST, tr.closest_attrs_inputs(
        acc, o, d, r.attr_tables), r.attr_tables, False)
    args = (closest, consts, r.mesh, o, d)
    block = rs.unfused_origins_cuda(*args)
    want, origins_plain_ms = host_ms(
        lambda: rs.unfused_origins_reference(*args))
    if not _same_bits(block, want):
        bad = int((block.view(torch.int32) != want.view(torch.int32)).sum())
        raise RuntimeError(f"resolve unfused: the origins kernel and its "
                           f"plain version differ in {bad} words")
    light = consts.lights[0]
    cnt, _ = tr.trace_any_soft(r.accel, None, None, light.direction,
                               cone_cos(light), cfg.spp, consts.seed,
                               packed=(block, closest.p, closest.meta))
    rargs = (dataclasses.replace(closest, shadow=(cnt,)), COUNTS, consts,
             cfg, r.mesh, o, d)
    got = rs.frame_resolve_cuda(*rargs)
    want, resolve_plain_ms = host_ms(lambda: rs.frame_resolve_reference(
        *rargs))
    bad = {k: int((got[k] != want[k]).sum()) for k in want
           if not _same_bits(got[k], want[k])}
    if bad or list(got) != list(want):
        raise RuntimeError(f"resolve unfused: kernel and plain differ in "
                           f"{bad}")
    npix, nvalid = MAIN_W * MAIN_H, int(want["valid"].sum())
    del got, want
    origins_ms = cuda_ms(lambda: rs.unfused_origins_cuda(*args), 20)
    resolve_ms = cuda_ms(lambda: rs.frame_resolve_cuda(*rargs), 20)
    origins_bytes = npix * ORIGINS_BYTES
    nbytes = resolve_bytes(npix, nvalid, 1, 1, consts.block.numel())
    for _ in range(3):          # the capture and two replays
        r.render_frame()
    before = {fn: fn.launches for fn in (rs.unfused_origins_cuda,
                                         rs.frame_resolve_cuda)}
    summary = profile_frames(r.render_frame, 5, dev)
    per_frame = {fn.__name__[:-len("_cuda")]: (fn.launches - n) / 5
                 for fn, n in before.items()}
    if per_frame != {"unfused_origins": 1, "frame_resolve": 1}:
        raise RuntimeError(f"resolve unfused: launches a frame {per_frame}")

    def trace_ms(name):
        return sum(t for k, t in summary.kernels if name in k) * 1e3 / 5
    res = dict(
        route=r.route, kind=COUNTS, valid_share=nvalid / npix,
        graph_replays=r.stats["graph_replays"],
        launches_per_frame=summary.launches / 5,
        busy_ms_per_frame=summary.busy_s * 1e3 / 5,
        origins=dict(ms=origins_ms, bound_ms=origins_bytes / HBM_RATE * 1e3,
                     bound_by="bytes", bytes=origins_bytes,
                     plain_ms=origins_plain_ms,
                     launches_per_frame=per_frame["unfused_origins"],
                     trace_ms_per_frame=trace_ms("unfused_origins_kernel")),
        resolve=dict(ms=resolve_ms, bound_ms=nbytes / HBM_RATE * 1e3,
                     bound_by="bytes", bytes=nbytes,
                     plain_ms=resolve_plain_ms,
                     launches_per_frame=per_frame["frame_resolve"],
                     trace_ms_per_frame=trace_ms("frame_resolve_kernel")))
    for k in ("origins", "resolve"):
        res[k]["roofline_pct"] = 100.0 * res[k]["bound_ms"] / res[k]["ms"]
    log(f"phase 21 resolve unfused_soft_spp8_1080p: {json.dumps(res)}")
    return res


def resolve_rows(resolve: dict, fused_launches: int,
                 unfused_launches: dict) -> list:
    """The kernel table's rows of the two resolve kernels, which replace
    tensor code and no TPU kernel: the frame resolve at phase 21's fused
    1080p sun and the origins kernel at its unfused frame, each with the
    launches of phase 4's or phase 8's six frames; both equal their plain
    versions bit for bit."""
    fused = resolve["sun_1080p"]
    origins = resolve["unfused_soft_spp8_1080p"]["origins"]
    return [{"name": name, "route": "cuda", "source": CSRC + src,
             "replaces": None, "launches": n, "max_abs_err": 0.0,
             "mismatch_share": 0.0, "ms": kp["ms"], "plain_ms": kp["plain_ms"],
             "bound_ms": kp["bound_ms"], "bound_by": kp["bound_by"],
             "library_ms": None}
            for name, src, n, kp in (
                ("frame_resolve", "resolve.cu", fused_launches, fused),
                ("unfused_origins", "unfused_origins.cu",
                 unfused_launches["unfused_origins"], origins))]


def phase_resolve(dev, mesh) -> dict:
    """Phase 21: the resolve kernel against its plain version, its ms
    beside its byte bound, and a graph frame's launches, per case."""
    import tpurt_torch.kernels.resolve as rs
    from bench_torch.profile import profile_frames
    from tpurt_torch.app import Renderer
    from tpurt_torch.scenes import sponza_interior_camera
    from tpurt_torch.types import Light, RenderConfig
    cam = sponza_interior_camera()
    seed = 2 ** 31 + 21_001
    cases = {
        "sun_1080p": ([Light.directional(SUN_DIR)], MAIN_W, MAIN_H, {},
                      "fused0"),
        "soft_spp8_1080p": ([Light.sun(SUN_DIR, angular_radius_deg=2.0)],
                            MAIN_W, MAIN_H, dict(spp=SPP, accumulate=True),
                            "fused0"),
        "three_suns_2160p": (config5_lights(), UHD_W, UHD_H, {}, "fusedN"),
    }
    res = {}
    for name, (lights, w, h, fields, route) in cases.items():
        cfg = RenderConfig(width=w, height=h, leaf_size=14, seed=seed,
                           **fields)
        r = Renderer(mesh, cam, lights, cfg, device=dev)
        if r.route != route:
            raise RuntimeError(f"resolve {name} takes route {r.route}")
        r.render_frame()
        launch, kind, consts, o, d = _resolve_launch(r)

        def kernel():
            return rs.frame_resolve_cuda(launch, kind, consts, cfg, r.mesh,
                                         o, d)
        got = kernel()
        want, plain_ms = host_ms(lambda: rs.frame_resolve_reference(
            launch, kind, consts, cfg, r.mesh, o, d))
        bad = {k: int((got[k] != want[k]).sum()) for k in want
               if not _same_bits(got[k], want[k])}
        if bad or list(got) != list(want):
            raise RuntimeError(f"resolve {name}: kernel and plain differ "
                               f"in {bad}")
        ms = cuda_ms(kernel, 20)
        npix, nvalid = w * h, int(want["valid"].sum())
        nbytes = resolve_bytes(npix, nvalid, len(launch.shadow), len(lights),
                               consts.block.numel())
        bound_ms = nbytes / HBM_RATE * 1e3
        del got, want
        for _ in range(3):          # the capture and two replays
            r.render_frame()
        before = rs.frame_resolve_cuda.launches
        summary = profile_frames(r.render_frame, 5, dev)
        trace_ms = sum(s for k, s in summary.kernels
                       if "frame_resolve_kernel" in k) * 1e3 / 5
        res[name] = dict(
            route=route, kind=kind, valid_share=nvalid / npix, ms=ms,
            bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
            roofline_pct=100.0 * bound_ms / ms, plain_ms=plain_ms,
            graph_replays=r.stats["graph_replays"],
            resolve_launches_per_frame=(rs.frame_resolve_cuda.launches
                                        - before) / 5,
            launches_per_frame=summary.launches / 5,
            resolve_trace_ms_per_frame=trace_ms,
            busy_ms_per_frame=summary.busy_s * 1e3 / 5)
        if res[name]["resolve_launches_per_frame"] != 1:
            raise RuntimeError(f"resolve {name}: {res[name]}")
        log(f"phase 21 resolve {name}: {json.dumps(res[name])}")
        del r, launch, consts, o, d
        torch.cuda.empty_cache()
    res["unfused_soft_spp8_1080p"] = resolve_unfused_case(dev, mesh, cam,
                                                          seed)
    torch.cuda.empty_cache()
    return res


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
    ptxas_psoft = {k: v for k, v in ptxas_report(BuildInfo.log).items()
                   if "psoft_kernel" in k}
    if len(ptxas_psoft) != 4:
        raise RuntimeError(f"ptxas reported {sorted(ptxas_psoft)}, want "
                           f"psoft_kernel<0, 1, 2> and any_psoft_kernel")
    log(f"phase 2 penumbra kernels (ptxas): {json.dumps(ptxas_psoft)}")
    ptxas_resolve = {k: v for k, v in ptxas_report(BuildInfo.log).items()
                     if "frame_resolve_kernel" in k
                     or "unfused_origins_kernel" in k}
    if len(ptxas_resolve) != 2:
        raise RuntimeError(f"ptxas reported {sorted(ptxas_resolve)}, want "
                           f"frame_resolve_kernel and unfused_origins_kernel")
    log(f"phase 2 resolve kernels (ptxas): {json.dumps(ptxas_resolve)}")

    if sys.argv[1:] == ["resolve"]:
        res = phase_resolve(dev, sponza_scene(MAIN_TRIS))
        log(json.dumps({"timings": {"card": card, "build_s": build_s,
                                    "ptxas_resolve": ptxas_resolve,
                                    "resolve": res}}))
        log(card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["frame_graph"]:
        mesh = sponza_scene(MAIN_TRIS)
        fg = phase_frame_graph(dev, mesh, textured_hall(mesh))
        log(json.dumps({"timings": {"card": card, "build_s": build_s,
                                    "frame_graph_1080p": fg}}))
        log(card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    t_start = time.perf_counter()
    small = phase_small(dev)
    small["psoft_spp"] = small_psoft_spp(dev)
    small.update(small_shade_table(dev))
    small.update(small_binary(dev))
    mesh = sponza_scene(MAIN_TRIS)
    c1 = phase_config1(dev, mesh)
    c3 = phase_config3(dev, mesh)
    c5 = phase_config5(dev, mesh)
    variants = phase_soft_variants(dev, mesh)
    phase4 = {k: c1.pop(k) for k in ("image", "valid", "renderer")}
    static_image = phase4["image"]
    unf = phase_unfused(dev, mesh, static_image)
    c2 = phase_config2(dev, mesh, static_image)
    area = {k: c2.pop(k) for k in ("image", "valid")}
    ras = phase_raster(dev, mesh, phase4)
    ras32 = ras.pop("renderer")
    stab = phase_shade_table(dev, mesh, phase4)
    binary = phase_binary(dev, mesh, phase4)
    tex = phase_textured(dev, mesh, phase4)
    textured = tex.pop("textured")
    fixed = phase_fixed_cut(dev, mesh, area)
    seeded = phase_seeded(dev, mesh)
    steered = phase_top_sah(dev, mesh)
    deferred = phase_deferred(dev, mesh, phase4, ras32, textured)
    w8t = phase_w8t(dev, mesh, phase4, textured["mesh"])
    var = phase_variants(dev, mesh, phase4["renderer"])
    fg = phase_frame_graph(dev, mesh, textured["mesh"])
    resolve = phase_resolve(dev, mesh)
    timings = {"card": card, "build_s": build_s,
               "ptxas_psoft": ptxas_psoft, "ptxas_resolve": ptxas_resolve,
               "phases_s": time.perf_counter() - t_start,
               "teapot_512": small, "config1_1080p": c1,
               "config3_1080p": c3, "config5_2160p": c5,
               "soft_variants_1080p": variants, "unfused_1080p": unf,
               "config2_1080p": c2, "raster_1080p": ras,
               "shade_table_1080p": {k: v for k, v in stab.items()
                                     if k not in ("kernels", "launches")},
               "binary_1080p": {k: v for k, v in binary.items()
                                if k != "kernels"},
               "textured_1080p": {k: v for k, v in tex.items()
                                  if k not in ("kernels", "launches")},
               "fixed_cut_1080p": fixed, "seeded_1080p": seeded,
               "top_sah_1080p": steered, "deferred_1080p": deferred,
               "w8t_1080p": {k: v for k, v in w8t.items()
                             if k != "kernels"},
               "variants_1080p": {"launches": var["launches"],
                                  "phase_s": var["phase_s"]},
               "frame_graph_1080p": fg, "resolve": resolve}
    rows = [kernel_row("closest_shadow", c1["launches"], c1["kernel"],
                       small),
            kernel_row("closest_multi_shadow", c5["launches"], c5["kernel"],
                       small),
            kernel_row("closest_soft_shadow", c3["launches"], c3["kernel"],
                       small)]
    rows += [kernel_row(name, v["launches"], v["kernel"], small)
             for name, v in variants.items()]
    for label, name in (("config1_unfused", "closest_attrs"),
                        ("config1_unfused", "any"),
                        ("config3_unfused", "any_soft"),
                        ("lamp_unfused", "any_point_soft")):
        rows.append(kernel_row(name, unf[label]["launches"][name],
                               unf[label]["kernels"][name], small))
    rows += [build_kernel_row(name, c2["launches"][name], kp)
             for name, kp in c2["kernels"].items()]
    rows += [kernel_row(name, stab["launches"][name], stab["kernels"][name],
                        small) for name in SHADE_TABLE_KERNELS]
    rows += [kernel_row(name, binary["ray_1080p"]["launches"][name],
                        binary["kernels"][name], small)
             for name in BINARY_KERNELS]
    kp = binary["morton_codes60"]
    rows.append({"name": "morton_codes60", "route": "cuda",
                 "source": CSRC + "build.cu", "replaces": f"{BUILD_TPU}410",
                 "launches": binary["build60_launches"]["morton_codes60"],
                 "max_abs_err": kp["max_abs_err"],
                 "mismatch_share": kp["mismatch_share"], "ms": kp["ms"],
                 "plain_ms": kp["plain_ms"], "bound_ms": kp["bound_ms"],
                 "bound_by": kp["bound_by"], "library_ms": None})
    rows += [kernel_row(name, tex["launches"][name], tex["kernels"][name],
                        small) for name in TEXTURED_KERNELS]
    rows.append(build_kernel_row("topology_depth",
                                 fixed["launches"]["topology_depth"],
                                 fixed["kernel"]))
    for name, replaces, n, kp in (
            ("rasterize_rows", RASTER_TPU, ras["launches"]["rasterize_rows"],
             ras["kernel"]),
            ("rasterize_rows16", RASTER16_TPU,
             deferred["launches"]["rasterize_rows16"], deferred["kernel"])):
        rows.append({"name": name, "route": "cuda",
                     "source": CSRC + "raster.cu", "replaces": replaces,
                     "launches": n, "max_abs_err": kp["max_abs_err"],
                     "mismatch_share": kp["mismatch_share"], "ms": kp["ms"],
                     "plain_ms": kp["plain_ms"], "bound_ms": kp["bound_ms"],
                     "bound_by": kp["bound_by"], "library_ms": None})
    rows.append(kernel_row("first_hit", seeded["launches"]["first_hit"],
                           seeded["kernel"], small))
    rows.append(build_kernel_row("sweep_sah_priorities", steered["launches"],
                                 steered["kernel"]))
    rows += [w8t_kernel_row(name, w8t["launches"][name], w8t["kernels"][name])
             for name in W8T_KERNELS]
    rows += variants_rows(var)
    rows += resolve_rows(resolve, c1["resolve_launches"],
                         unf["config3_unfused"]["launches"])
    log(json.dumps({"timings": timings}))
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
