"""The frame resolve: every output of a fused frame, from the fused walk
launch's packet outputs (``traverse.FusedLaunch``), in one step. It takes
the launch of an untextured (attrs=1) fused walk whose lights are all its
own, and writes the G-buffer (position, both normals turned toward the
viewer, albedo, depth, t, tri_id, valid), each light's visibility
(``shadow`` f32[L, H, W]) and the composited image, as the frame returns
them (``app.render_frame_fn``); ``view_dir`` is the rays' ``dirs``.

- ``frame_resolve_cuda``: the hand-written CUDA kernel (``csrc/resolve.cu``,
  ``frame_resolve_kernel``): one block per 32x32 tile, straight from the
  packets to the image planes, with no intermediate in device memory. It
  takes CUDA tensors only and launches or raises; ``.launches`` counts its
  launches, and a traced frame records that it wrote its outputs
  (``spans.resolve_frame``).
- ``frame_resolve_reference``: the same function in plain PyTorch: the
  tensor code of the fused frames, which the kernel replaces on the card
  and CPU frames run: the channels' unpacking (``traverse._attr_channels``),
  the decode (``passes/gbuffer.gbuf_from_attr_channels``), the visibility
  (``passes/shadow.fused_visibility``) and the composite
  (``passes/composite.composite_lights``).
- ``frame_resolve``: the wrapper the frame calls; it picks one of the two
  by the tensors' device.

Each takes (launch, kind, consts, cfg, mesh, origins, dirs): ``kind`` the
fused mode's shadow output (``passes/shadow.py``'s ``OCCLUDED``: HARD's
flag, ``COUNTS``: SOFT's or PSOFT's sample counts, ``MASK``: MULTI's mask,
``COUNTS_MASK``: SOFT_MULTI's counts and mask), ``consts`` the frame's
views of its block of constants (``frame_block.FrameViews``: the camera,
the lights, the background), ``cfg`` the config (``ambient``, ``spp``),
``mesh`` the untextured mesh, (origins, dirs) the image rays f32[H, W, 3]
that the launch packed; the kernel reads the rays from the launch's
block.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..frame_block import LIGHT_WORDS, LIGHTS
from ..passes.composite import composite_lights
from ..passes.gbuffer import gbuf_from_attr_channels
from ..passes.shadow import (COUNTS, COUNTS_MASK, MASK, OCCLUDED,
                             fused_visibility)
from ..spans import resolve_frame
from ..types import LIGHT_POINT
from ._build import _check, _pick, _stream
from .traverse import (ATTR_CH, MAX_MASK_LIGHTS, FusedLaunch, _attr_channels,
                       _require_cuda, _tile_shape, _unpack)

# The i32 blocks each kind of shadow output hands over.
_BLOCKS = {OCCLUDED: 1, COUNTS: 1, MASK: 1, COUNTS_MASK: 2}


class ResolveParams(ctypes.Structure):
    """csrc/resolve.cu ``ResolveParams``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "attrs", "rays", "shadow_a", "shadow_b", "block", "position",
        "normal", "gnormal", "albedo", "depth", "t", "tri_id", "valid",
        "shadow", "image")]
        + [(n, ctypes.c_int) for n in (
            "packets", "tiles_x", "height", "width", "shadow_kind",
            "n_lights", "point_mask", "spp")]
        + [("ambient", ctypes.c_float)])


def _check_lights(kind: int, n: int) -> None:
    if kind not in _BLOCKS:
        raise ValueError(f"shadow kind {kind}")
    most = {OCCLUDED: 1, COUNTS: 1, MASK: MAX_MASK_LIGHTS,
            COUNTS_MASK: MAX_MASK_LIGHTS + 1}[kind]
    if not 1 <= n <= most:
        raise ValueError(f"{n} lights; shadow kind {kind} takes 1..{most}")


def frame_resolve_cuda(launch: FusedLaunch, kind: int, consts, cfg, mesh,
                       origins, dirs) -> Dict[str, torch.Tensor]:
    """The resolve kernel (one launch on the current stream). Raises on a
    textured mesh, a launch of flat rays, and any input whose device,
    dtype, shape or layout the kernel does not take."""
    from ._build import load_library
    if mesh.textured:
        raise ValueError("the resolve kernel takes an untextured mesh; a "
                         "textured one samples its albedo after the decode")
    kind_, h, w = launch.meta
    if kind_ != "img":
        raise ValueError("the resolve kernel takes image rays")
    dev = launch.attrs.device
    _require_cuda(dev)
    ht, wt = _tile_shape(h, w)
    if launch.p != ht * wt:
        raise ValueError(f"{launch.p} packets for a {h}x{w} image")
    lights = consts.lights
    _check_lights(kind, len(lights))
    pb = launch.attrs.shape[0]
    _check(launch.attrs, "attrs", torch.float32, (pb, ATTR_CH, 8, 128), dev)
    _check(launch.rays, "rays", torch.float32, (pb, 10, 8, 128), dev)
    if len(launch.shadow) != _BLOCKS[kind]:
        raise ValueError(f"{len(launch.shadow)} shadow blocks; shadow kind "
                         f"{kind} takes {_BLOCKS[kind]}")
    for i, b in enumerate(launch.shadow):
        _check(b, f"shadow[{i}]", torch.int32, (pb, 8, 128), dev)
    _check(consts.block, "block", torch.float32,
           (LIGHTS + LIGHT_WORDS * len(lights),), dev)

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    out = {"image": new(h, w, 3), "shadow": new(len(lights), h, w),
           "position": new(h, w, 3), "normal": new(h, w, 3),
           "gnormal": new(h, w, 3), "albedo": new(h, w, 3),
           "depth": new(h, w), "t": new(h, w),
           "tri_id": new(h, w, dtype=torch.int32),
           "valid": new(h, w, dtype=torch.bool)}
    shadow_b = launch.shadow[1] if kind == COUNTS_MASK else launch.shadow[0]
    params = ResolveParams(
        attrs=launch.attrs.data_ptr(), rays=launch.rays.data_ptr(),
        shadow_a=launch.shadow[0].data_ptr(), shadow_b=shadow_b.data_ptr(),
        block=consts.block.data_ptr(),
        **{k: v.data_ptr() for k, v in out.items()},
        packets=launch.p, tiles_x=wt, height=h, width=w, shadow_kind=kind,
        n_lights=len(lights),
        point_mask=sum(1 << i for i, light in enumerate(lights)
                       if light.kind == LIGHT_POINT),
        spp=int(cfg.spp), ambient=float(cfg.ambient))
    err = load_library().tpurt_frame_resolve_launch(ctypes.byref(params),
                                                    _stream(dev))
    if err != 0:
        raise RuntimeError(f"tpurt_frame_resolve_launch failed: CUDA error "
                           f"{err}")
    frame_resolve_cuda.launches += 1
    resolve_frame()
    return {**out, "view_dir": dirs}


frame_resolve_cuda.launches = 0


def frame_resolve_reference(launch: FusedLaunch, kind: int, consts, cfg,
                            mesh, origins, dirs) -> Dict[str, torch.Tensor]:
    """The plain version: the fused frames' tensor code after the launch."""
    lights = consts.lights
    _check_lights(kind, len(lights))
    p, meta = launch.p, launch.meta
    gbuf = gbuf_from_attr_channels(_attr_channels(launch.attrs, p, meta),
                                   origins, dirs, consts.camera, mesh)
    shadows = fused_visibility(
        kind, gbuf["valid"], [_unpack(b[:p], meta) for b in launch.shadow],
        len(lights), cfg.spp)
    image = composite_lights(gbuf, shadows, lights, cfg, consts.background)
    return {"image": image, "shadow": torch.stack(shadows), **gbuf}


def frame_resolve(launch: FusedLaunch, kind: int, consts, cfg, mesh, origins,
                  dirs) -> Dict[str, torch.Tensor]:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    fn = _pick(launch.attrs.device, frame_resolve_cuda,
               frame_resolve_reference)
    return fn(launch, kind, consts, cfg, mesh, origins, dirs)
