"""Carry the JAX package's state across to the port.

Each function takes the fields of a ``tpurt`` object as numpy arrays (see
``numpy_fields``) and returns the port's type, so a test can feed the SAME
accel to both packages and hold the kernel apart from the build. Nothing
here imports ``tpurt``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .bvh.lbvh import LBVH
from .bvh.wide import WideBVH
from .raster.setup import RasterRows
from .types import Camera, Light, Mesh


def numpy_fields(obj) -> Dict[str, Any]:
    """Fields of a dataclass instance: arrays as numpy, ints and None as
    they are."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v if v is None or isinstance(v, int) else np.asarray(v)
    return out


def _t(a, dtype, device) -> torch.Tensor:
    # np.array copies: arrays from jax are read-only.
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _opt(a, dtype, device):
    return None if a is None else _t(a, dtype, device)


def lbvh(fields: Dict[str, Any], device) -> LBVH:
    """A ``tpurt`` LBVH; ``nodes_box`` may be None (a deferred-box build)
    and the sub-leaf clustering fields are carried when present."""
    f32, i32 = torch.float32, torch.int32
    return LBVH(
        nodes_box=_opt(fields["nodes_box"], f32, device),
        nodes_child=_t(fields["nodes_child"], i32, device),
        nodes_first=_t(fields["nodes_first"], i32, device),
        nodes_last=_t(fields["nodes_last"], i32, device),
        tri_v0=_t(fields["tri_v0"], f32, device),
        tri_e1=_t(fields["tri_e1"], f32, device),
        tri_e2=_t(fields["tri_e2"], f32, device),
        tri_sorted=_t(fields["tri_sorted"], i32, device),
        tri_id=_t(fields["tri_id"], i32, device),
        root_min=_t(fields["root_min"], f32, device),
        root_max=_t(fields["root_max"], f32, device),
        leaf_size=int(fields["leaf_size"]),
        leaf_block=_opt(fields.get("leaf_block"), i32, device),
        leaf_min=_opt(fields.get("leaf_min"), f32, device),
        leaf_max=_opt(fields.get("leaf_max"), f32, device))


def wide_bvh(fields: Dict[str, Any], device) -> WideBVH:
    f32 = torch.float32
    return WideBVH(nodes=_t(fields["nodes"], f32, device),
                   tris=_t(fields["tris"], f32, device),
                   tri_id=_t(fields["tri_id"], torch.int32, device),
                   root_min=_t(fields["root_min"], f32, device),
                   root_max=_t(fields["root_max"], f32, device),
                   num_wide=int(fields["num_wide"]),
                   leaf_size=int(fields["leaf_size"]))


def attr_tables(at0, at1, device):
    return (_t(at0, torch.float32, device), _t(at1, torch.float32, device))


def raster_rows(fields: Dict[str, Any], device) -> RasterRows:
    """A ``tpurt`` ``RasterRows`` (a NamedTuple: pass ``bins._asdict()``),
    so the rasterizer can run on the JAX package's own bins."""
    f32, i32 = torch.float32, torch.int32
    return RasterRows(
        pair_rows=_t(fields["pair_rows"], f32, device),
        row_starts=_t(fields["row_starts"], i32, device),
        row_counts=_t(fields["row_counts"], i32, device),
        big_rows=_t(fields["big_rows"], f32, device),
        big_nrows=_t(fields["big_nrows"], i32, device),
        overflow=_t(fields["overflow"], torch.bool, device))


def mesh(fields: Dict[str, Any]) -> Mesh:
    return Mesh(vertices=np.asarray(fields["vertices"], np.float32),
                normals=np.asarray(fields["normals"], np.float32),
                indices=np.asarray(fields["indices"], np.int32),
                albedo=np.asarray(fields["albedo"], np.float32),
                uv=fields.get("uv"), tex_atlas=fields.get("tex_atlas"),
                tri_tex=fields.get("tri_tex"))


def camera(fields: Dict[str, Any]) -> Camera:
    return Camera(**{k: np.asarray(fields[k], np.float32)
                     for k in ("position", "target", "up", "fov_y", "znear",
                               "zfar")})


def light(fields: Dict[str, Any]) -> Light:
    arrays = {k: np.asarray(fields[k], np.float32)
              for k in ("direction", "position", "color", "intensity",
                        "angular_radius", "radius")}
    return Light(kind=int(fields["kind"]), **arrays)
