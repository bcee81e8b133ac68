"""Combine pass (counterpart of ``tpurt/passes/composite.py``):
``color = albedo * (N.L * falloff * shadow * radiance + ambient)``, sky
pixels take the background."""

from __future__ import annotations

from typing import Dict

import torch

from ..camera import as_f32
from ..types import LIGHT_POINT, Light


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def composite_pass(gbuf: Dict[str, torch.Tensor], shadow: torch.Tensor,
                   light: Light, ambient: float,
                   background: tuple) -> torch.Tensor:
    """-> linear-space f32[H, W, 3] image."""
    n = gbuf["normal"]
    dev = n.device
    if light.kind == LIGHT_POINT:
        delta = as_f32(light.position, dev) - gbuf["position"]
        dist2 = torch.clamp(_dot3(delta, delta), min=1e-8)
        ldir = delta / torch.sqrt(dist2)[..., None]
        falloff = 1.0 / dist2
    else:
        ldir = as_f32(light.direction, dev).expand(n.shape)
        falloff = torch.ones(n.shape[:-1], dtype=n.dtype, device=dev)
    ndl = torch.clamp(_dot3(n, ldir), min=0.0)
    radiance = as_f32(light.color, dev) * as_f32(light.intensity, dev)
    direct = (ndl * falloff * shadow)[..., None] * radiance
    color = gbuf["albedo"] * (direct + ambient)
    bg = torch.as_tensor(background, dtype=color.dtype, device=dev)
    return torch.where(gbuf["valid"][..., None], color, bg)


def accumulate(prev: torch.Tensor, frame_index: int,
               new: torch.Tensor) -> torch.Tensor:
    """Temporal accumulation: running mean over frames (``prev`` is the
    mean of ``frame_index`` frames)."""
    fi = float(frame_index)
    return (prev * fi + new) / (fi + 1.0)
