"""Camera ray generation and view math (counterpart of ``tpurt/camera.py``).

Camera fields may be numpy arrays or tensors; each function casts them to
float32 tensors on the device it is given.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .types import Camera


def as_f32(x, device) -> torch.Tensor:
    """A numpy array, scalar or tensor as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """v / |v| over the last axis (size 3), summed in component order."""
    ss = v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2] \
        + v[..., 2:3] * v[..., 2:3]
    return v / torch.sqrt(ss + eps)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def camera_basis(cam: Camera, device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Right-handed orthonormal basis (right, up, forward); forward points
    from the eye toward the target."""
    pos = as_f32(cam.position, device)
    forward = normalize(as_f32(cam.target, device) - pos)
    right = normalize(_cross(forward, as_f32(cam.up, device)))
    up = _cross(right, forward)
    return right, up, forward


def generate_rays(cam: Camera, width: int, height: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays through every pixel center -> (origins f32[H, W, 3],
    unit directions f32[H, W, 3]); pixel (0, 0) is the top-left corner."""
    right, up, forward = camera_basis(cam, device)
    aspect = width / height
    tan_half = torch.tan(as_f32(cam.fov_y, device) * 0.5)
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    ndc_x = ((xx + 0.5) / width) * 2.0 - 1.0
    ndc_y = 1.0 - ((yy + 0.5) / height) * 2.0
    ndc_x = ndc_x.expand(height, width)
    ndc_y = ndc_y.expand(height, width)
    d = (ndc_x[..., None] * (tan_half * aspect) * right
         + ndc_y[..., None] * tan_half * up
         + forward)
    directions = normalize(d)
    origins = as_f32(cam.position, device).expand(height, width, 3)
    return origins.contiguous(), directions.contiguous()


def view_depth(cam: Camera, positions: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Camera-space depth along the forward axis; invalid pixels get zfar."""
    device = positions.device
    _, _, forward = camera_basis(cam, device)
    rel = positions - as_f32(cam.position, device)
    d = rel[..., 0] * forward[0] + rel[..., 1] * forward[1] \
        + rel[..., 2] * forward[2]
    return torch.where(valid, d, as_f32(cam.zfar, device))
