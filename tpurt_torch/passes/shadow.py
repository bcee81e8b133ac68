"""Shadow pass: per-pixel shadow rays from the G-buffer toward one light
(counterpart of ``tpurt/passes/shadow.py``), for every light that no fused
kernel takes.

A hard light (directional at any spp; point or cone at spp 1) builds one
ray per pixel with ``shadow_ray_batch`` and traces it with the any-hit
kernel. A cone or point light at spp > 1 hands the biased origins to the
in-kernel samplers (``kernels/traverse.trace_any_soft`` and
``trace_any_point_soft``), keyed by (frame seed, light index). ``tpurt``'s
scan over ``jax.random`` samples needs the portable traversal, which is
not ported: without a soft tracer a soft light raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..camera import as_f32, normalize
from ..types import LIGHT_AREA_CONE, LIGHT_POINT, Light

_BIG = 3.4e38


def cone_cos(light: Light) -> float:
    """cos of an area light's angular radius, rounded as numpy rounds it."""
    return float(np.cos(np.float32(light.angular_radius)))


def _onb(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis around the unit vectors n[..., 3]
    (Duff et al. 2017)."""
    s = torch.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t0 = torch.cat([1.0 + s * n[..., 0:1] ** 2 * a, s * b, -s * n[..., 0:1]],
                   dim=-1)
    t1 = torch.cat([b, s + n[..., 1:2] ** 2 * a, -n[..., 1:2]], dim=-1)
    return t0, t1


def sample_cone(d: torch.Tensor, half_angle, u: torch.Tensor) -> torch.Tensor:
    """Uniform directions in a cone of the given half-angle (a host
    scalar) around the unit axes d[..., 3]; u[..., 2] uniforms in
    [0, 1)."""
    # cos of the half-angle on the host, correctly rounded as numpy and
    # XLA round it (torch's float32 cos is an ulp off at 4 deg, and
    # sqrt(1 - cos_t^2) magnifies that near the axis).
    cos_half = as_f32(np.cos(np.asarray(half_angle, np.float32)), d.device)
    cos_t = 1.0 - u[..., 0] * (1.0 - cos_half)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * np.pi * u[..., 1]
    t0, t1 = _onb(d)
    return normalize(d * cos_t[..., None]
                     + t0 * (sin_t * torch.cos(phi))[..., None]
                     + t1 * (sin_t * torch.sin(phi))[..., None])


def scene_exit_t(origins: torch.Tensor, dirs: torch.Tensor,
                 bounds) -> torch.Tensor:
    """Distance at which each ray leaves the scene box (bmin, bmax), x
    (1 + 1e-4) and at least 0: the t cap of a directional shadow ray, past
    which no occluder exists."""
    bmin, bmax = (as_f32(b, origins.device) for b in bounds)
    inv = torch.clamp(1.0 / dirs, -_BIG, _BIG)
    t0 = (bmin - origins) * inv
    t1 = (bmax - origins) * inv
    exit_t = torch.maximum(t0, t1).amin(dim=-1)
    return torch.clamp(exit_t * (1.0 + 1e-4), min=0.0)


def _length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def shadow_ray_batch(gbuf: Dict[str, torch.Tensor], light: Light,
                     bias: float, u: Optional[torch.Tensor],
                     scene_bounds=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shadow ray per pixel for one sample -> (origins, dirs, t_max).

    u: [H, W, 2] uniforms for the soft jitter, or None for the hard ray.
    Origins are the positions pushed by ``bias`` along the viewer-facing
    geometric normal. Invalid pixels get t_max = 0, which the walk skips.
    A point light's t_max is its distance x (1 - 1e-4); a directional (or
    cone) light's is the scene-box exit when ``scene_bounds`` is given."""
    pos = gbuf["position"]
    dev = pos.device
    valid = gbuf["valid"]
    origins = pos + gbuf["gnormal"] * bias
    if light.kind == LIGHT_POINT:
        lp = as_f32(light.position, dev)
        delta = lp - origins
        dist = _length(delta)
        dirs = delta / torch.clamp(dist[..., None], min=1e-12)
        if u is not None:
            # A jittered point of a disk of light.radius facing the pixel.
            t0, t1 = _onb(dirs)
            r = torch.sqrt(u[..., 0]) * as_f32(light.radius, dev)
            phi = 2.0 * np.pi * u[..., 1]
            target = (lp + t0 * (r * torch.cos(phi))[..., None]
                      + t1 * (r * torch.sin(phi))[..., None])
            delta = target - origins
            dist = _length(delta)
            dirs = delta / torch.clamp(dist[..., None], min=1e-12)
        t_max = torch.where(valid, dist * (1.0 - 1e-4), 0.0)
    else:
        d = as_f32(light.direction, dev).expand(origins.shape)
        if light.kind == LIGHT_AREA_CONE and u is not None:
            d = sample_cone(d, light.angular_radius, u)
        dirs = d.contiguous()
        far = scene_exit_t(origins, dirs, scene_bounds) \
            if scene_bounds is not None else torch.full_like(pos[..., 0],
                                                               _BIG)
        t_max = torch.where(valid, far, 0.0)
    return origins, dirs, t_max


def shadow_pass(trace_any: Callable, gbuf: Dict[str, torch.Tensor],
                light: Light, spp: int, seed: int, light_index: int,
                bias: float, scene_bounds=None,
                trace_soft: Optional[Callable] = None,
                trace_soft_point: Optional[Callable] = None):
    """Shadow visibility in [0, 1] per pixel (1 = fully lit) -> (visibility
    f32[H, W], walk counts i32[2]).

    trace_any(origins, dirs, t_max) -> (occluded, walk counts).
    trace_soft(origins, valid, axis_dir, cone_cos, spp, seed, light) and
    trace_soft_point(origins, valid, light_pos, radius, spp, seed, light)
    -> (counts in [0, spp], walk counts): the in-kernel samplers for cone
    and point lights at spp > 1, keyed by (seed, light_index)."""
    valid = gbuf["valid"]
    soft = light.kind in (LIGHT_AREA_CONE, LIGHT_POINT) and spp > 1
    if not soft:
        origins, dirs, t_max = shadow_ray_batch(gbuf, light, bias, None,
                                                scene_bounds=scene_bounds)
        occluded, counts = trace_any(origins, dirs, t_max)
        return torch.where(valid, torch.where(occluded, 0.0, 1.0),
                           1.0), counts
    origins = gbuf["position"] + gbuf["gnormal"] * bias
    if light.kind == LIGHT_AREA_CONE and trace_soft is not None:
        cnt, counts = trace_soft(origins, valid, light.direction,
                                 cone_cos(light), spp, seed, light_index)
    elif light.kind == LIGHT_POINT and trace_soft_point is not None:
        cnt, counts = trace_soft_point(origins, valid, light.position,
                                       float(light.radius), spp, seed,
                                       light_index)
    else:
        raise NotImplementedError(
            "soft shadows without an in-kernel sampler (tpurt's scan over "
            "jax.random samples through the portable traversal) are not "
            "ported")
    vis = 1.0 - cnt.to(torch.float32) / spp
    return torch.where(valid, vis, 1.0), counts
