"""30-bit Morton (Z-order) codes (counterpart of ``tpurt/bvh/morton.py``).

Codes are held as int32: 30 bits fit without touching the sign bit, so
shifts, ands and ors give the JAX package's uint32 values bit for bit,
and comparisons and sorts order them the same way. The 60-bit two-word
keys (``morton_bits=60``) are not ported.
"""

from __future__ import annotations

import torch


def expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each lane so consecutive bits land 3
    apart (the magic-number dilation)."""
    v = v.to(torch.int32) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_encode(q: torch.Tensor) -> torch.Tensor:
    """q: int[..., 3] with components in [0, 1023] -> i32[...] codes,
    code = (ex << 2) | (ey << 1) | ez."""
    return (expand_bits_10(q[..., 0]) << 2) | (expand_bits_10(q[..., 1]) << 1) \
        | expand_bits_10(q[..., 2])


def unit_coords(p: torch.Tensor, scene_min, scene_max) -> torch.Tensor:
    """Points -> the scene box's unit cube, (p - min) / max(max - min,
    1e-12), as ``quantize_points`` and ``morton_codes_pallas`` take it."""
    extent = torch.clamp(scene_max - scene_min, min=1e-12)
    return (p - scene_min) / extent


def quantize_unit(unit: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Unit-cube coordinates -> the [0, 2^bits - 1] integer lattice: clip
    of unit * 2^bits, truncated."""
    grid = float((1 << bits) - 1)
    return torch.clamp(unit * (grid + 1.0), 0.0, grid).to(torch.int32)


def quantize_points(p: torch.Tensor, scene_min, scene_max,
                    bits: int = 10) -> torch.Tensor:
    """Map points into the [0, 2^bits - 1] integer lattice of the scene
    box."""
    return quantize_unit(unit_coords(p, scene_min, scene_max), bits)


def morton_of_points(p: torch.Tensor, scene_min, scene_max) -> torch.Tensor:
    """World-space points f32[n, 3] -> i32[n] 30-bit Morton codes."""
    return morton_encode(quantize_points(p, scene_min, scene_max))
