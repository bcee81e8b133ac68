"""30-bit Morton (Z-order) codes and the 60-bit two-word keys (counterpart
of ``tpurt/bvh/morton.py``).

Codes are held as int32: 30 bits fit without touching the sign bit, so
shifts, ands and ors give the JAX package's uint32 values bit for bit,
and comparisons and sorts order them the same way. A 60-bit key is two
such words, hi (the coarse 10 bits per axis) and lo (the next 10).
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


def morton_of_points_60(p: torch.Tensor, scene_min, scene_max):
    """World-space points f32[n, 3] -> 60-bit Morton keys as two i32[n]
    words (hi, lo): the points on the 2^20 lattice of the scene box, hi
    the interleave of each coordinate's top 10 bits, lo of its low 10."""
    q = quantize_points(p, scene_min, scene_max, bits=20)
    return morton_encode(q >> 10), morton_encode(q & 0x3FF)
