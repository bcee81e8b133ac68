"""Counter-based random numbers and the sampling helpers of the in-kernel
soft-shadow loops (counterpart of ``tpurt/kernels/traverse.py``
``_uniform01`` :749, ``_sincos_2pi`` :734, ``_lane_axis_onb`` :758 and
``_onb3`` :2579).

The TPU kernels draw from the chip's hardware PRNG, whose bits cannot be
reproduced here. The port uses Philox4x32-10 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011), written once in CUDA
(``csrc/walk.cuh``) and once here in integer-only PyTorch; both give the
same bits:

- key   = (seed, light index);
- counter = (ray index in the packed block, sample index, 0, 0);
- u1, u2 = words 0 and 1 of the output, each mapped onto [0, 1) as
  ``_uniform01`` does: ``(bits >> 9) | 0x3F800000`` as a float, minus 1.

So a sample depends only on (seed, light, ray, sample), never on how
threads map to rays. ``zero_stream=True`` gives u1 = u2 = 0 for every
sample, the stream of the JAX package's interpret mode; it exists so the
kernels can be held against ``tpurt`` on the CPU, and is no render option.

The float helpers evaluate in a fixed order with no fused multiply-add
(the CUDA side is built with ``--fmad=false``), so the kernel and the
plain version agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * m for int64 tensors a in [0, 2^32)
    and a 32-bit constant m. m is split in 16-bit halves so that every
    partial product stays below 2^48."""
    mh, ml = m >> 16, m & 0xFFFF
    pl = a * ml
    ph = a * mh
    hi = (ph + (pl >> 16)) >> 16
    lo = (((ph & 0xFFFF) << 16) + pl) & MASK32
    return hi, lo


def seed_arg(seed):
    """A generator key word as the walks pass it on: a one-element int32
    tensor holding its 32 bits (the frame block's seed,
    ``frame_block.FrameBlock``) as it is, any other value as an int in
    [0, 2^32)."""
    if isinstance(seed, torch.Tensor):
        return seed
    return int(seed) & MASK32


def _key_word(k):
    """An int key word, or a one-element int32 tensor's 32 bits as an
    int64 scalar tensor, in [0, 2^32)."""
    if isinstance(k, torch.Tensor):
        return k.to(torch.int64).reshape(()) & MASK32
    return k & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 words -> 4 words.
    Each key word an int or a one-element int32 tensor (``_key_word``)."""
    k0 = _key_word(k0)
    k1 = _key_word(k1)
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """23 random mantissa bits onto [1, 2), minus 1 -> f32 in [0, 1)."""
    m = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return m.view(torch.float32) - 1.0


def sample_uniforms(seed, light: int, ray_index: torch.Tensor,
                    sample: int, zero_stream: bool = False):
    """(u1, u2) f32 for each ray index (an integer tensor) at one sample;
    ``seed`` an int or the frame block's seed (``seed_arg``)."""
    if zero_stream:
        z = torch.zeros(ray_index.shape, dtype=torch.float32,
                        device=ray_index.device)
        return z, z
    c0 = ray_index.to(torch.int64) & MASK32
    c1 = torch.full_like(c0, sample & MASK32)
    zero = torch.zeros_like(c0)
    w0, w1, _, _ = philox4x32(c0, c1, zero, zero, seed, light)
    return bits_to_uniform(w0), bits_to_uniform(w1)


def sincos_2pi(t: torch.Tensor):
    """(sin, cos) of 2*pi*(t - 0.5) for t in [0, 1): the JAX kernels'
    degree-7/6 Taylor polynomial on the half angle plus the double-angle
    step, in the same order (no trig call, so the CUDA and plain versions
    agree bit for bit)."""
    psi = 3.14159265 * (t - 0.5)
    p2 = psi * psi
    s1 = psi * (1.0 + p2 * (-1.0 / 6.0 + p2 * (1.0 / 120.0
                                               + p2 * (-1.0 / 5040.0))))
    c1 = 1.0 + p2 * (-0.5 + p2 * (1.0 / 24.0 + p2 * (-1.0 / 720.0)))
    return 2.0 * s1 * c1, 1.0 - 2.0 * s1 * s1


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x), both correctly rounded (the CUDA side's 1.0f/sqrtf)."""
    return 1.0 / torch.sqrt(x)


def lane_axis_onb(ex0, ey0, ez0):
    """Per-ray unit axis of (ex0, ey0, ez0) and a branchless Duff
    orthonormal basis around it -> (t0x, t0y, t0z, t1x, t1y, t1z)."""
    arn = rsqrt(torch.clamp(ex0 * ex0 + ey0 * ey0 + ez0 * ez0, min=1e-24))
    ax = ex0 * arn
    ay = ey0 * arn
    az = ez0 * arn
    sgn = torch.where(az >= 0.0, 1.0, -1.0)
    aa = -1.0 / (sgn + az)
    bb = ax * ay * aa
    return (1.0 + sgn * ax * ax * aa, sgn * bb, -sgn * ax,
            bb, sgn + ay * ay * aa, -ay)


def onb3(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Duff basis (t0, t1) of one f32[3] unit vector, for kernel scalars."""
    s = torch.where(d[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + d[2])
    b = d[0] * d[1] * a
    t0 = torch.stack([1.0 + s * d[0] * d[0] * a, s * b, -s * d[0]])
    t1 = torch.stack([b, s + d[1] * d[1] * a, -d[1]])
    return t0, t1
