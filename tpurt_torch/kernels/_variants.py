"""The per-packet stats walk (counterpart of ``tpurt/kernels/_variants.py``
``trace_any_pallas_stats`` -> ``_any_hit_kernel_w8_stats``): the any hit
of given rays over a WideBVH plus, per 1024-ray packet, the iterations of
the packet's shared walk, the observable behind ``tpurt``'s traversal
cost model (pops x cost per pop = trace time).

A packet is laid out as ``tpurt``'s ``_ray_packets`` lays it out: a 32x32
pixel tile of an image, or a run of 1024 rays of a flat set padded with
inactive rays (``traverse._ray_packets``). Its walk is the union of its
rays' walks, one node per iteration, which a per-ray walk cannot count,
so the kernel walks a packet with one block (ROADMAP decision 22):

- the root is pushed; the walk runs only if some ray of the packet is
  active (t_max > t_min), so an all-inactive packet reports 0;
- each iteration pops the top node and slab-tests its eight child boxes
  for the rays that are live at its start (active and not yet occluded);
  a slot counts for the packet when some live ray hits it and its box
  has min x <= max x;
- for the counted slots in slot order 0..7 a leaf is tested for every
  active ray (not only those that hit its box), and an internal child is
  pushed, so the highest slot pops first;
- after the body of every 4th iteration (``it & 3 == 3``) the packet
  checks whether any ray is still live and stops if none is;
- the walk stops when the stack is empty or at the iteration cap
  ``2*num_wide + 64``; pushes past the 256-entry stack are dropped and
  counted (decision 4), and a walk cut at the cap with live rays counts
  as capped.

The slab test is ``(b - o) * inv`` with the clamped inverse direction,
which has no product to contract, so the votes and ``iters`` are exact;
only a triangle test can round otherwise (decision 2). ``tpurt``'s
``_any_hit_kernel_w8_x2`` (the dual pop) and the packet-frustum walks
``_any_hit_kernel_v2`` and ``_closest_hit_kernel_v2`` compute the
per-ray walks' results and are routed to modes ANY, BIN_ANY and
BIN_CLOSEST by ``traverse.trace_any`` and ``trace_closest``'s
``variant=`` (decision 23).

Three pieces, as in ``kernels/traverse.py``:

- ``any_stats_cuda``: the hand-written CUDA kernel (``csrc/variants.cu``,
  one 1024-thread block per packet, the stack in shared memory). It
  takes CUDA tensors only and launches or raises; ``.launches`` counts
  its launches.
- ``any_stats_reference``: the same walk in plain PyTorch, every packet
  in lockstep with its own stack. The wrapper takes it only for CPU
  tensors.
- ``trace_any_stats``: the wrapper.
"""

from __future__ import annotations

import torch

from ..bvh.wide import WideBVH
from ._build import _pick
from .traverse import (_BIG, LANES, STACK_CAPACITY, _count, _launch,
                       _leaf_occluders, _leaf_tris, _ray_packets_packed,
                       _slab, _unpack, iter_cap)

# The packet checks whether any ray is still live after the body of every
# LIVENESS_PERIOD-th iteration (tpurt's 2**W8_EXIT_LOG).
LIVENESS_PERIOD = 4
_VARIANTS = "tpurt_variants_launch"
# csrc/variants.cu ``Mode``.
ANY_STATS = 0


def _lanes(x, lanes: int):
    """f32[n, ...] -> f32[n * lanes, ...]: each packet's row repeated for
    its every lane, so a per-ray test of ``traverse`` takes all lanes."""
    return x[:, None].expand(x.shape[0], lanes, *x.shape[1:]).reshape(
        -1, *x.shape[1:])


def _lane_slab(rec, o, inv, t_min, cap):
    """``traverse._slab`` of every lane of n packets against the 8 child
    boxes of each packet's popped row: rec f32[n, 8, 16], o/inv tuples
    and cap of f32[n, L] -> bool[n, L, 8]."""
    n, lanes = cap.shape
    hit = _slab(_lanes(rec[:, :, :6], lanes),
                tuple(c.reshape(-1) for c in o),
                tuple(c.reshape(-1) for c in inv), t_min, cap.reshape(-1))
    return hit.reshape(n, lanes, 8)


def _lane_occluders(tri, o, d, t_min, tmax):
    """``traverse._leaf_occluders`` of every lane of m packets against the
    k triangles of each packet's leaf: tri nine f32[m, k] fields, o/d
    tuples and tmax of f32[m, L] -> bool[m, L, k]."""
    m, lanes = tmax.shape
    ok = _leaf_occluders([_lanes(f, lanes) for f in tri],
                         tuple(c.reshape(-1) for c in o),
                         tuple(c.reshape(-1) for c in d), t_min,
                         tmax.reshape(-1))
    return ok.reshape(m, lanes, -1)


def any_stats_reference(rays, nodes, tris, *, leaf_size: int, t_min: float,
                        max_iters: int, stack_size: int, stats=None):
    """Plain version of the stats walk: rays f32[PB, 10, 8, 128] ->
    (occlusion i32[PB, 8, 128], iterations i32[PB, 8, 128] (each packet's
    count on its every lane, as ``tpurt``'s kernel writes it), walk counts
    i32[2]: pushes dropped on a full stack, packets cut at the cap).
    ``stats`` counts the work the kernel does, in ``traverse._count``'s
    terms: "pops" and "slab_tests" for the rays live at the start of
    each iteration (the others skip the slab tests), "anyhit_tris" and
    "anyhit_leaf_tris" for the rays that test a leaf (active and not yet
    occluded). "simd_pops", "simd_slab_tests" and "simd_tris" count the
    same tests over every lane of each packet, the work of tpurt's SIMD
    kernel."""
    k = int(leaf_size)
    pb = rays.shape[0]
    dev = rays.device
    r = rays.reshape(pb, 10, LANES)
    o, d, inv = ((r[:, c], r[:, c + 1], r[:, c + 2]) for c in (0, 3, 6))
    tmax = r[:, 9]
    active0 = tmax > t_min
    occ = torch.zeros((pb, LANES), dtype=torch.bool, device=dev)
    stack = torch.zeros((pb, stack_size), dtype=torch.int32, device=dev)
    sp = torch.ones(pb, dtype=torch.int64, device=dev)
    it = torch.zeros(pb, dtype=torch.int32, device=dev)
    alive = active0.any(dim=1)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    while True:
        rows = torch.nonzero((sp > 0) & (it < max_iters) & alive)[:, 0]
        if rows.numel() == 0:
            break
        sp[rows] -= 1
        rec = nodes[stack[rows, sp[rows]].long()].reshape(-1, 8, 16)
        lanes = active0[rows] & ~occ[rows]
        cap = torch.where(lanes, tmax[rows], -_BIG)
        hit = _lane_slab(rec, tuple(c[rows] for c in o),
                         tuple(c[rows] for c in inv), t_min, cap)
        valid = rec[:, :, 0] <= rec[:, :, 3]
        anyhit = (hit & lanes[:, :, None]).any(dim=1) & valid
        refs = rec[:, :, 6].to(torch.int32)
        if stats is not None:
            nlive = lanes.sum(dim=1)
            _count(stats, "pops", nlive.sum())
            _count(stats, "slab_tests", (valid.sum(dim=1) * nlive).sum())
            _count(stats, "simd_pops", rows.numel() * LANES)
            _count(stats, "simd_slab_tests", valid.sum() * LANES)
        for c in range(8):
            leaf_m = anyhit[:, c] & (refs[:, c] < 0)
            if bool(leaf_m.any()):
                p = rows[leaf_m]
                leaf = torch.clamp(-refs[leaf_m, c] - 1, min=0).long()
                ok = _lane_occluders(_leaf_tris(tris, leaf, k),
                                     tuple(x[p] for x in o),
                                     tuple(x[p] for x in d), t_min, tmax[p])
                if stats is not None:
                    tests = active0[p] & ~occ[p]
                    first = ok.to(torch.int32).argmax(dim=2) + 1
                    _count(stats, "anyhit_tris", torch.where(
                        ok.any(dim=2), first, k)[tests].sum())
                    _count(stats, "anyhit_leaf_tris", tests.sum() * k)
                    _count(stats, "simd_tris", leaf_m.sum() * LANES * k)
                occ[p] |= ok.any(dim=2) & active0[p]
            push_m = anyhit[:, c] & (refs[:, c] >= 0)
            if bool(push_m.any()):
                p = rows[push_m]
                fits = sp[p] < stack_size
                overflow += (~fits).sum().to(torch.int32)
                p = p[fits]
                stack[p, sp[p]] = refs[push_m, c][fits]
                sp[p] += 1
        check = rows[(it[rows] & (LIVENESS_PERIOD - 1))
                     == LIVENESS_PERIOD - 1]
        it[rows] += 1
        if check.numel():
            alive[check] = (active0[check] & ~occ[check]).any(dim=1)
    capped = ((sp > 0) & alive).sum().to(torch.int32)
    iters = it[:, None].expand(pb, LANES).reshape(pb, 8, 128)
    return (occ.to(torch.int32).reshape(pb, 8, 128), iters.contiguous(),
            torch.stack([overflow, capped]))


def any_stats_cuda(rays, nodes, tris, *, leaf_size: int, t_min: float,
                   max_iters: int, stack_size: int):
    """Mode ANY_STATS of csrc/variants.cu: the stats walk, one block per
    packet."""
    res = _launch(_VARIANTS, ANY_STATS, ("mask_out", "cnt_out"), rays,
                  nodes, tris, None, ray_comps=10, attrs=None,
                  leaf_size=leaf_size, t_min=t_min, max_iters=max_iters,
                  stack_size=stack_size, scal_len=0)
    any_stats_cuda.launches += 1
    return res


VARIANT_KERNELS = (any_stats_cuda,)
for _fn in VARIANT_KERNELS:
    _fn.launches = 0


def any_stats_inputs(bvh: WideBVH, origins, dirs, t_max, t_min: float = 0.0):
    """Inputs of ``any_stats_cuda`` / ``any_stats_reference``: rays (H, W,
    3) in 32x32 tiles or (N, 3) in runs of 1024, t_max a scalar or per
    ray -> (args, kwargs, p, meta)."""
    if not isinstance(bvh, WideBVH):
        raise ValueError("the stats walk is WideBVH only")
    rays, p, meta = _ray_packets_packed(origins, dirs, t_max, batch=1)
    kwargs = dict(leaf_size=bvh.leaf_size, t_min=float(t_min),
                  max_iters=iter_cap(bvh.num_wide), stack_size=STACK_CAPACITY)
    return (rays, bvh.nodes, bvh.tris), kwargs, p, meta


def trace_any_stats(bvh: WideBVH, origins, dirs, t_max, t_min: float = 0.0):
    """Occlusion plus the iterations of each packet's shared walk
    (``tpurt``'s ``trace_any_pallas_stats``, ONE kernel launch) over a
    WideBVH: origins/dirs (H, W, 3) or (N, 3). Returns (occluded bool[H,
    W] or [N], iters i32[P], walk counts i32[2]); the occlusion is mode
    ANY's (decision 2)."""
    fn = _pick(origins.device, any_stats_cuda, any_stats_reference)
    args, kwargs, p, meta = any_stats_inputs(bvh, origins, dirs, t_max,
                                             t_min)
    occ, iters, counts = fn(*args, **kwargs)
    return _unpack(occ[:p], meta) > 0, iters[:p, 0, 0], counts
