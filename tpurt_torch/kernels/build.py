"""The per-frame rebuild's kernels (counterparts of
``tpurt/kernels/build.py``):

- ``morton_codes`` -> ``morton_codes_pallas``: 30-bit Morton codes of the
  triangle centroids (quantise + interleave);
- ``topology`` -> ``topology_pallas``: the Karras radix tree as the
  min-Cartesian tree over the adjacent deltas, root renumbered to node 0;
- ``collapse_area`` -> ``collapse_area_pallas``: the breadth-first
  area-greedy 8-wide collapse.

Each has three pieces, as in ``kernels/traverse.py``:

- ``*_cuda``: the hand-written CUDA kernel (``csrc/build.cu``). It takes
  CUDA tensors only and launches or raises; ``.launches`` counts its
  launches.
- ``*_reference``: the same function in plain PyTorch. The wrapper takes
  it only for CPU tensors.
- the wrapper the build calls, which picks one of the two by the tensors'
  device.

All three equal the JAX package's Pallas kernels exactly (the codes bit
for bit, the trees array for array): they feed the sort keys and the tree
topology, where any difference reshapes every tree.
"""

from __future__ import annotations

import torch

from ..bvh.morton import morton_encode, quantize_unit, unit_coords
from ._build import _check, _pick

EMPTY = -(2 ** 31)        # an empty wide slot (wide.EMPTY)
WIDE_FACTOR = 8
# Adjacent deltas of 30-bit codes lie in [0, 95]: clz of a non-zero code
# xor (<= 31), else 64 + clz(g ^ (g + 1)). The scan formulation keeps one
# column per possible value.
D_MAX = 96


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")


def _need_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got "
                         f"{t.device}")


# ---------------------------------------------------------------------------
# Morton codes
# ---------------------------------------------------------------------------

def morton_codes_reference(unit: torch.Tensor) -> torch.Tensor:
    """unit-cube coordinates f32[n, 3] -> i32[n] 30-bit Morton codes."""
    return morton_encode(quantize_unit(unit))


def morton_codes_cuda(unit: torch.Tensor) -> torch.Tensor:
    """The kernel of ``morton_codes_reference``: one thread per point."""
    from ._build import load_library
    _need_cuda(unit)
    n = unit.shape[0]
    _check(unit, "unit", torch.float32, (n, 3), unit.device)
    codes = torch.empty((n,), dtype=torch.int32, device=unit.device)
    lib = load_library()
    _raise_on(lib.tpurt_morton_codes_launch(
        unit.data_ptr(), n, codes.data_ptr(), _stream(unit.device)),
        "tpurt_morton_codes_launch")
    morton_codes_cuda.launches += 1
    return codes


def morton_codes(centroid: torch.Tensor, scene_min, scene_max
                 ) -> torch.Tensor:
    """Centroids f32[n, 3] + scene bounds -> i32[n] codes, bit-exact with
    ``bvh.morton.morton_of_points``. The normalisation to the unit cube
    stays outside the kernel, as in ``morton_codes_pallas``."""
    unit = unit_coords(centroid, scene_min, scene_max).contiguous()
    fn = _pick(unit.device, morton_codes_cuda, morton_codes_reference)
    return fn(unit)


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------

def _renum(x: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """Swap ids ``root`` and 0."""
    return torch.where(x == root, 0, torch.where(x == 0, root, x))


def topology_reference(d: torch.Tensor):
    """Adjacent deltas i32[ni] (values in [0, D_MAX]) -> (child i32[ni, 2],
    first i32[ni], last i32[ni]) with the root as node 0: the vectorized
    formulation of ``lbvh.karras_topology_scan``. Gap g is internal node g
    (but the root, swapped with 0); L[g] is the nearest j < g with D[j] <=
    D[g], R[g] the nearest j > g with D[j] < D[g], found per threshold by a
    running max and a reverse running min."""
    ni = d.shape[0]
    n = ni + 1
    dev = d.device
    d = d.long()
    g = torch.arange(ni, device=dev)
    v = torch.arange(D_MAX + 2, device=dev)[None, :]
    neg = torch.full((1, v.shape[1]), -1, dtype=torch.long, device=dev)
    none = torch.full((1, v.shape[1]), ni, dtype=torch.long, device=dev)
    pmax = torch.cummax(torch.where(d[:, None] <= v, g[:, None], -1),
                        dim=0).values
    pmin = torch.cummin(torch.where(d[:, None] < v, g[:, None], ni).flip(0),
                        dim=0).values.flip(0)
    L = torch.cat([neg, pmax[:-1]]).gather(1, d[:, None])[:, 0]
    R = torch.cat([pmin[1:], none]).gather(1, d[:, None])[:, 0]

    first = L + 1
    last = R
    dL = d[L.clamp(0, ni - 1)]
    dR = d[R.clamp(0, ni - 1)]
    parent = torch.where(L < 0, R, torch.where(R >= ni, L,
                                               torch.where(dL > dR, L, R)))
    l = torch.arange(n, device=dev)
    dprev = d[(l - 1).clamp(0, ni - 1)]
    dcur = d[l.clamp(0, ni - 1)]
    lparent = torch.where(l == 0, 0, torch.where(
        l == n - 1, ni - 1, torch.where(dprev > dcur, l - 1, l)))
    # The root: the first gap with no smaller neighbour on either side.
    root = torch.argmin(torch.where((L < 0) & (R >= ni), 0, 1))

    # Row ni catches the root's own (absent) parent link and is dropped.
    child = torch.zeros((ni + 1, 2), dtype=torch.long, device=dev)
    side = torch.where(g < parent, 0, 1)
    prow = torch.where(g == root, ni, _renum(parent, root))
    child[prow, side] = _renum(g, root)
    child[_renum(lparent, root), torch.where(l <= lparent, 0, 1)] = -(l + 1)
    rows = _renum(g, root)
    first_r = torch.empty_like(first)
    last_r = torch.empty_like(last)
    first_r[rows] = first
    last_r[rows] = last
    i32 = torch.int32
    return child[:ni].to(i32), first_r.to(i32), last_r.to(i32)


def topology_cuda(d: torch.Tensor):
    """The kernel of ``topology_reference``: a sparse table of range
    minima of D (one launch per level), a per-gap binary-lifting search
    for L and R, and one thread per leaf and gap placing the children."""
    from ._build import load_library
    _need_cuda(d)
    ni = d.shape[0]
    if ni < 1:
        raise ValueError("the topology needs at least two leaves")
    dev = d.device
    _check(d, "d", torch.int32, (ni,), dev)
    levels = max(1, ni.bit_length())
    table = torch.empty((max(levels - 1, 1) * ni,), dtype=torch.int32,
                        device=dev)
    lr = torch.empty((2 * ni,), dtype=torch.int32, device=dev)
    root = torch.empty((1,), dtype=torch.int32, device=dev)
    child = torch.empty((ni, 2), dtype=torch.int32, device=dev)
    first = torch.empty((ni,), dtype=torch.int32, device=dev)
    last = torch.empty((ni,), dtype=torch.int32, device=dev)
    lib = load_library()
    _raise_on(lib.tpurt_topology_launch(
        d.data_ptr(), ni, levels, table.data_ptr(), lr.data_ptr(),
        root.data_ptr(), child.data_ptr(), first.data_ptr(),
        last.data_ptr(), _stream(dev)), "tpurt_topology_launch")
    topology_cuda.launches += 1
    return child, first, last


def topology(d: torch.Tensor):
    """Karras topology from the adjacent deltas (``lbvh.adjacent_deltas``):
    (child i32[ni, 2], first, last) with the root as node 0, equal to
    ``topology_pallas`` without its depth output."""
    fn = _pick(d.device, topology_cuda, topology_reference)
    return fn(d.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# Area-greedy 8-wide collapse
# ---------------------------------------------------------------------------

def greedy_slots(child: torch.Tensor, area: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """i32[m, 8] frontier of binary nodes ``x``: starting from the two
    children, expand the largest-area internal slot (the first maximum
    winning) into its two children, left child in place and right child
    at the end, while the row has fewer than 8 slots. Leaves and empty
    slots key at -1."""
    m = x.shape[0]
    dev = child.device
    slots = torch.full((m, WIDE_FACTOR), EMPTY, dtype=torch.int32,
                       device=dev)
    slots[:, 0:2] = child[x.long()]

    def key_of(refs):
        return torch.where(refs >= 0, area[refs.clamp(min=0).long()], -1.0)

    keys = key_of(slots)
    count = torch.full((m,), 2, dtype=torch.int32, device=dev)
    lanes = torch.arange(WIDE_FACTOR, device=dev)[None, :]
    for _ in range(WIDE_FACTOR - 2):
        pick = torch.argmax(keys, dim=1)
        best = torch.gather(keys, 1, pick[:, None])[:, 0]
        can = (count < WIDE_FACTOR) & (best >= 0.0)
        ref = torch.gather(slots, 1, pick[:, None])[:, 0]
        lr = child[ref.clamp(min=0).long()]
        at_pick = (lanes == pick[:, None]) & can[:, None]
        at_end = (lanes == count[:, None]) & can[:, None]
        slots = torch.where(at_pick, lr[:, 0:1],
                            torch.where(at_end, lr[:, 1:2], slots))
        keys = torch.where(at_pick, key_of(lr[:, 0:1]),
                           torch.where(at_end, key_of(lr[:, 1:2]), keys))
        count = count + can.to(torch.int32)
    return slots


def collapse_area_reference(child: torch.Tensor, area: torch.Tensor,
                            nw_pad: int):
    """child i32[ni, 2], area f32[ni] -> (front i32[nw_pad, 8], src
    i32[nw_pad], count i32[]): the breadth-first collapse level by level.
    Wide ids are BFS positions: a level's children are numbered by (parent
    position, slot) after the level. ``front`` holds kernel refs (>= 0:
    wide id, < 0: leaf as -(leaf+1), EMPTY: empty slot), ``src`` each wide
    node's binary id (pad rows 0). Nodes past ``nw_pad`` are not expanded
    but still counted in their parent's row; ``count`` > nw_pad says the
    pad overflowed."""
    dev = child.device
    front = torch.full((nw_pad, WIDE_FACTOR), EMPTY, dtype=torch.int32,
                       device=dev)
    src = torch.zeros((nw_pad,), dtype=torch.int32, device=dev)
    lo, hi = 0, 1
    while lo < min(hi, nw_pad):
        end = min(hi, nw_pad)
        slots = greedy_slots(child, area, src[lo:end])
        is_int = slots >= 0
        flat = is_int.reshape(-1).to(torch.int32)
        pos = hi + torch.cumsum(flat, 0, dtype=torch.int32) - flat
        pos = pos.reshape(slots.shape)
        front[lo:end] = torch.where(is_int, pos, slots)
        push = is_int & (pos < nw_pad)
        src[pos[push].long()] = slots[push]
        lo, hi = hi, hi + int(flat.sum())
    return front, src, torch.tensor(hi, dtype=torch.int32, device=dev)


def collapse_area_cuda(child: torch.Tensor, area: torch.Tensor,
                       nw_pad: int):
    """The kernel of ``collapse_area_reference``: one block walks the BFS
    levels, one thread per wide node of a level."""
    from ._build import load_library
    _need_cuda(child)
    dev = child.device
    ni = child.shape[0]
    if nw_pad < 1:
        raise ValueError(f"nw_pad {nw_pad} < 1")
    _check(child, "child", torch.int32, (ni, 2), dev)
    _check(area, "area", torch.float32, (ni,), dev)
    front = torch.empty((nw_pad, WIDE_FACTOR), dtype=torch.int32, device=dev)
    src = torch.empty((nw_pad,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    lib = load_library()
    _raise_on(lib.tpurt_collapse_area_launch(
        child.data_ptr(), area.data_ptr(), ni, int(nw_pad),
        front.data_ptr(), src.data_ptr(), count.data_ptr(), _stream(dev)),
        "tpurt_collapse_area_launch")
    collapse_area_cuda.launches += 1
    return front, src, count


def collapse_area(child: torch.Tensor, area: torch.Tensor, nw_pad: int):
    """Binary topology + per-node surface areas -> the BFS-ordered
    area-greedy 8-wide collapse, equal to ``collapse_area_pallas``:
    (front i32[nw_pad, 8], src i32[nw_pad], count i32[])."""
    fn = _pick(child.device, collapse_area_cuda, collapse_area_reference)
    return fn(child.to(torch.int32).contiguous(),
              area.to(torch.float32).contiguous(), int(nw_pad))


BUILD_KERNELS = (morton_codes_cuda, topology_cuda, collapse_area_cuda)
for _fn in BUILD_KERNELS:
    _fn.launches = 0
