"""The per-frame rebuild's kernels (counterparts of
``tpurt/kernels/build.py``):

- ``morton_codes`` -> ``morton_codes_pallas``: 30-bit Morton codes of the
  triangle centroids (quantise + interleave);
- ``morton_codes60`` -> ``morton_codes60_pallas``: the 60-bit keys of
  ``build_lbvh(morton_bits=60)``, two words (hi, lo) per centroid;
- ``topology`` -> ``topology_pallas``: the Karras radix tree as the
  min-Cartesian tree over the adjacent deltas, root renumbered to node 0;
  with ``want_depth`` also every node's depth (``topology_depth_*``,
  whose plain version is ``node_depths``); ``d_max`` bounds the deltas,
  so it also takes the sweep's steered priorities;
- ``topology_and_boxes`` -> ``topology_and_boxes_pallas``: the topology
  and every node's child boxes in one call (``_build_kernel`` with
  boxes);
- ``sweep_sah_priorities`` -> ``_sweep_sah_kernel``: ``top_sah``'s
  re-chosen top splits, as priorities that steer the unchanged topology;
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

All of them equal the JAX package's Pallas kernels exactly (the codes
bit for bit, the trees array for array): they feed the sort keys and the
tree topology, where any difference reshapes every tree.
"""

from __future__ import annotations

import torch

from ..bvh.morton import morton_encode, quantize_unit, unit_coords
from ._build import _check, _pick, _stream

EMPTY = -(2 ** 31)        # an empty wide slot (wide.EMPTY)
WIDE_FACTOR = 8
# Adjacent deltas lie in [0, 95]: clz of a non-zero code xor (<= 31; for
# 60-bit keys 32 + clz of the lo words' xor where the hi words agree), else
# 64 + clz(g ^ (g + 1)). The scan formulation keeps one column per
# possible value. Deltas grow strictly from a node to its children, so a
# Karras tree's internal nodes lie at most D_MAX - 1 levels below the root.
D_MAX = 96


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


def morton_codes60_reference(unit: torch.Tensor):
    """unit-cube coordinates f32[n, 3] -> (hi, lo) i32[n]: the 2^20 lattice,
    hi the interleave of each coordinate's top 10 bits, lo of its low
    10."""
    q = quantize_unit(unit, bits=20)
    return morton_encode(q >> 10), morton_encode(q & 0x3FF)


def morton_codes60_cuda(unit: torch.Tensor):
    """The kernel of ``morton_codes60_reference``: one thread per point,
    both words written."""
    from ._build import load_library
    _need_cuda(unit)
    n = unit.shape[0]
    _check(unit, "unit", torch.float32, (n, 3), unit.device)
    hi = torch.empty((n,), dtype=torch.int32, device=unit.device)
    lo = torch.empty((n,), dtype=torch.int32, device=unit.device)
    lib = load_library()
    _raise_on(lib.tpurt_morton_codes60_launch(
        unit.data_ptr(), n, hi.data_ptr(), lo.data_ptr(),
        _stream(unit.device)), "tpurt_morton_codes60_launch")
    morton_codes60_cuda.launches += 1
    return hi, lo


def morton_codes60(centroid: torch.Tensor, scene_min, scene_max):
    """Centroids f32[n, 3] + scene bounds -> (hi, lo) i32[n], bit-exact with
    ``bvh.morton.morton_of_points_60``; the unit-cube normalisation stays
    outside the kernel, as in ``morton_codes60_pallas``."""
    unit = unit_coords(centroid, scene_min, scene_max).contiguous()
    fn = _pick(unit.device, morton_codes60_cuda, morton_codes60_reference)
    return fn(unit)


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------

def _renum(x: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """Swap ids ``root`` and 0."""
    return torch.where(x == root, 0, torch.where(x == 0, root, x))


def topology_reference(d: torch.Tensor, d_max: int = D_MAX):
    """Adjacent deltas i32[ni] (values in [0, d_max)) -> (child i32[ni,
    2], first i32[ni], last i32[ni]) with the root as node 0: the
    vectorized formulation of ``lbvh.karras_topology_scan``. Gap g is
    internal node g (but the root, swapped with 0); L[g] is the nearest j
    < g with D[j] <= D[g], R[g] the nearest j > g with D[j] < D[g], found
    per threshold by a running max and a reverse running min."""
    ni = d.shape[0]
    n = ni + 1
    dev = d.device
    d = d.long()
    g = torch.arange(ni, device=dev)
    v = torch.arange(d_max + 2, device=dev)[None, :]
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


def _topology_launch(d: torch.Tensor, want_depth: bool, d_max: int,
                     want_parent: bool = False):
    """One call of the C topology entry: (child, first, last), and depth
    i32[ni] with ``want_depth`` (at most d_max - 1 steps to the root);
    ``want_parent`` appends the root's gap id i32[1] and each node's
    parent i32[ni] (-1 for the root)."""
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
    parent = depth = None
    if want_depth or want_parent:
        parent = torch.empty((ni,), dtype=torch.int32, device=dev)
    if want_depth:
        depth = torch.empty((ni,), dtype=torch.int32, device=dev)
    lib = load_library()
    _raise_on(lib.tpurt_topology_launch(
        d.data_ptr(), ni, levels, table.data_ptr(), lr.data_ptr(),
        root.data_ptr(), child.data_ptr(), first.data_ptr(),
        last.data_ptr(), None if parent is None else parent.data_ptr(),
        None if depth is None else depth.data_ptr(), int(d_max) - 1,
        _stream(dev)), "tpurt_topology_launch")
    return ((child, first, last) + ((depth,) if want_depth else ())
            + ((root, parent) if want_parent else ()))


def topology_cuda(d: torch.Tensor, d_max: int = D_MAX):
    """The kernel of ``topology_reference``: a sparse table of range
    minima of D (one launch per level), a per-gap binary-lifting search
    for L and R, and one thread per leaf and gap placing the children.
    Any priorities take the same launches; ``d_max`` only bounds the
    depth output's walk."""
    res = _topology_launch(d, False, d_max)
    topology_cuda.launches += 1
    return res


def node_depths(child: torch.Tensor, d_max: int = D_MAX) -> torch.Tensor:
    """i32[Ni] depth of every internal node (root, row 0, = 0) of a binary
    tree (``tpurt``'s ``bvh/wide.node_depths``): parent pointers by one
    scatter-max of both child sides, then rounds of pointer doubling
    until 2^rounds passes the Karras bound d_max - 1 (7 rounds for D_MAX:
    128 > 95)."""
    ni = child.shape[0]
    dev = child.device
    ref = child.reshape(-1).long()
    is_int = ref >= 0
    tgt = torch.where(is_int, ref, 0)
    own = torch.arange(ni, device=dev).repeat_interleave(2)
    parent = torch.zeros((ni,), dtype=torch.long, device=dev).scatter_reduce(
        0, tgt, torch.where(is_int, own, 0), "amax", include_self=True)
    depth = (torch.arange(ni, device=dev) != 0).to(torch.int32)
    for _ in range((int(d_max) - 1).bit_length()):
        depth = depth + depth[parent]
        parent = parent[parent]
    return depth


def topology_depth_reference(d: torch.Tensor, d_max: int = D_MAX):
    """Plain version of the topology with its depth output
    (``topology_pallas(want_depth=True)``): ``topology_reference``, then
    ``node_depths`` of its tree -> (child, first, last, depth i32[ni])."""
    child, first, last = topology_reference(d, d_max)
    return child, first, last, node_depths(child, d_max)


def topology_depth_cuda(d: torch.Tensor, d_max: int = D_MAX):
    """The kernel of ``topology_depth_reference``: ``topology_cuda``'s
    launches, whose placement also writes every node's parent, and one
    more, one thread per node counting its steps up to the root."""
    res = _topology_launch(d, True, d_max)
    topology_depth_cuda.launches += 1
    return res


def topology(d: torch.Tensor, want_depth: bool = False,
             d_max: int = D_MAX):
    """Karras topology from the adjacent deltas (``lbvh.adjacent_deltas``)
    or any priorities in [0, d_max) (``sweep_sah_priorities``' D', with
    ``d_max`` = D_MAX + maxd): (child i32[ni, 2], first, last) with the
    root as node 0, equal to ``topology_pallas``; ``want_depth`` adds
    depth i32[ni] (root 0), as ``topology_pallas(want_depth=True)``
    returns it."""
    if want_depth:
        fn = _pick(d.device, topology_depth_cuda, topology_depth_reference)
    else:
        fn = _pick(d.device, topology_cuda, topology_reference)
    return fn(d.to(torch.int32).contiguous(), int(d_max))


# ---------------------------------------------------------------------------
# Topology and node boxes in one call
# ---------------------------------------------------------------------------

def topology_and_boxes_reference(d: torch.Tensor, leaf_min: torch.Tensor,
                                 leaf_max: torch.Tensor):
    """Plain version of ``topology_and_boxes``: ``topology_reference``,
    then every node's child boxes from the range table of the leaf boxes
    (``lbvh._assemble_node_boxes``)."""
    from ..bvh.lbvh import _assemble_node_boxes
    child, first, last = topology_reference(d)
    nodes_box, root_min, root_max = _assemble_node_boxes(
        leaf_min, leaf_max, child, first, last)
    return child, first, last, nodes_box, root_min, root_max


def topology_and_boxes_cuda(d: torch.Tensor, leaf_min: torch.Tensor,
                            leaf_max: torch.Tensor):
    """The kernel of ``topology_and_boxes_reference``: ``topology_cuda``'s
    launches, whose placement also writes every node's parent, then one
    bottom-up box launch (``csrc/build.cu`` ``node_boxes_kernel``): a
    thread per leaf climbs the parent pointers, and at each node the
    second child to arrive (an arrival counter per node) writes the
    node's union into its parent's record."""
    from ._build import load_library
    _need_cuda(d)
    ni = d.shape[0]
    dev = d.device
    _check(leaf_min, "leaf_min", torch.float32, (ni + 1, 3), dev)
    _check(leaf_max, "leaf_max", torch.float32, (ni + 1, 3), dev)
    child, first, last, root, parent = _topology_launch(d, False, D_MAX,
                                                        want_parent=True)
    arrive = torch.zeros((ni,), dtype=torch.int32, device=dev)
    nodes_box = torch.empty((ni, 12), dtype=torch.float32, device=dev)
    root_box = torch.empty((6,), dtype=torch.float32, device=dev)
    lib = load_library()
    _raise_on(lib.tpurt_node_boxes_launch(
        d.data_ptr(), ni, root.data_ptr(), child.data_ptr(),
        parent.data_ptr(), leaf_min.data_ptr(), leaf_max.data_ptr(),
        arrive.data_ptr(), nodes_box.data_ptr(), root_box.data_ptr(),
        _stream(dev)), "tpurt_node_boxes_launch")
    topology_and_boxes_cuda.launches += 1
    return child, first, last, nodes_box, root_box[:3], root_box[3:]


def topology_and_boxes(d: torch.Tensor, leaf_min: torch.Tensor,
                       leaf_max: torch.Tensor):
    """Karras topology and node boxes in one call (``tpurt``'s
    ``topology_and_boxes_pallas``): adjacent deltas i32[ni] and leaf boxes
    f32[ni + 1, 3] -> (child i32[ni, 2], first, last, nodes_box f32[ni,
    12] as [Lmin, Lmax, Rmin, Rmax], root_min, root_max) with the root as
    node 0. A union is a min and a max, so the boxes equal ``tpurt``'s bit
    for bit. ``build_lbvh`` keeps ``topology`` and the range table, as
    ``tpurt``'s build does."""
    fn = _pick(d.device, topology_and_boxes_cuda,
               topology_and_boxes_reference)
    return fn(d.to(torch.int32).contiguous(),
              leaf_min.to(torch.float32).contiguous(),
              leaf_max.to(torch.float32).contiguous())


# ---------------------------------------------------------------------------
# Sweep-SAH priorities (top_sah)
# ---------------------------------------------------------------------------

SWEEP_BLOCK = 8          # leaves per SAH block (the split granularity)
SWEEP_MAXD = 21          # top-tree depth cap: priorities 0..maxd-1
SWEEP_MIN_BLOCKS = 8     # ranges of at most this many blocks are not split
_SWEEP_BIG = 3.4e38


def sweep_maxn(nb: int, min_blocks: int) -> int:
    """Output slots of the sweep over nb blocks (``tpurt``'s maxn): the
    splits past it are not emitted."""
    return 2 * (nb // max(min_blocks, 1) + 2)


def block_boxes(leaf_min: torch.Tensor, leaf_max: torch.Tensor,
                block: int) -> torch.Tensor:
    """Leaf boxes f32[nl, 3] -> block boxes f32[nb * 6], per block [min
    xyz, max xyz] of ``block`` leaves; the last leaf pads the tail."""
    nl = leaf_min.shape[0]
    nb = -(-nl // block)
    pad = nb * block - nl
    if pad:
        leaf_min = torch.cat([leaf_min, leaf_min[-1:].expand(pad, 3)])
        leaf_max = torch.cat([leaf_max, leaf_max[-1:].expand(pad, 3)])
    bmin = leaf_min.reshape(nb, block, 3).amin(dim=1)
    bmax = leaf_max.reshape(nb, block, 3).amax(dim=1)
    return torch.cat([bmin, bmax], dim=1).reshape(-1).contiguous()


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """fma(a, b, c) of float32 tensors, rounded once to float32, as the
    card's ``__fmaf_rn`` and the FMAs XLA's CPU compiler contracts. a b is
    exact in float64; the float64 sum s is then rounded again, which
    differs from one rounding only where s lies exactly halfway between
    two float32 values: there the sign of the sum's own rounding error
    (TwoSum) picks the neighbour."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    r = s.float()
    up = r.double() < s
    lo = torch.where(up, r, torch.nextafter(r, torch.full_like(r, -torch.inf)))
    hi = torch.where(up, torch.nextafter(r, torch.full_like(r, torch.inf)), r)
    half = (lo.double() + hi.double()) * 0.5 == s
    return torch.where(half & (err > 0), hi, torch.where(half & (err < 0),
                                                         lo, r))


def _surface(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The sweep's SA of boxes [..., 3], dx dy + dy dz + dz dx of the
    clamped extents, as the JAX package's kernel rounds it (decision 19):
    XLA contracts it into fma(dz, dx, fma(dx, dy, dy dz))."""
    e = torch.clamp(hi - lo, min=0.0)
    dx, dy, dz = e[..., 0], e[..., 1], e[..., 2]
    return fma32(dz, dx, fma32(dx, dy, dy * dz))


def sweep_sah_priorities_reference(bx: torch.Tensor, ni: int, block: int,
                                   maxd: int, min_blocks: int, stats=None):
    """Plain version of ``_sweep_sah_kernel``: block boxes f32[nb * 6] ->
    (gaps i32[maxn], ranks i32[maxn]), unused slots (ni, 0). A LIFO
    stack starts with all blocks at depth 0; a popped range of more than
    ``min_blocks`` blocks, above depth ``maxd`` and while slots remain,
    splits after the block j that minimises SA(a..j) (j - a + 1) + SA(j+1
    ..b) (b - j) (the first minimum; a cost that is not below 3.4e38
    never wins and leaves j = a), emits gap (j + 1) block - 1 at rank =
    its depth, then pushes the left range and the right one. Each range's
    prefix and suffix boxes are running minima and maxima (exact in any
    order); the stack walk is serial, on the host. The SA and the cost
    are rounded as the JAX package's kernel rounds them (``_surface``;
    the cost fma(SA(j+1..b), b - j, SA(a..j) (j - a + 1))). ``stats``
    counts "sweep_steps": the blocks the split ranges swept, twice
    each."""
    dev = bx.device
    nb = bx.shape[0] // 6
    boxes = bx.reshape(nb, 6)
    maxn = sweep_maxn(nb, min_blocks)
    gaps = torch.full((maxn,), ni, dtype=torch.int32, device=dev)
    ranks = torch.zeros((maxn,), dtype=torch.int32, device=dev)
    stack, nout = [(0, nb - 1, 0)], 0
    while stack:
        a, b, dep = stack.pop()
        if not (b - a + 1 > min_blocks and dep < maxd and nout < maxn):
            continue
        lo, hi = boxes[a:b + 1, :3], boxes[a:b + 1, 3:]
        pre = _surface(torch.cummin(lo, 0).values, torch.cummax(hi, 0).values)
        suf = _surface(torch.cummin(lo.flip(0), 0).values.flip(0),
                       torch.cummax(hi.flip(0), 0).values.flip(0))
        j = torch.arange(b - a, device=dev)
        cost = fma32(suf[1:], (b - a - j).to(torch.float32),
                     pre[:-1] * (j + 1).to(torch.float32))
        cost = torch.where(cost < _SWEEP_BIG, cost, torch.inf)
        bj = a + int(torch.argmin(cost)) if bool((cost < torch.inf).any()) \
            else a
        if stats is not None:
            stats["sweep_steps"] = stats.get("sweep_steps", 0) + 2 * (b - a)
        gaps[nout] = (bj + 1) * block - 1
        ranks[nout] = dep
        nout += 1
        stack += [(a, bj, dep + 1), (bj + 1, b, dep + 1)]
    return gaps, ranks


def sweep_sah_priorities_cuda(bx: torch.Tensor, ni: int, block: int,
                              maxd: int, min_blocks: int):
    """The kernel of ``sweep_sah_priorities_reference`` (``csrc/build.cu``):
    one block keeps the stack walk serial; each split range's suffix and
    prefix boxes are block-wide scans, its split a block-wide argmin."""
    from ._build import load_library
    _need_cuda(bx)
    dev = bx.device
    nb = bx.shape[0] // 6
    if nb < 1 or bx.shape[0] != nb * 6:
        raise ValueError(f"block boxes of {bx.shape[0]} floats")
    _check(bx, "bx", torch.float32, (nb * 6,), dev)
    maxn = sweep_maxn(nb, min_blocks)
    gaps = torch.empty((maxn,), dtype=torch.int32, device=dev)
    ranks = torch.empty((maxn,), dtype=torch.int32, device=dev)
    suffix = torch.empty((nb,), dtype=torch.float32, device=dev)
    stack = torch.empty((3 * (maxn + 2),), dtype=torch.int32, device=dev)
    lib = load_library()
    _raise_on(lib.tpurt_sweep_sah_launch(
        bx.data_ptr(), nb, int(ni), int(block), int(maxd), int(min_blocks),
        maxn, suffix.data_ptr(), stack.data_ptr(), gaps.data_ptr(),
        ranks.data_ptr(), _stream(dev)), "tpurt_sweep_sah_launch")
    sweep_sah_priorities_cuda.launches += 1
    return gaps, ranks


def sweep_sah_priorities(d: torch.Tensor, leaf_min: torch.Tensor,
                         leaf_max: torch.Tensor, block: int = SWEEP_BLOCK,
                         maxd: int = SWEEP_MAXD,
                         min_blocks: int = SWEEP_MIN_BLOCKS) -> torch.Tensor:
    """Adjacent deltas D i32[ni] -> the steered priorities D' i32[ni]
    (``tpurt``'s ``sweep_sah_priorities``): every gap keeps D + maxd but
    the sweep's splits, which take their depth in the top tree. The
    topology of D' (``topology(..., d_max=D_MAX + maxd)``) is the hybrid
    tree: sweep-SAH splits at the top, the Morton structure below, leaf
    ranges contiguous. No host sync."""
    ni = d.shape[0]
    bx = block_boxes(leaf_min.to(torch.float32), leaf_max.to(torch.float32),
                     int(block))
    fn = _pick(d.device, sweep_sah_priorities_cuda,
               sweep_sah_priorities_reference)
    gaps, ranks = fn(bx, ni, int(block), int(maxd), int(min_blocks))
    dprime = torch.cat([d.to(torch.int32) + int(maxd),
                        torch.zeros((1,), dtype=torch.int32,
                                    device=d.device)])
    dprime[gaps.long()] = ranks      # slot ni takes the unused outputs
    return dprime[:ni]


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


BUILD_KERNELS = (morton_codes_cuda, topology_cuda, collapse_area_cuda,
                 morton_codes60_cuda, topology_depth_cuda,
                 sweep_sah_priorities_cuda, topology_and_boxes_cuda)
for _fn in BUILD_KERNELS:
    _fn.launches = 0
