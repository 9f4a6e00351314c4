"""Fused evaluation: the wrappers of the Hopper kernels.

* `eval_regular` / `eval_regular_stack` launch `csrc/fused_regular.cu` /
  `fused_regular_stack.cu` (linear, cubic, nearest), the counterpart of
  `interpn_tpu/ops/pallas_v3.py::eval_regular` (K1) and
  `eval_regular_stack` (K5). The layout their kernel reads is
  `regular_route`'s alone: the table staged in shared memory, a cubic
  stack's groups of tables staged one to a block, its packed quads, its
  cubic pack of axis 0's taps (one or four lanes a query; a cubic stack's
  packs table after table), or a stack channel-interleaved (each laid out
  every call by the same entry; `pack`, `cubic_pack`, `cubic_stack_pack`
  and `interleave` alone), or the table itself.
* `eval_rectilinear` / `eval_rectilinear_stack` launch
  `csrc/fused_rectilinear.cu` / `fused_rectilinear_stack.cu`, the
  counterpart of `pallas_v3.eval_rectilinear_pre` (K2: linear, cubic),
  `pallas_v3.eval_rectilinear` (K3: nearest) and
  `pallas_v3.eval_rectilinear_stack` (K6). Cubic builds each axis's
  weights once a query and contracts every table's stencil with them,
  reading the layout `rectilinear_route` picks (K1's staged table and cubic
  pack, K5's interleave, or the table itself); a linear or nearest stack
  reads K5's layouts (its interleave, or staged); one linear or nearest
  table locates from its block's copy of the grid columns and their
  bucket starts in shared memory, and an f32 linear one is staged there
  too (`_lerp_table_route`).
* `eval_bspline` / `eval_bspline_stack` launch `csrc/fused_bspline.cu` /
  `fused_bspline_stack.cu`, the counterpart of `pallas_v3.eval_bspline`
  (K4, and K2's spline use) and `pallas_v3.eval_bspline_stack` (K7), on
  `bspline_route`'s layout: a table staged in shared memory or direct; a
  stack staged as K5 stages a cubic one, channel-interleaved, or direct.
* `launch_df64` / `launch_i8` launch `csrc/fused_df64.cu` (K8, the
  counterpart of `interpn_tpu/ops/pallas_df64.py::_pallas_df64` with the
  float64 weight build before it) and `csrc/fused_i8.cu` (K9,
  `interpn_tpu/ops/pallas_i8.py::_pallas_i8`, likewise), the f64 engines
  that `INTERPN_TPU_F64=df64|i8` selects (`ops/dispatch.py`): from the
  queries and the grid to the float64 result in one launch. Their wrappers
  with plain versions, and the table preparation they read, are
  `ops/df64.py` and `ops/i8.py`.

A stack is (nch, prod(dims)) tables on one grid, evaluated at the same
queries into an (nch, n) block: the stack source instantiates its family's
kernel (`csrc/*.cuh`) with a loop over the tables after the one locate and
weight build per query; the single-table source has no loop. The TPU
kernels contract weight matrices against the whole table on the MXU or the
VPU; the Hopper kernels read only each query's stencil, so they need none of
the TPU caps (batch floor, VMEM-bounded grid size, finite-table guard). See
the sources for what bounds them on the card.

On a CPU tensor each wrapper runs its kernel's plain version (the `plain_*`
functions below: the gather trees of `ops/linear.py`, `ops/cubic.py`,
`ops/nearest.py` and `ops/bspline.py`, over each channel for a stack, but
for rectilinear cubic `cubic.cubic_rectilinear_weighted`, the weights and
their contraction; for K8/K9 the float64 weights, `df64.plain_df64` /
`i8.plain_i8` and the recombination). On a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from functools import cache

import torch

from .. import _build
from ..utils import tracing
from .bspline import bspline_gather
from .cubic import cubic_rectilinear, cubic_rectilinear_weighted, cubic_regular
from .linear import linear_rectilinear, linear_regular
from .nearest import nearest_rectilinear, nearest_regular

METHODS = ("linear", "cubic", "nearest")  # kLinear, kCubic, kNearest in csrc
DEGREES = (3, 5)  # cubic_spline, quintic
F64_ENGINES = ("df64", "i8")  # K8, K9: csrc/fused_df64.cu, csrc/fused_i8.cu
# the grid kinds of the engines' C entries (kGridRegular, kGridRectilinear,
# kGridSpline in csrc/engine_weights.cuh)
GRID_KINDS = ("regular", "rectilinear", "bspline")
SOURCES = (*(f"fused_{family}{stack}" for family in ("regular", "rectilinear", "bspline")
             for stack in ("", "_stack")),
           *(f"fused_{engine}" for engine in F64_ENGINES))
_SINGLE = (*(f"{grid}_{m}" for grid in ("regular", "rectilinear") for m in METHODS),
           *(f"bspline_k{k}" for k in DEGREES))
PACK = "regular_pack"  # the quads route's pack, in csrc/fused_regular.cu
CUBIC_PACK = "regular_cubic_pack"  # the taps routes' pack, in csrc/fused_regular.cu
INTERLEAVE = "regular_interleave"  # the interleaved route's, in csrc/fused_regular_stack.cu
# the taps routes' pack of a cubic stack, in csrc/fused_regular_stack.cu
CUBIC_STACK_PACK = "regular_cubic_stack_pack"
# the same layout kernels in the rectilinear sources, launched by K2's and
# K6's entries
RECT_CUBIC_PACK = "rectilinear_cubic_pack"
RECT_INTERLEAVE = "rectilinear_interleave"
# and the interleave in csrc/fused_bspline_stack.cu, launched by K7's entry
BSPLINE_INTERLEAVE = "bspline_interleave"
KERNELS = (*_SINGLE, *(f"{name}_stack" for name in _SINGLE), *F64_ENGINES, PACK, CUBIC_PACK,
           INTERLEAVE, CUBIC_STACK_PACK, RECT_CUBIC_PACK, RECT_INTERLEAVE, BSPLINE_INTERLEAVE)

# Kernel launches by name; a run resets and reads them to show that its main
# path went through the kernels.
launches = dict.fromkeys(KERNELS, 0)

# the route codes of csrc/regular.cuh: kDirect, kStaged, kQuads, kInterleaved,
# kTaps, kTapLanes, kStagedTables, kStagedGroups, kGuided
ROUTES = ("direct", "staged", "quads", "interleaved", "taps", "tap_lanes", "staged_tables",
          "staged_groups", "guided")
TAP_ROUTES = ROUTES[4:6]  # the routes that read the cubic pack
# the layout kernel that the entry launches before the kernel, by route (of
# one regular table, of a regular stack)
LAYOUTS = {"quads": PACK, **dict.fromkeys(TAP_ROUTES, CUBIC_PACK)}
STACK_LAYOUTS = {"interleaved": INTERLEAVE, **dict.fromkeys(TAP_ROUTES, CUBIC_STACK_PACK)}
RECT_LAYOUTS = {"interleaved": RECT_INTERLEAVE, **dict.fromkeys(TAP_ROUTES, RECT_CUBIC_PACK)}
BSPLINE_LAYOUTS = {"interleaved": BSPLINE_INTERLEAVE}
# An f32 linear table (a stack read table by table, regular or
# rectilinear: all its tables) of at most this many bytes is staged in
# shared memory (kStageBytes in csrc/regular.cuh, which refuses a larger
# one). Nearest reads one entry a query, too few to pay for the copies, and
# reads the table direct.
STAGE_BYTES = 112 * 1024
# A single f32 linear table above STAGE_BYTES is read as packed quads while
# the packed copy (about 4x the table) stays within this many bytes. The
# pack is paid every call: at 1e6 queries on an H100 the 15.7 MB copy of a
# 100^3 table paid for itself twice over; the 31 MB copy of the f64 one did
# not, so f64 reads its table direct (`scripts/torch_regular_ab.py`).
QUAD_BYTES = 16 * 2**20
# A single cubic table above STAGE_BYTES is read through its cubic pack
# (about 4x the table, made every call) while the pack stays within this
# many bytes: the 31 MB pack of a 100^3 f64 table still took its time from
# 0.478 to 0.162 ms at 1e6 queries on an H100 (`scripts/torch_regular_ab.py`).
TAP_BYTES = 32 * 2**20
# An f64 cubic table at 2D or 3D of at most this many bytes reads direct: its
# scalar reads hit the SM's L1 (256 KB with shared memory), where the pack,
# 4x larger, would not (25^3 and 30^3 f64 ran 5-36% slower through it). A
# stack of such tables reads its packs: read direct one after another, its
# tables do not fit L1 together.
L1_BYTES = 256 * 1024
# A linear or nearest stack (regular or rectilinear) with this many bytes of
# channels a table entry or more (8 f32, 4 f64 tables) is read
# channel-interleaved while its interleave has int32 indices (kRunBytes); so
# is a rectilinear cubic stack of tables above STAGE_BYTES, f32 always, f64
# up to 3D or above L1_BYTES: on an H100 8 f32 channels a sector ran
# 4.1-7.4x ahead of direct at 3-5D, 4 f64 1.1-3.6x at 30^3-100^3, 20^4 and
# 9^5, but 8.5% and 13% behind it at 12^4 and 8^5, whose tables direct
# reads from L1, and level at 6^6 (`scripts/torch_regular_ab.py`).
RUN_BYTES = 32
# A cubic stack (K5) or B-spline stack (K7) whose tables fit this many bytes
# each is split into the fewest groups of consecutive tables within it, as
# evenly as it allows (one group where the whole stack fits), and each block
# stages its group in shared memory ('staged_groups'; kGroupBytes in
# csrc/regular.cuh, whose entries count the groups and refuse a larger
# table): about all the shared memory a block may use, at one 1024-thread
# block an SM. One B-spline table (K4) within it is staged the same way. A
# cubic stack of larger tables reads their cubic packs (`_stack_route`).
GROUP_BYTES = 224 * 1024
# One linear or nearest rectilinear table (K2, K3) locates each query from
# its block's copy of the grid columns and their bucket starts
# (`guide_bytes`) while those fit this many bytes ('guided'; kColumnBytes
# in csrc/regular.cuh, which refuses more), or, on the staged route, while
# they fit STAGE_BYTES beside the table. Larger columns are bisected from
# device memory ('direct').
COLUMN_BYTES = 32 * 1024

_THREADS = 256  # kThreads in the sources
# 2048 resident threads per SM at 256 threads a block (the f64 engines); the
# grid families size their grid in C instead
_BLOCKS_PER_SM = 8
_MAX_DIMS = 8
_INT32_LIMIT = 2**31
_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_PTRS = ctypes.POINTER(_VOIDP)
_DIMS = [_INT, ctypes.POINTER(_INT)]  # ndims, dims
_TAIL = [_VOIDP, _PTRS, _VOIDP, ctypes.c_longlong, _INT, _INT, _VOIDP]
_FAMILY_ARGTYPES = {
    # (method, linearize, is_f64 | degree, is_f64), ndims, dims, the grid
    # (starts, steps | columns | knots) and the layout buffer, then vals,
    # obs, out, n, nch, the route, stream; a family's single-table and
    # stack sources take the same
    "regular": [_INT, _INT, _INT] + _DIMS + [_VOIDP, _VOIDP, _VOIDP] + _TAIL,
    "rectilinear": [_INT, _INT, _INT] + _DIMS + [_PTRS, _VOIDP] + _TAIL,
    "bspline": [_INT, _INT] + _DIMS + [_PTRS, _VOIDP] + _TAIL,
    # kind, footprint, linearize, ndims, dims, starts, steps, columns, taps,
    # obs, out, n, blocks, stream
    "df64": [_INT, _INT, _INT] + _DIMS + [_VOIDP, _VOIDP, _PTRS, _VOIDP, _PTRS, _VOIDP,
                                          ctypes.c_longlong, _INT, _VOIDP],
    # kind, footprint, linearize, group, route, ndims, dims, starts, steps,
    # columns, pieces, ch, cl, sv, c0, obs, out, n, blocks, stream
    "i8": [_INT] * 5 + _DIMS + [_VOIDP, _VOIDP, _PTRS, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                                ctypes.c_double, _PTRS, _VOIDP, ctypes.c_longlong, _INT, _VOIDP],
}
_ARGTYPES = {s: (s.replace("fused_", "interpn_"), _FAMILY_ARGTYPES[s.split("_")[1]])
             for s in SOURCES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# the regular and rectilinear sources' other entries: method, is_f64, ndims,
# route, out[4] (`interpn_{regular,rectilinear}[_stack]_info`); is_f64,
# ndims, dims, vals, out, stream
# (`interpn_regular_pack`, `interpn_regular_cubic_pack`; the stack's takes
# nch before vals); is_f64, table,
# nch, vals, out, stream (`interpn_{regular,rectilinear}_stack_interleave`)
_ENTRY_ARGTYPES = {
    "_info": [_INT, _INT, _INT, _INT, ctypes.POINTER(_INT)],
    # footprint, ndims, out[4] (`interpn_df64_info`); footprint, ndims,
    # group, route, out[4] (`interpn_i8_info`)
    ("fused_df64", "_info"): [_INT, _INT, ctypes.POINTER(_INT)],
    ("fused_i8", "_info"): [_INT, _INT, _INT, _INT, ctypes.POINTER(_INT)],
    "_pack": [_INT, *_DIMS, _VOIDP, _VOIDP, _VOIDP],
    "_cubic_pack": [_INT, *_DIMS, _VOIDP, _VOIDP, _VOIDP],
    # is_f64, ndims, dims, nch, vals, out, stream
    ("fused_regular_stack", "_cubic_pack"): [_INT, *_DIMS, _INT, _VOIDP, _VOIDP, _VOIDP],
    "_interleave": [_INT, ctypes.c_longlong, _INT, _VOIDP, _VOIDP, _VOIDP],
}


@cache
def _fn(source: str, entry: str = ""):
    """The kernel entry `interpn_<family>[_stack]<entry>` of
    `csrc/<source>.cu`, built first if needed."""
    name, argtypes = _ARGTYPES[source]
    if entry:
        argtypes = _ENTRY_ARGTYPES.get((source, entry)) or _ENTRY_ARGTYPES[entry]
    fn = getattr(_build.load(source), name + entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@cache
def _launcher(source: str, entry: str = ""):
    """`_fn(source, entry)` inside a `launch` span: the ctypes call of a
    launch."""
    return tracing.traced(tracing.LAUNCH)(_fn(source, entry))


@cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _method(method: str) -> int:
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    return METHODS.index(method)


def _device(tensors) -> torch.device:
    """The one device of `tensors`; ValueError for a mix or a device with no
    kernel and no plain version."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError("grid, vals and obs tensors must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device


# --- the plain versions -------------------------------------------------------------


def plain_regular(dims, starts, steps, vals, obs, method="linear", linearize=True):
    """The gather tree that `eval_regular` launches the kernel of."""
    if method == "cubic":
        return cubic_regular(dims, starts, steps, vals, obs, linearize)
    plain = linear_regular if method == "linear" else nearest_regular
    return plain(dims, starts, steps, vals, obs)


def plain_pack(dims, vals):
    """The quads route's packed copy of a flat table (what `pack` launches
    the kernel of): (d0-1, 2) pairs (i, i+1) of a 1-D table, else
    (d0-1, d1-1, d2, ..., 4) quads whose slot a + 2b holds corner
    (i + a, j + b) of axes 0 and 1."""
    v = vals.reshape(dims)
    if len(dims) == 1:
        return torch.stack([v[:-1], v[1:]], dim=-1)
    return torch.stack([v[:-1, :-1], v[1:, :-1], v[:-1, 1:], v[1:, 1:]], dim=-1)


def plain_cubic_pack(dims, vals):
    """The taps routes' cubic pack of a flat table (what `cubic_pack`
    launches the kernel of): (d0-3, d1, ..., 4), cell (i, r...) slot a
    holding entry (i + a, r...), axis 0's four taps side by side."""
    v = vals.reshape(dims)
    last = dims[0] - 3
    return torch.stack([v[a:a + last] for a in range(4)], dim=-1)


def plain_cubic_stack_pack(dims, vals_stack):
    """The taps routes' cubic pack of an (nch, prod(dims)) stack (what
    `cubic_stack_pack` launches the kernel of): (nch, d0-3, d1, ..., 4),
    `plain_cubic_pack` of each table, table after table."""
    return _per_channel(lambda v: plain_cubic_pack(dims, v), vals_stack)


def plain_interleave(vals_stack):
    """The interleaved route's copy of an (nch, prod(dims)) stack (what
    `interleave` launches the kernel of): (prod(dims), nch), a corner's
    channels side by side."""
    return vals_stack.t().contiguous()


def gather_rectilinear(grids, vals, obs, method="linear", linearize=True):
    """The gather tree of a rectilinear method (`ops/linear.py`,
    `ops/cubic.py`, `ops/nearest.py`)."""
    if method == "cubic":
        return cubic_rectilinear(grids, vals, obs, linearize)
    plain = linear_rectilinear if method == "linear" else nearest_rectilinear
    return plain(grids, vals, obs)


def plain_rectilinear(grids, vals, obs, method="linear", linearize=True):
    """What `eval_rectilinear` launches the kernel of: the gather tree, but
    for cubic the weights and their contraction
    (`cubic.cubic_rectilinear_weighted`)."""
    if method == "cubic":
        return cubic_rectilinear_weighted(grids, vals, obs, linearize)
    return gather_rectilinear(grids, vals, obs, method)


def _per_channel(single, vals_stack):
    return torch.stack([single(v) for v in vals_stack])


def plain_regular_stack(dims, starts, steps, vals_stack, obs, method="linear",
                        linearize=True):
    """`plain_regular` over each table of the stack: (nch, *obs[0].shape)."""
    return _per_channel(
        lambda v: plain_regular(dims, starts, steps, v, obs, method, linearize), vals_stack)


def plain_rectilinear_stack(grids, vals_stack, obs, method="linear", linearize=True):
    """`plain_rectilinear` over each table of the stack, cubic's weights
    built once for all of them."""
    if method == "cubic":
        return cubic_rectilinear_weighted(grids, vals_stack, obs, linearize)
    return gather_rectilinear_stack(grids, vals_stack, obs, method)


def gather_rectilinear_stack(grids, vals_stack, obs, method="linear", linearize=True):
    """`gather_rectilinear` over each table of the stack."""
    return _per_channel(
        lambda v: gather_rectilinear(grids, v, obs, method, linearize), vals_stack)


plain_bspline = bspline_gather


def plain_bspline_stack(knots, coeffs_stack, obs, k: int):
    """`plain_bspline` over each coefficient table of the stack."""
    return _per_channel(lambda c: bspline_gather(knots, c, obs, k), coeffs_stack)


# --- the wrappers ---------------------------------------------------------------------


def eval_regular(dims, starts, steps, vals, obs, method="linear", linearize=True):
    """Evaluation on a regular grid, f32 or f64, 1-8D (cubic: every dim
    >= 4). Args as `ops.linear.linear_regular`; every obs entry is a 1-D
    tensor of the same length; `linearize` is the cubic method's
    `linearize_extrapolation`. Returns a new (n,) tensor."""
    return _regular(dims, starts, steps, vals, obs, method, linearize, stacked=False)


def eval_regular_stack(dims, starts, steps, vals_stack, obs, method="linear", linearize=True):
    """`eval_regular` over an (nch, prod(dims)) stack of tables: one locate
    per query for all of them. Returns a new (nch, n) tensor."""
    return _regular(dims, starts, steps, vals_stack, obs, method, linearize, stacked=True)


def regular_route(dims, dtype, method, nch=None, free=None) -> str:
    """The layout the regular kernel reads for a table of `dims` (a stack
    of `nch` tables; None for one table) in `dtype` by `method`, where
    `free` bytes of the tables' device are free (None: no bound), one of
    ROUTES: for a linear or nearest stack `_channel_route`'s; for one f32
    linear table 'staged' (within STAGE_BYTES, copied into shared memory by
    each block) or 'quads' (above that, packed copy within QUAD_BYTES); for
    one cubic table `_cubic_route`'s; for a cubic stack `_stack_route`'s:
    staged groups of tables within GROUP_BYTES each, else each table
    through its cubic pack where one such table would read its pack, the
    packs of the whole stack laid out each call within `free`, else
    'direct'; else 'direct' (linear f64 is never staged nor packed). A
    function of these arguments alone, and the only place the choice is
    made."""
    if method == "cubic":
        return (_cubic_route(dims, dtype) if nch is None
                else _stack_route(dims, dtype, nch, False, free))
    if nch is None:
        if method == "linear" and dtype == torch.float32:
            if math.prod(dims) * dtype.itemsize <= STAGE_BYTES:
                return "staged"
            if _packed_size(dims) * dtype.itemsize <= QUAD_BYTES:
                return "quads"
        return "direct"
    return _channel_route(dims, dtype, method, nch, free)


def rectilinear_route(dims, dtype, method, nch=None, free=None) -> str:
    """The layout the rectilinear kernel reads, as `regular_route` decides
    it for the regular one: for one cubic table `_cubic_route`'s, but one
    lane a query on the cubic pack from 2D ('taps'; four lanes ran 100^3 f32
    1.6x slower); for a cubic stack 'staged' where all its tables fit
    STAGE_BYTES, 'staged_tables' where each does (one table at a time in a
    double buffer), else 'interleaved' where `_interleaves` (f64 from 4D
    only above L1_BYTES), else 'direct'; for a linear or nearest stack
    `_channel_route`'s, K5's rule; for one linear or nearest table
    `_lerp_table_route`'s. `free` as `regular_route` takes it. A function
    of these arguments alone, and the only place the choice is made."""
    if method != "cubic":
        if nch is None:
            return _lerp_table_route(dims, dtype, method)
        return _channel_route(dims, dtype, method, nch, free)
    if nch is None:
        route = _cubic_route(dims, dtype)
        return "taps" if route == "tap_lanes" else route
    table = math.prod(dims) * dtype.itemsize
    if table * nch <= STAGE_BYTES:
        return "staged"
    if table <= STAGE_BYTES:
        return "staged_tables"
    wide = _interleaves(dims, dtype, nch, free) and (
        dtype == torch.float32 or len(dims) <= 3 or table > L1_BYTES)
    return "interleaved" if wide else "direct"


def bspline_route(dims, dtype, k, nch=None, free=None) -> str:
    """The layout the B-spline kernel of degree `k` reads for coefficient
    tables of `dims` in `dtype`: for one table 'staged_groups' (the one
    group of a table within GROUP_BYTES, staged in shared memory by each
    1024-thread block), else 'direct'; for a stack of `nch`
    `_stack_route`'s, `free` as `regular_route` takes it. A function of
    these arguments alone, and the only place the choice is made."""
    if k not in DEGREES:
        raise ValueError(f"spline degree must be one of {DEGREES}, got {k!r}")
    if nch is None:
        return "staged_groups" if math.prod(dims) * dtype.itemsize <= GROUP_BYTES else "direct"
    return _stack_route(dims, dtype, nch, True, free)


def _lerp_table_route(dims, dtype, method) -> str:
    """The route of one linear or nearest rectilinear table (K2, K3). Each
    block copies the grid columns into shared memory with their bucket
    starts and locates a query by its bucket and a bisection of that bucket
    alone (`csrc/rectilinear.cuh::guided_count`), in place of a bisection of
    each column from device memory, about log2(dim) dependent loads an axis.
    An f32 linear table is staged beside them ('staged') where table and
    guide fit STAGE_BYTES together, as K1 stages it: its 2^N corner reads
    then hit shared memory too. Else the guide alone ('guided', the table
    direct) where it fits COLUMN_BYTES, but for an f32 linear table above
    L1_BYTES at 3D or more, whose 8 or more corner reads a query from L2 set
    its pace: there the guide lost 4-29% (60^3, 100^3, 20^4) where it won
    7-40% on every other linear table timed, f64 100^3 and 8^5 and f32
    300^2 and 1000^2 among them, and 15-59% on every nearest one (H100,
    PERF.md). Else 'direct', bisecting each column from device memory."""
    f32_linear = method == "linear" and dtype == torch.float32
    if f32_linear and guide_fits("staged", dims, dtype):
        return "staged"
    big = f32_linear and len(dims) >= 3 and math.prod(dims) * dtype.itemsize > L1_BYTES
    return "guided" if guide_fits("guided", dims, dtype) and not big else "direct"


def guide_bytes(dims, dtype) -> int:
    """Bytes of the guided locate's shared memory (csrc/rectilinear.cuh):
    each axis's column and its 2 dim + 1 bucket starts (int32)."""
    return sum(d * dtype.itemsize + (2 * d + 1) * 4 for d in dims)


def guide_fits(route, dims, dtype) -> bool:
    """Whether one linear or nearest table of `dims` fits the reservation of
    `route` ('guided': the guide within COLUMN_BYTES; 'staged': the table,
    on a 16-byte boundary after its offset from one, and the guide within
    STAGE_BYTES), as the C side sums it and refuses more."""
    guide = guide_bytes(dims, dtype)
    if route == "staged":
        return (math.prod(dims) * dtype.itemsize + 31) // 16 * 16 + guide <= STAGE_BYTES + 16
    return guide <= COLUMN_BYTES


def _interleaves(dims, dtype, nch, free=None) -> bool:
    """Whether a stack of nch tables of `dims` is wide enough to read
    channel-interleaved (RUN_BYTES of channels an entry or more), its
    interleave small enough for int32 indices (below 2^31 entries; each
    table alone always is), and the interleaved copy, which the entry
    allocates each call beside the stack, within the `free` bytes of the
    tables' device (None: no bound), so that a stack the card holds never
    runs out of memory on this route where the direct one would not."""
    entries = nch * math.prod(dims)
    return (nch * dtype.itemsize >= RUN_BYTES and entries < _INT32_LIMIT
            and (free is None or entries * dtype.itemsize <= free))


def free_bytes(tensor) -> int | None:
    """Free bytes of a CUDA tensor's device now (`torch.cuda.mem_get_info`),
    None on another device."""
    if tensor.device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(tensor.device)[0]


def _channel_route(dims, dtype, method, nch, free=None) -> str:
    """The route of a linear or nearest stack of nch tables (K5, K6):
    'interleaved' where `_interleaves`; else 'staged' for an f32 linear
    stack of at most STAGE_BYTES in all (read table by table); else
    'direct'."""
    if _interleaves(dims, dtype, nch, free):
        return "interleaved"
    if (method == "linear" and dtype == torch.float32
            and math.prod(dims) * nch * dtype.itemsize <= STAGE_BYTES):
        return "staged"
    return "direct"


def _stack_route(dims, dtype, nch, interleave, free=None) -> str:
    """The route of a stack of nch cubic (K5) or B-spline (K7) tables:
    'staged_groups' where each table fits GROUP_BYTES. Above that, where
    `interleave` (K7, whose tree keeps one running sum a channel a level),
    'interleaved' where `_interleaves`, else 'direct'. K5, whose eight
    Hermite trees at once would not fit the registers, reads its tables one
    after another, each through its cubic pack on the route of
    `_cubic_route` ('taps' at 2D, 'tap_lanes' from 3D; neither at 1D, for a
    pack above TAP_BYTES, or for f64 tables of L1_BYTES or less together at
    2-3D), while the packs of all nch tables, which the entry lays
    out table after table each call ('regular_cubic_stack_pack'), hold
    fewer than 2^31 entries and fit the `free` bytes of the tables' device
    (None: no bound), so that a stack the card holds never runs out of
    memory on this route where 'direct' would not; else 'direct'. Against
    'direct', one lane running each table's whole tree, stacks of 8 ran
    2.1-8.8x ahead at 1e6 queries on an H100 (20^4 f64 3.564 against 13.82
    ms with the packs laid out; 31^3 f64, each table within L1_BYTES, 0.641
    against 2.217, and two such tables 1.7x), and the kernels 2.0-4.3x at
    1e4, where 8 x 40^3 f32, whose call is bound by the host, ran 15% behind
    back to back, its call ~15 us longer on the host (PERF.md,
    `scripts/torch_regular_ab.py`); one 31^3 f64 table read direct 6%
    ahead."""
    if math.prod(dims) * dtype.itemsize <= GROUP_BYTES:
        return "staged_groups"
    if interleave:
        return "interleaved" if _interleaves(dims, dtype, nch, free) else "direct"
    route = _cubic_route(dims, dtype, nch)
    pack = nch * _taps_size(dims)
    fits = pack < _INT32_LIMIT and (free is None or pack * dtype.itemsize <= free)
    return route if route in TAP_ROUTES and fits else "direct"


def _cubic_route(dims, dtype, nch=1) -> str:
    """The route of one cubic table (`nch` tables read one after another):
    the table staged in shared memory where it fits STAGE_BYTES; else, while
    its cubic pack fits TAP_BYTES, the pack read by one lane a query at 2D
    and four from 3D, but for f64 tables of L1_BYTES or less together at 2D
    or 3D; else (and at 1D, whose four taps lie side by side in the table
    already) the table itself."""
    table = math.prod(dims) * dtype.itemsize
    nd = len(dims)
    if table <= STAGE_BYTES:
        return "staged"
    if nd == 1 or _taps_size(dims) * dtype.itemsize > TAP_BYTES:
        return "direct"
    if dtype == torch.float64 and nd <= 3 and table * nch <= L1_BYTES:
        return "direct"
    return "taps" if nd == 2 else "tap_lanes"


def _taps_size(dims) -> int:
    """Entries of `plain_cubic_pack`'s copy."""
    return (dims[0] - 3) * math.prod(dims[1:]) * 4


def _layout_size(dims, route, vals) -> int | None:
    """Entries of the buffer that the entry lays the table (a stack: each
    table, (nch, prod(dims))) out in for `route`, None where the route reads
    `vals` as it is."""
    if route in TAP_ROUTES:
        return _taps_size(dims) * (vals.shape[0] if vals.dim() == 2 else 1)
    return {"quads": _packed_size(dims), "interleaved": vals.numel()}.get(route)


def _packed_shape(dims) -> tuple:
    """The shape of `plain_pack`'s copy."""
    if len(dims) == 1:
        return (dims[0] - 1, 2)
    return (dims[0] - 1, dims[1] - 1, *dims[2:], 4)


def _packed_size(dims) -> int:
    """Entries of `plain_pack`'s copy."""
    return math.prod(_packed_shape(dims))


def pack(dims, vals):
    """The quads route's packed copy of the flat table `vals` (f32 or f64,
    every dim >= 2), shaped as `plain_pack`'s: its kernel alone
    (`interpn_regular_pack`; `eval_regular` launches it with the kernel that
    reads it) on a CUDA tensor, `plain_pack` on a CPU one."""
    dims = tuple(int(d) for d in dims)
    if _device((vals,)).type == "cpu":
        return plain_pack(dims, vals)
    if not 1 <= len(dims) <= _MAX_DIMS or min(dims) < 2 or math.prod(dims) >= _INT32_LIMIT:
        raise ValueError(f"no packed copy of a grid of dims {dims}")
    return _launch_pack(PACK, dims, vals, _packed_shape(dims))


def cubic_pack(dims, vals):
    """The taps routes' cubic pack of the flat table `vals` (f32 or f64,
    dims[0] >= 4), shaped as `plain_cubic_pack`'s: its kernel alone
    (`interpn_regular_cubic_pack`; `eval_regular` launches it with the
    kernel that reads it) on a CUDA tensor, `plain_cubic_pack` on a CPU
    one."""
    dims = tuple(int(d) for d in dims)
    if _device((vals,)).type == "cpu":
        return plain_cubic_pack(dims, vals)
    if (not 1 <= len(dims) <= _MAX_DIMS or dims[0] < 4 or min(dims) < 1
            or _taps_size(dims) >= _INT32_LIMIT):
        raise ValueError(f"no cubic pack of a grid of dims {dims}")
    return _launch_pack(CUBIC_PACK, dims, vals, (dims[0] - 3, *dims[1:], 4))


def cubic_stack_pack(dims, vals_stack):
    """The taps routes' cubic pack of the (nch, prod(dims)) stack
    `vals_stack` (f32 or f64, dims[0] >= 4), shaped as
    `plain_cubic_stack_pack`'s: its kernel alone
    (`interpn_regular_stack_cubic_pack`; `eval_regular_stack` launches it
    with the kernel that reads it) on a CUDA tensor,
    `plain_cubic_stack_pack` on a CPU one."""
    dims = tuple(int(d) for d in dims)
    if _device((vals_stack,)).type == "cpu":
        return plain_cubic_stack_pack(dims, vals_stack)
    nch = int(vals_stack.shape[0]) if vals_stack.dim() == 2 else 0
    if (not 1 <= len(dims) <= _MAX_DIMS or dims[0] < 4 or min(dims) < 1 or nch == 0
            or nch * _taps_size(dims) >= _INT32_LIMIT):
        raise ValueError(f"no cubic pack of a stack of {nch} tables of dims {dims}")
    if vals_stack.shape != (nch, math.prod(dims)) or not vals_stack.is_contiguous():
        raise ValueError(f"vals_stack must be a contiguous (nch, {math.prod(dims)}) tensor")
    if vals_stack.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {vals_stack.dtype}")
    out = torch.empty((nch, dims[0] - 3, *dims[1:], 4), dtype=vals_stack.dtype,
                      device=vals_stack.device)
    with torch.cuda.device(vals_stack.device):
        rc = _launcher("fused_regular_stack", "_cubic_pack")(
            _is_f64(vals_stack), len(dims), (_INT * len(dims))(*dims), nch,
            vals_stack.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_regular_stack cubic pack launch failed: CUDA error {rc}")
    launches[CUBIC_STACK_PACK] += 1
    return out


def _launch_pack(name, dims, vals, shape):
    """Launch the pack `name` (PACK: `interpn_regular_pack`, CUBIC_PACK:
    `interpn_regular_cubic_pack`) of the flat CUDA table `vals` into a new
    tensor of `shape`; count the launch."""
    if vals.shape != (math.prod(dims),) or not vals.is_contiguous():
        raise ValueError(f"vals must be flat and contiguous with {math.prod(dims)} entries")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {vals.dtype}")
    out = torch.empty(shape, dtype=vals.dtype, device=vals.device)
    entry = name.removeprefix("regular")
    with torch.cuda.device(vals.device):
        rc = _launcher("fused_regular", entry)(
            _is_f64(vals), len(dims), (_INT * len(dims))(*dims), vals.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_regular{entry} launch failed: CUDA error {rc}")
    launches[name] += 1
    return out


def interleave(vals_stack, family="regular"):
    """The interleaved route's copy of the (nch, prod(dims)) stack
    `vals_stack` (f32 or f64), shaped as `plain_interleave`'s: its kernel
    alone (`interpn_regular_stack_interleave`, or the rectilinear source's
    `interpn_rectilinear_stack_interleave` for `family` "rectilinear";
    `eval_regular_stack` / `eval_rectilinear_stack` launch it with the
    kernel that reads it) on a CUDA tensor, `plain_interleave` on a CPU
    one."""
    names = {"regular": INTERLEAVE, "rectilinear": RECT_INTERLEAVE}
    if family not in names:
        raise ValueError(f"family must be one of {tuple(names)}, got {family!r}")
    if _device((vals_stack,)).type == "cpu":
        return plain_interleave(vals_stack)
    if vals_stack.dim() != 2 or not vals_stack.is_contiguous() or vals_stack.numel() == 0:
        raise ValueError("vals_stack must be a contiguous, non-empty (nch, prod(dims)) tensor")
    if vals_stack.numel() >= _INT32_LIMIT:
        raise ValueError(f"stack of {vals_stack.numel()} values needs int64 indices")
    if vals_stack.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {vals_stack.dtype}")
    nch, table = vals_stack.shape
    out = torch.empty((table, nch), dtype=vals_stack.dtype, device=vals_stack.device)
    source = f"fused_{family}_stack"
    with torch.cuda.device(vals_stack.device):
        rc = _launcher(source, "_interleave")(
            _is_f64(vals_stack), table, nch, vals_stack.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{source} interleave launch failed: CUDA error {rc}")
    launches[names[family]] += 1
    return out


def regular_info(method, dtype, ndims, route, stacked=False, family="regular") -> dict:
    """Registers a thread, static shared bytes, local (spill) bytes a thread
    and resident blocks an SM (with the route's reservation of dynamic
    shared memory: the largest staged table on the staged route) of the
    regular (`family` "rectilinear": the rectilinear; "bspline": the
    B-spline, `method` its degree) kernel's instantiation for (method,
    dtype, ndims, route), one table's or a stack's, on the current CUDA
    device."""
    got = (_INT * 4)()
    source = _name(f"fused_{family}", stacked)
    head = int(method) if family == "bspline" else _method(method)
    rc = _fn(source, "_info")(head, int(dtype == torch.float64), ndims, ROUTES.index(route),
                              got)
    if rc != 0:
        raise RuntimeError(f"{source} info failed: CUDA error {rc}")
    return dict(zip(("registers", "static_smem", "local_bytes", "blocks_per_sm"), got))


@tracing.traced(tracing.ROUTE)
def _chosen(rule, dims, vals, method, stacked) -> str:
    """The route that `rule` (`regular_route`, `rectilinear_route`,
    `bspline_route`; `method` a B-spline's degree) picks for this call, a
    stack's with the free bytes of its device now."""
    if stacked:
        return rule(dims, vals.dtype, method, int(vals.shape[0]), free_bytes(vals))
    return rule(dims, vals.dtype, method)


@tracing.traced(tracing.WRAPPER)
def _regular(dims, starts, steps, vals, obs, method, linearize, *, stacked):
    _method(method)  # refuses an unknown method on every device
    dims = tuple(int(d) for d in dims)
    obs = tuple(obs)
    if _device((vals, starts, steps, *obs)).type == "cpu":
        plain = plain_regular_stack if stacked else plain_regular
        return plain(dims, starts, steps, vals, obs, method, linearize)
    n = _check(dims, starts, steps, vals, obs, method, stacked)
    route = _chosen(regular_route, dims, vals, method, stacked)
    return _relaid_launch("regular", route, STACK_LAYOUTS if stacked else LAYOUTS, dims, vals,
                          obs, method, linearize, n, stacked, starts.data_ptr(), steps.data_ptr())


def _relaid_launch(family, route, layouts, dims, vals, obs, method, linearize, n, stacked,
                   *grid_args):
    """Launch the `family` source's entry on `route`, with the buffer its
    layout kernel (`layouts[route]`) fills first, which the entry then
    reads; count the launches. `grid_args` come before the buffer.
    `method` is a B-spline's degree."""
    size = _layout_size(dims, route, vals)
    if size is not None and size >= _INT32_LIMIT:
        raise ValueError(f"the {route} layout of {size} values needs int64 indices")
    layout = layouts.get(route) if n else None
    work = None
    if layout:  # the entry lays the table out in this buffer, then reads it
        work = torch.empty(size, dtype=vals.dtype, device=vals.device)
    if family == "bspline":
        kernel, head = f"bspline_k{method}", (method, _is_f64(vals))
    else:
        kernel = f"{family}_{method}"
        head = (_method(method), int(bool(linearize)), _is_f64(vals))
    out = _launch(
        _name(f"fused_{family}", stacked), _name(kernel, stacked), head, dims, vals, obs, n,
        stacked, *grid_args, None if work is None else work.data_ptr(), route=route,
    )
    if layout:
        launches[layout] += 1
    return out


def eval_rectilinear(grids, vals, obs, method="linear", linearize=True):
    """Evaluation on a rectilinear grid, f32 or f64, 1-8D (cubic: every
    axis >= 4 entries). `grids` holds one sorted 1-D tensor per axis; the
    rest as `eval_regular`. Returns a new (n,) tensor."""
    return _rectilinear(grids, vals, obs, method, linearize, stacked=False)


def eval_rectilinear_stack(grids, vals_stack, obs, method="linear", linearize=True):
    """`eval_rectilinear` over an (nch, prod(dims)) stack of tables. Returns
    a new (nch, n) tensor."""
    return _rectilinear(grids, vals_stack, obs, method, linearize, stacked=True)


@tracing.traced(tracing.WRAPPER)
def _rectilinear(grids, vals, obs, method, linearize, *, stacked):
    _method(method)  # refuses an unknown method on every device
    grids = tuple(grids)
    obs = tuple(obs)
    if _device((vals, *grids, *obs)).type == "cpu":
        plain = plain_rectilinear_stack if stacked else plain_rectilinear
        return plain(grids, vals, obs, method, linearize)
    n = _check_rectilinear(grids, vals, obs, method, stacked)
    dims = tuple(int(g.shape[0]) for g in grids)
    route = _chosen(rectilinear_route, dims, vals, method, stacked)
    return _relaid_launch("rectilinear", route, RECT_LAYOUTS, dims, vals, obs, method,
                          linearize, n, stacked,
                          (_VOIDP * len(grids))(*(g.data_ptr() for g in grids)))


def eval_bspline(knots, coeffs, obs, k: int):
    """Tensor-product B-spline of degree k (3 or 5), f32 or f64, 1-8D.
    `knots` holds one not-a-knot vector per axis (dim + k + 1 entries, from
    `ops.bspline.prep_bspline`); `coeffs` the flat C-order coefficient
    table. Returns a new (n,) tensor."""
    return _bspline(knots, coeffs, obs, k, stacked=False)


def eval_bspline_stack(knots, coeffs_stack, obs, k: int):
    """`eval_bspline` over an (nch, prod(dims)) stack of coefficient tables:
    one weight build per query for all of them. Returns a new (nch, n)
    tensor."""
    return _bspline(knots, coeffs_stack, obs, k, stacked=True)


@tracing.traced(tracing.WRAPPER)
def _bspline(knots, coeffs, obs, k, *, stacked):
    if k not in DEGREES:
        raise ValueError(f"spline degree must be one of {DEGREES}, got {k!r}")
    knots = tuple(knots)
    obs = tuple(obs)
    if _device((coeffs, *knots, *obs)).type == "cpu":
        plain = plain_bspline_stack if stacked else plain_bspline
        return plain(knots, coeffs, obs, k)
    if any(t.dim() != 1 for t in knots):
        raise ValueError("knots must be 1-D tensors, one per dim")
    dims = tuple(int(t.shape[0]) - k - 1 for t in knots)
    n = _check_common(dims, coeffs, obs, knots, k + 1, stacked)
    route = _chosen(bspline_route, dims, coeffs, k, stacked)
    return _relaid_launch("bspline", route, BSPLINE_LAYOUTS, dims, coeffs, obs, k, None, n,
                          stacked, (_VOIDP * len(knots))(*(t.data_ptr() for t in knots)))


def _need(method: str) -> int:
    return 4 if method == "cubic" else 2


def _check(dims, starts, steps, vals, obs, method="linear", stacked=False) -> int:
    n = _check_common(dims, vals, obs, (starts, steps), _need(method), stacked)
    if starts.shape != (len(dims),) or steps.shape != (len(dims),):
        raise ValueError("starts, steps and obs must have one entry per dim")
    return n


def _check_rectilinear(grids, vals, obs, method="linear", stacked=False) -> int:
    if any(g.dim() != 1 for g in grids):
        raise ValueError("grids must be 1-D tensors, one per dim")
    dims = tuple(int(g.shape[0]) for g in grids)
    return _check_common(dims, vals, obs, grids, _need(method), stacked)


def _name(name: str, stacked: bool) -> str:
    return f"{name}_stack" if stacked else name


def _is_f64(vals) -> int:
    return int(vals.dtype == torch.float64)


def _check_common(dims, vals, obs, params, need, stacked) -> int:
    """Refuse what the kernels do not take (a stack's vals are
    (nch, prod(dims)), a single table's flat); return the query count."""
    ndims = len(dims)
    if not 1 <= ndims <= _MAX_DIMS:
        raise ValueError(f"ndims must be in 1..{_MAX_DIMS}, got {ndims}")
    if len(obs) != ndims:
        raise ValueError("grid parameters and obs must have one entry per dim")
    if min(dims) < need:
        raise ValueError(f"every dim needs at least {need} points, got {dims}")
    size = math.prod(dims)
    if size >= _INT32_LIMIT:
        raise ValueError(f"grid of {size} points needs int64 indices")
    nch = int(vals.shape[0]) if stacked and vals.dim() == 2 else 1
    if vals.shape != ((nch, size) if stacked else (size,)):
        want = f"(nch, {size})" if stacked else f"flat with {size} entries"
        raise ValueError(f"vals must be {want}, got {tuple(vals.shape)}")
    dtype = vals.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {dtype}")
    n = obs[0].shape[0] if obs[0].dim() == 1 else -1
    for t in (*params, vals, *obs):
        if t.dtype != dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs vals {dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if any(o.dim() != 1 or o.shape[0] != n for o in obs):
        raise ValueError("obs must be 1-D tensors of one length")
    if n >= _INT32_LIMIT:
        raise ValueError(f"{n} queries need int64 indices")
    return n


def _launch(source, kernel, head, dims, vals, obs, n, stacked, *grid_args, route):
    """Launch `csrc/<source>.cu` on `route` on the current stream; count the
    launch."""
    nch = int(vals.shape[0]) if stacked else 1
    out = torch.empty((nch, n) if stacked else (n,), dtype=vals.dtype, device=vals.device)
    if n == 0 or nch == 0:
        return out
    ndims = len(dims)
    index = vals.device.index
    if index is None:
        index = torch.cuda.current_device()
    with torch.cuda.device(index):
        rc = _launcher(source)(
            *head,
            ndims,
            (_INT * ndims)(*dims),
            *grid_args,
            vals.data_ptr(),
            (_VOIDP * ndims)(*(o.data_ptr() for o in obs)),
            out.data_ptr(),
            n,
            nch,
            ROUTES.index(route),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {rc}")
    launches[kernel] += 1
    return out


# --- K8 and K9: the f64 engines -------------------------------------------------------

_I8_THREADS = 128  # kI8Threads in csrc/fused_i8.cu: four warps of 32 queries
# K9's routes (kI8Mma, kI8Dp4a in csrc/fused_i8.cu): the piece products of
# each stencil row by the int8 tensor cores (32 queries a warp) or by
# `__dp4a` (a thread a query)
I8_ROUTES = ("mma", "dp4a")
# K9 takes the dp4a route where the trailing stencil (footprint^group
# entries) has at most this many entries, the mma route above
# (kDp4aEntries in csrc/fused_i8.cu, which builds each shape on its one
# route): dp4a ran linear and cubic 20^3 1.3-1.8x faster than the MMAs
# there, which staged each query's entries for the warp
DP4A_ENTRIES = 16


def i8_route(footprint, group) -> str:
    """K9's route for a trailing stencil of footprint^group entries, one of
    I8_ROUTES: 'dp4a' within DP4A_ENTRIES, else 'mma'. A function of these
    arguments alone, and the only place the choice is made."""
    return "dp4a" if footprint**group <= DP4A_ENTRIES else "mma"


def _check_engine(kind, dims, grid, obs, footprint, footprints) -> tuple[int, tuple]:
    """Refuse what K8/K9 do not take; return the query count and the grid's
    three C arguments (starts, steps, columns)."""
    ndims = len(dims)
    if kind not in GRID_KINDS:
        raise ValueError(f"grid kind must be one of {GRID_KINDS}, got {kind!r}")
    if not 2 <= ndims <= _MAX_DIMS:
        raise ValueError(f"ndims must be in 2..{_MAX_DIMS}, got {ndims}")
    if footprint not in footprints or min(dims) < footprint:
        raise ValueError(f"footprint {footprint} does not fit dims {dims}")
    if math.prod(dims) >= _INT32_LIMIT:
        raise ValueError(f"grid of {math.prod(dims)} points needs int64 indices")
    if len(obs) != ndims or len(grid) != (2 if kind == "regular" else ndims):
        raise ValueError("grid parameters and obs must have one entry per dim")
    n = int(obs[0].shape[0]) if obs[0].dim() == 1 else -1
    if kind == "regular" and any(t.shape != (ndims,) for t in grid):
        raise ValueError("starts and steps must have one entry per dim")
    if kind == "rectilinear" and tuple(int(g.shape[0]) for g in grid) != dims:
        raise ValueError(f"grid axes must have {dims} entries")
    if kind == "bspline" and tuple(int(t.shape[0]) for t in grid) != tuple(
            d + footprint for d in dims):
        raise ValueError(f"knot vectors must have dims + {footprint} entries")
    for t in (*grid, *obs):
        if t.dtype != torch.float64 or not t.is_contiguous() or t.dim() != 1:
            raise ValueError("grid and obs must be contiguous 1-D float64 tensors")
    if any(o.shape[0] != n for o in obs):
        raise ValueError("obs must be 1-D tensors of one length")
    if n >= _INT32_LIMIT:
        raise ValueError(f"{n} queries need int64 indices")
    if kind == "regular":
        return n, (grid[0].data_ptr(), grid[1].data_ptr(), None)
    return n, (None, None, (_VOIDP * ndims)(*(t.data_ptr() for t in grid)))


def _check_table(name, t, shape, dtype):
    if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _launch_engine(source, head, dims, grid_args, tables, obs, n, threads, device):
    out = torch.empty(n, dtype=torch.float64, device=device)
    if n == 0:
        return out
    index = device.index if device.index is not None else torch.cuda.current_device()
    blocks = min(-(-n // threads), _sm_count(index) * _BLOCKS_PER_SM * _THREADS // threads)
    with torch.cuda.device(index):
        rc = _launcher(source)(
            *head, len(dims), (_INT * len(dims))(*dims), *grid_args, *tables,
            (_VOIDP * len(dims))(*(o.data_ptr() for o in obs)), out.data_ptr(), n, blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {rc}")
    launches[source.removeprefix("fused_")] += 1
    return out


def launch_df64(kind, dims, grid, taps, obs, footprint, linearize=True):
    """Launch K8 (`csrc/fused_df64.cu`) on CUDA tensors: `kind` one of
    GRID_KINDS, `grid` (starts, steps) for a regular grid, else one sorted
    float64 column per axis (the axes, or the knot vectors of a spline of
    degree footprint - 1), the table's packed hi/lo taps (`ops.df64.
    table_taps`), `obs` ndims flat float64 queries; returns the (n,)
    float64 result. The wrapper with a plain version is
    `ops.df64.eval_regular` (`eval_rectilinear`, `eval_bspline`)."""
    dims = tuple(int(d) for d in dims)
    grid, obs = tuple(grid), tuple(obs)
    device = _device((taps, *grid, *obs))
    n, grid_args = _check_engine(kind, dims, grid, obs, footprint, (2, 4, 6))
    if kind != "bspline" and footprint == 6 or kind == "bspline" and footprint == 2:
        raise ValueError(f"no {kind} evaluation of footprint {footprint}")
    rows = math.prod(dims[:-1]) * (dims[-1] - footprint + 1)
    _check_table("taps", taps, (rows, 2 * footprint), torch.float32)
    return _launch_engine("fused_df64", (GRID_KINDS.index(kind), footprint, int(bool(linearize))),
                          dims, grid_args, (taps.data_ptr(),), obs, n, _THREADS, device)


def launch_i8(kind, dims, grid, prep, obs, footprint, linearize, group):
    """Launch K9 (`csrc/fused_i8.cu`) on CUDA tensors: `kind` 'regular' or
    'rectilinear' and `grid`, `obs` as `launch_df64`'s; `prep` the table's
    `ops.i8.prepare` (cell-major (prod(dims), 8) int8 pieces, (lead,)
    float32 row centres hi/lo and scales, the float centre c0) for the
    trailing-axis group `group`; returns the (n,) float64 result, on
    `i8_route`'s route. The wrapper with a plain version is
    `ops.i8.eval_regular` (`eval_rectilinear`)."""
    dims = tuple(int(d) for d in dims)
    grid, obs = tuple(grid), tuple(obs)
    pieces, ch, cl, sv, c0 = prep
    device = _device((pieces, ch, cl, sv, *grid, *obs))
    if kind == "bspline":
        raise ValueError("K9 evaluates regular and rectilinear grids")
    n, grid_args = _check_engine(kind, dims, grid, obs, footprint, (2, 4))
    if not 1 <= group < len(dims) or footprint**group > 2048 and group > 1:
        raise ValueError(f"group {group} does not fit dims {dims}")
    lead = (math.prod(dims[: len(dims) - group]),)
    _check_table("pieces", pieces, (math.prod(dims), 8), torch.int8)
    for name, t in (("ch", ch), ("cl", cl), ("sv", sv)):
        _check_table(name, t, lead, torch.float32)
    head = (GRID_KINDS.index(kind), footprint, int(bool(linearize)), group,
            I8_ROUTES.index(i8_route(footprint, group)))
    return _launch_engine(
        "fused_i8", head, dims, grid_args,
        (*(t.data_ptr() for t in (pieces, ch, cl, sv)), float(c0)), obs, n, _I8_THREADS, device)


def engine_info(engine, footprint, ndims, group=None) -> dict:
    """Registers a thread, shared bytes a block, local (spill) bytes a
    thread and resident blocks an SM of K8's (`engine` 'df64') or K9's
    ('i8', with its trailing-axis group, on `i8_route`'s route)
    instantiation, on the current CUDA device."""
    got = (_INT * 4)()
    source = f"fused_{engine}"
    if engine == "df64":
        args = (footprint, ndims)
    else:
        args = (footprint, ndims, group, I8_ROUTES.index(i8_route(footprint, group)))
    rc = _fn(source, "_info")(*args, got)
    if rc != 0:
        raise RuntimeError(f"{source} info failed: CUDA error {rc}")
    return dict(zip(("registers", "shared_bytes", "local_bytes", "blocks_per_sm"), got))
