"""Evaluation over several devices: the observation axis split over a mesh.

Counterpart of `interpn_tpu/parallel/sharding.py`. The scaling axis is the
number of queries:

* A mesh is a tuple of `torch.device`s, one axis (OBS_AXIS); `make_mesh()`
  takes every CUDA device. An entry may repeat a device: a mesh of four
  `cuda:0` entries splits the queries into four launches on one card.
* Queries are split along the obs axis into contiguous chunks, one per
  mesh entry in mesh order (`obs_sharding`, `shard_obs`); the grid and
  table are replicated, one copy on each distinct device (`replicated`),
  made once at build time by the prepared evaluators.
* Each shard runs the single-device `ops` function on its own device: one
  kernel launch per shard, launched back to back without a sync, so that
  several cards overlap. Outputs stay on their devices: an evaluator
  returns `Shards`, the per-shard results in mesh order, the counterpart
  of the JAX package's one array sharded `P("obs")` (`P(None, "obs")` for
  a stack); `Shards.concat(device)` puts them together on a device the
  caller names. Nothing is copied between devices after build, the
  counterpart of "zero collectives".

Each shard's result is the single-device call's on its chunk of the
queries, so the concatenated shards are that call's result bit for bit
(every query's result depends on that query alone).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import ops
from ..ops import bspline as _bspline
from ..ops import df64 as _df64
from ..ops import dispatch as _dispatch

OBS_AXIS = "obs"
_FLOOR = {"pchip": 4, "cubic_spline": 4, "quintic": 6}
_DEGREE = {"cubic_spline": 3, "quintic": 5}


class Shards(tuple):
    """Per-shard tensors in mesh order, each on its mesh entry's device,
    split along the last (obs) axis."""

    def concat(self, device) -> torch.Tensor:
        """The shards joined along the obs axis on `device`."""
        return torch.cat([s.to(device) for s in self], dim=-1)


def make_mesh(devices=None) -> tuple[torch.device, ...]:
    """A 1-D mesh over `devices` (default: every CUDA device). A tuple of
    devices has no axis names: its one axis is OBS_AXIS. Without a CUDA
    device and without `devices` it raises RuntimeError: ask for CPU
    entries with `make_mesh(["cpu"] * 8)`."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device; to split over CPU entries, pass them, "
                "e.g. make_mesh(['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return mesh


class Sharding(NamedTuple):
    """How an array lies on a mesh: split along its last (obs) axis into
    one contiguous chunk per mesh entry, or whole on each entry."""

    mesh: tuple
    split: bool

    def place(self, x, dtype=None) -> Shards:
        """`x` (numpy or a tensor) on the mesh in `dtype` (default its
        own): the chunks, or one copy per distinct device shared by the
        entries on it (none made where `x` is already there)."""
        x = torch.as_tensor(x, dtype=dtype)
        if not self.split:
            copies = {}
            for d in self.mesh:
                if d not in copies:
                    copies[d] = x.to(d).contiguous()
            return Shards(copies[d] for d in self.mesh)
        n, parts = int(x.shape[-1]), len(self.mesh)
        if n % parts:
            raise ValueError(f"{n} observations do not split over {parts} mesh entries; "
                             "pad them with pad_to_multiple")
        c = n // parts
        return Shards(x[..., s * c:(s + 1) * c].to(d).contiguous()
                      for s, d in enumerate(self.mesh))


def obs_sharding(mesh) -> Sharding:
    """Split along the obs axis (the JAX package's `P("obs")`)."""
    return Sharding(tuple(mesh), True)


def replicated(mesh) -> Sharding:
    """Whole on every entry (the JAX package's `P()`)."""
    return Sharding(tuple(mesh), False)


def shard_obs(obs, mesh) -> tuple[Shards, ...]:
    """The observation arrays split along the obs axis over the mesh, one
    `Shards` each. Lengths must be divisible by the mesh size (pad first;
    `pad_to_multiple` helps)."""
    sharding = obs_sharding(mesh)
    return tuple(sharding.place(x) for x in obs)


def pad_to_multiple(x, multiple: int):
    """(x padded at the end with its last value to a multiple of
    `multiple`, its length before): numpy arrays and tensors. Edge padding
    keeps the padded queries inside the grid's numeric range; slice the
    output back to the returned length."""
    n = int(x.shape[0])
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(rem)]), n
    return np.pad(np.asarray(x), (0, rem), mode="edge"), n


def _per_shard(mesh, obs, dtype) -> list[tuple]:
    """Per mesh entry, its chunk of every obs array in `dtype`: `Shards`
    (from `shard_obs`) as they are, anything else split here."""
    sharding = obs_sharding(mesh)
    per_dim = []
    for x in obs:
        if not isinstance(x, Shards):
            x = sharding.place(x)
        if len(x) != len(mesh):
            raise ValueError(f"obs has {len(x)} shards for a mesh of {len(mesh)} entries")
        per_dim.append([s.to(dtype) for s in x])
    return list(zip(*per_dim))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _require_dims(dims, name: str):
    if dims is None:
        raise TypeError(
            f"{name}(regular=True) requires dims=: pass the grid shape, with "
            "grid_arrays=(starts, steps)")
    return tuple(int(d) for d in dims)


def _host_grids(grid_arrays, dims, regular):
    """(dims, float64-ready host axes): a regular grid's rebuilt from its
    starts and steps."""
    if regular:
        starts, steps = _host(grid_arrays[0]), _host(grid_arrays[1])
        return dims, [starts[i] + steps[i] * np.arange(d) for i, d in enumerate(dims)]
    host = [_host(g) for g in grid_arrays]
    return tuple(len(g) for g in host), host


_METHODS = {
    ("linear", True): lambda dims, g, v, obs, lin: ops.linear_regular(dims, g[0], g[1], v, obs),
    ("nearest", True): lambda dims, g, v, obs, lin: ops.nearest_regular(dims, g[0], g[1], v,
                                                                        obs),
    ("cubic", True): lambda dims, g, v, obs, lin: ops.cubic_regular(dims, g[0], g[1], v, obs,
                                                                    lin),
    ("linear", False): lambda dims, g, v, obs, lin: ops.linear_rectilinear(g, v, obs),
    ("nearest", False): lambda dims, g, v, obs, lin: ops.nearest_rectilinear(g, v, obs),
    ("cubic", False): lambda dims, g, v, obs, lin: ops.cubic_rectilinear(g, v, obs, lin),
    # pchip needs no host prep (its slopes are a function of the table), so
    # it also has this form; the global splines exist only prepared
    ("pchip", True): lambda dims, g, v, obs, lin: ops.pchip_regular(dims, g[0], g[1], v, obs),
    ("pchip", False): lambda dims, g, v, obs, lin: ops.pchip_rectilinear(g, v, obs),
}


def _run(mesh, fn, grid_r, vals_r, obs, dtype) -> Shards:
    """fn(grid, vals, obs chunk) on each mesh entry's replicas, in mesh
    order, with no sync between the launches."""
    chunks = _per_shard(mesh, obs, dtype)
    return Shards(fn(tuple(g[s] for g in grid_r), vals_r[s], chunks[s])
                  for s in range(len(mesh)))


def sharded_evaluator(mesh, *, method: str = "linear", regular: bool = True,
                      linearize_extrapolation: bool = True):
    """An evaluator over the mesh, the grid and table passed at each call.

    Returns ``f(grid_arrays, vals, obs, dims=None) -> Shards``: for a
    regular grid ``grid_arrays = (starts, steps)`` and ``dims=`` the grid
    shape; for a rectilinear one the per-axis grid arrays. Numpy or
    tensors; the grid and the queries are taken in the table's dtype. The
    grid and table are put on each distinct device of the mesh at each
    call (none is copied where it is already there); `obs` is split over
    the mesh unless it is `shard_obs`'s output already.
    """
    kernel = _METHODS[(method, regular)]
    mesh = tuple(mesh)
    rep = replicated(mesh)

    def f(grid_arrays, vals, obs, dims=None):
        if regular:
            dims = _require_dims(dims, "sharded_evaluator")
        vals_r = rep.place(vals)
        dtype = vals_r[0].dtype
        grid_r = [rep.place(g, dtype) for g in grid_arrays]
        return _run(mesh, lambda g, v, o: kernel(dims, g, v, o, linearize_extrapolation),
                    grid_r, vals_r, obs, dtype)

    return f


def prepared_evaluator(mesh, grid_arrays, vals, *, dims=None, method: str = "linear",
                       regular: bool = True, linearize_extrapolation: bool = True):
    """An evaluator over the mesh for one concrete grid and table.

    For ``regular=True`` ``grid_arrays`` is ``(starts, steps)`` and
    ``dims=`` is required; for ``regular=False`` it is the per-axis grid
    arrays. The grid and table are replicated to each distinct device of
    the mesh here, once; returns ``f(obs) -> Shards``.

    The port's dispatch decides each call as on one device (the JAX
    package's `dispatch.i8_route`, batch floor and extrapolation-depth
    gate have no counterpart here). What this build hoists out of the call
    is the table preparation of a forced f64 engine: where INTERPN_TPU_F64,
    read now, sends the route to K9 (i8) or K8 (df64), each replica's
    `i8.prepare` or `df64.table_split` and K8's taps are made here, so a
    call under the same setting only finds them in the per-table caches.
    Elsewhere it hoists nothing. pchip and the global splines go to
    `_prepared_extension`.
    """
    if method in _FLOOR:
        return _prepared_extension(mesh, grid_arrays, vals, dims=dims, method=method,
                                   regular=regular)
    mesh = tuple(mesh)
    rep = replicated(mesh)
    vals_r = rep.place(vals)
    dtype = vals_r[0].dtype
    grid_r = [rep.place(g, dtype) for g in grid_arrays]
    if regular:
        dims = _require_dims(dims, "prepared_evaluator")
    else:
        dims = tuple(int(g[0].shape[0]) for g in grid_r)
    for v in {id(v): v for v in vals_r}.values():  # one replica a distinct device
        if _dispatch.f64_route(v, dims, method)[0] == "df64":
            _df64.table_taps(v, dims, _df64.FOOTPRINT[method])
    kernel = _METHODS[(method, regular)]
    return lambda obs: _run(
        mesh, lambda g, v, o: kernel(dims, g, v, o, linearize_extrapolation),
        grid_r, vals_r, obs, dtype)


def _prepared_extension(mesh, grid_arrays, vals, *, dims, method, regular):
    """`prepared_evaluator` for pchip and the global splines: the splines'
    not-a-knot collocation solve runs on the host here, once (in float64,
    through the content-keyed prep cache, as `interpn()`), and the
    coefficients are replicated in the table's dtype; pchip replicates its
    grid and table. Each shard evaluates `ops.bspline_eval` (K4) or the
    pchip gather tree on its chunk."""
    mesh = tuple(mesh)
    rep = replicated(mesh)
    if regular:
        dims = _require_dims(dims, "prepared_evaluator")
    vals = _host(vals)
    dims, host_grids = _host_grids(grid_arrays, dims, regular)
    if vals.size != int(np.prod(dims)):
        raise AssertionError("Dimension mismatch")
    floor = _FLOOR[method]
    if any(d < floor for d in dims):
        raise AssertionError(f"All grids must have at least {floor} entries")
    dtype = torch.as_tensor(vals).dtype
    if method == "pchip":
        vals_r = rep.place(vals.ravel())
        grid_r = [rep.place(g, dtype) for g in (
            [_host(g) for g in grid_arrays] if regular else host_grids)]
        pchip = _METHODS[("pchip", regular)]

        def fn(g, v, o):
            return pchip(dims, g, v, o, True)
    else:
        k = _DEGREE[method]
        knots, coeffs = _bspline.prep_bspline_cached(
            host_grids, vals.astype(np.float64, copy=False).ravel(), k)
        grid_r = [rep.place(t, dtype) for t in knots]
        vals_r = rep.place(coeffs, dtype)

        def fn(g, v, o):
            return ops.bspline_eval(g, v, o, k)
    return lambda obs: _run(mesh, fn, grid_r, vals_r, obs, dtype)


_STACKS = {
    ("linear", True): lambda dims, g, v, o, lin: ops.linear_regular_stack(dims, g[0], g[1],
                                                                          v, o),
    ("nearest", True): lambda dims, g, v, o, lin: ops.nearest_regular_stack(dims, g[0], g[1],
                                                                            v, o),
    ("cubic", True): lambda dims, g, v, o, lin: ops.cubic_regular_stack(dims, g[0], g[1], v,
                                                                        o, lin),
    ("linear", False): lambda dims, g, v, o, lin: ops.linear_rectilinear_stack(g, v, o),
    ("nearest", False): lambda dims, g, v, o, lin: ops.nearest_rectilinear_stack(g, v, o),
    ("cubic", False): lambda dims, g, v, o, lin: ops.cubic_rectilinear_stack(g, v, o, lin),
}


def prepared_stack_evaluator(mesh, grid_arrays, vals, *, dims=None, method: str = "linear",
                             regular: bool = True, linearize_extrapolation: bool = True):
    """`interpn_stack`'s device core over the mesh: nch tables on one grid,
    replicated once per distinct device, at each shard's chunk of the
    queries. Returns ``f(obs) -> Shards`` of (nch, chunk) results.

    `vals` carries the channel axis first, (nch, prod(dims)) or
    (nch, *dims). Linear, nearest and cubic run the family's stack kernel
    (K5, K6) once per shard; the splines solve their coefficients on the
    host here, once, and run K7; pchip is not linear in the table, so its
    channels are evaluated one by one and stacked, as the JAX package
    vmaps them.
    """
    mesh = tuple(mesh)
    rep = replicated(mesh)
    if regular:
        dims = _require_dims(dims, "prepared_stack_evaluator")
    vals = _host(vals)
    dims, host_grids = _host_grids(grid_arrays, dims, regular)
    if vals.ndim < 2:
        raise AssertionError("Dimension mismatch")
    nch = vals.shape[0]
    vals2 = vals.reshape(nch, -1)
    dtype = torch.as_tensor(vals2).dtype
    if method in _FLOOR and any(d < _FLOOR[method] for d in dims):
        raise AssertionError(f"All grids must have at least {_FLOOR[method]} entries")
    if method in _DEGREE:
        k = _DEGREE[method]
        knots, coeffs = _bspline.prep_bspline_cached(
            host_grids, np.ascontiguousarray(vals2.T, dtype=np.float64), k)
        grid_r = [rep.place(t, dtype) for t in knots]
        vals_r = rep.place(np.ascontiguousarray(coeffs.T), dtype)

        def fn(g, v, o):
            return ops.bspline_eval_stack(g, v, o, k)
    else:
        vals_r = rep.place(vals2)
        grid_r = [rep.place(g, dtype) for g in (
            [_host(g) for g in grid_arrays] if regular else host_grids)]
        if method == "pchip":
            pchip = _METHODS[("pchip", regular)]

            def fn(g, v, o):
                return torch.stack([pchip(dims, g, v[c], o, True) for c in range(nch)])
        else:
            stack = _STACKS[(method, regular)]

            def fn(g, v, o):
                return stack(dims, g, v, o, linearize_extrapolation)
    return lambda obs: _run(mesh, fn, grid_r, vals_r, obs, dtype)
