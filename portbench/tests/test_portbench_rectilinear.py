"""The rectilinear grid kind and its reference: the jittered nodes from the
seed, the reference against the regular one on unjittered nodes, at nodes,
on affine and quadratic data, and what it imports."""

import ast
import itertools
import shutil
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.grids import rectilinear as rect_grid  # noqa: E402
from portbench.grids import regular as reg_grid  # noqa: E402
from portbench.reference import rectilinear, regular  # noqa: E402

DIMS = [(5,), (4, 6), (6, 4, 5), (4, 5, 4, 6)]


def _cfg(dims, rng, jitter):
    starts = rng.uniform(-2, 1, len(dims))
    return {"dims": list(dims), "starts": list(starts),
            "stops": list(starts + rng.uniform(0.5, 4, len(dims))),
            "axes": {"kind": "jittered", "jitter": jitter}}


def _queries(rng, cfg, n=500, outside=0.2):
    """(N, n) queries in the grid's box, a share `outside` of them beyond it
    on one axis by up to half the box."""
    lo, hi = np.array(cfg["starts"]), np.array(cfg["stops"])
    x = rng.uniform(lo, hi, (n, len(lo)))
    k = int(n * outside)
    axis = rng.integers(0, len(lo), k)
    by = rng.uniform(1e-3, 0.5, k) * (hi - lo)[axis]
    x[np.arange(k), axis] = np.where(rng.random(k) < 0.5, lo[axis] - by, hi[axis] + by)
    return torch.tensor(x.T.copy())


def _rect(method, cfg, tables, obs, linearize=True):
    coords, = rect_grid.reference_args(rect_grid.make(cfg, 5, np.float64), torch.float64, "cpu")
    return rectilinear.evaluate(method, cfg["dims"], coords, tables, obs, linearize)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


@pytest.mark.parametrize("method,dims,linearize", [
    *itertools.product(["linear"], DIMS, [True]),
    *itertools.product(["cubic"], DIMS, [True, False]),
])
def test_unjittered_nodes_give_the_regular_reference(method, dims, linearize):
    rng = _rng("regular", method, dims, linearize)
    cfg = _cfg(dims, rng, 0.0)
    tables = torch.tensor(rng.uniform(-1, 1, (2, int(np.prod(dims)))))
    obs = _queries(rng, cfg)
    starts, steps = reg_grid.reference_args(reg_grid.make(cfg, 5, np.float64), torch.float64,
                                            "cpu")
    want = regular.evaluate(method, dims, starts, steps, tables, obs, linearize)
    got = _rect(method, cfg, tables, obs, linearize)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-13


@pytest.mark.parametrize("method,linearize", [("linear", True), ("cubic", True),
                                              ("cubic", False)])
@pytest.mark.parametrize("dims", DIMS[1:])
def test_nodes_give_the_table_within_one_rounding(method, linearize, dims):
    rng = _rng("nodes", method, dims, linearize)
    cfg = _cfg(dims, rng, 0.6)
    coords = rect_grid.make(cfg, 5, np.float64)["coords"]
    table = rng.uniform(-1, 1, int(np.prod(dims)))
    nodes = np.stack(np.meshgrid(*coords, indexing="ij")).reshape(len(dims), -1)
    got = _rect(method, cfg, torch.tensor(table[None]), torch.tensor(nodes), linearize)[0]
    assert np.all(np.abs(got.numpy() - table) <= np.spacing(np.abs(table)))


@pytest.mark.parametrize("method,linearize", [("linear", True), ("cubic", True),
                                              ("cubic", False)])
@pytest.mark.parametrize("dims", DIMS)
def test_affine_data_is_reproduced_inside_and_outside(method, linearize, dims):
    rng = _rng("affine", method, dims, linearize)
    cfg = _cfg(dims, rng, 0.8)
    coords = rect_grid.make(cfg, 5, np.float64)["coords"]
    a = rng.uniform(-2, 2, len(dims) + 1)
    mesh = np.meshgrid(*coords, indexing="ij")
    table = a[0] + sum(a[k + 1] * mesh[k] for k in range(len(dims)))
    obs = _queries(rng, cfg)
    want = a[0] + (torch.tensor(a[1:])[:, None] * obs).sum(0)
    got = _rect(method, cfg, torch.tensor(table.reshape(1, -1)), obs, linearize)[0]
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-13


@pytest.mark.parametrize("dims", DIMS)
def test_cubic_reproduces_quadratics_without_linearizing(dims):
    """Non-uniform centred slopes are exact on quadratics, so the interior
    cubic and the edge quadratics are the data's own polynomial, also
    beyond the grid where the quadratic continues."""
    rng = _rng("quadratic", dims)
    cfg = _cfg(dims, rng, 0.8)
    coords = rect_grid.make(cfg, 5, np.float64)["coords"]
    c = rng.uniform(-1, 1, (len(dims), 3))

    def f(xs):
        return np.prod([c[k, 0] + c[k, 1] * x + c[k, 2] * x * x for k, x in enumerate(xs)],
                       axis=0)

    table = f(np.meshgrid(*coords, indexing="ij"))
    obs = _queries(rng, cfg)
    want = f(list(obs.numpy()))
    got = _rect("cubic", cfg, torch.tensor(table.reshape(1, -1)), obs, False)[0].numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_jittered_nodes_come_from_the_seed_alone():
    cfg = {"dims": [20, 7], "starts": [0.0, -1.0], "stops": [10.0, 2.0],
           "axes": {"kind": "jittered", "jitter": 0.4}}
    a, b = (rect_grid.make(cfg, 2**31 + 977, np.float64)["coords"] for _ in range(2))
    c = rect_grid.make(cfg, 2**31 + 978, np.float64)["coords"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    for x, start, stop, dim in zip(a, cfg["starts"], cfg["stops"], cfg["dims"]):
        h = (stop - start) / (dim - 1)
        u = (x - start) / h - np.arange(dim)
        assert u[0] == 0 and abs(u[-1]) < 1e-12 and np.all(np.abs(u) <= 0.2 + 1e-12)
        assert np.all(np.diff(x) > 0.6 * h - 1e-12)
    f32 = rect_grid.make(cfg, 2**31 + 977, np.float32)["coords"]
    assert all(x.dtype == np.float32 and np.array_equal(x, y.astype(np.float32))
               for x, y in zip(f32, a))


@pytest.mark.parametrize("axes", [{"kind": "jittered", "jitter": 1.0},
                                  {"kind": "jittered", "jitter": -0.1},
                                  {"kind": "chebyshev"}])
def test_an_axes_recipe_outside_the_kind_is_refused(axes):
    with pytest.raises(ValueError):
        rect_grid.make({"dims": [5], "starts": [0.0], "stops": [1.0], "axes": axes}, 1,
                       np.float64)


def test_the_nodes_draw_nothing_from_the_tables_generator(tmp_path):
    """A rectilinear configuration's tables and queries are those of the same
    configuration with unjittered nodes: the nodes' stream is their own."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    folder = tmp_path / "portbench"
    for jitter in (0.0, 0.4):
        (folder / "configs" / f"r{jitter}.json").write_text(
            '{"grid": "rectilinear", "method": "cubic", "dims": [5, 6, 4],'
            ' "starts": [0, 0, 0], "stops": [1, 2, 3], "dtype": "float64",'
            ' "axes": {"kind": "jittered", "jitter": %s},'
            ' "table": {"kind": "uniform", "low": 0, "high": 1}}' % jitter)
        (folder / "cells" / f"r{jitter}.bulk.json").write_text(
            '{"mix": {"queries_per_step": 100}, "limits": {"max_err": 1e-12}}')
    (tmp_path / "BENCHMARK.json").write_text(
        '{"workloads": [%s], "end_to_end": [], "per_layer": []}' % ", ".join(
            '{"name": "r%s.bulk", "config": "r%s", "traffic": "bulk", "chips": 1}' % (j, j)
            for j in (0.0, 0.4)))
    a, b = (harness.make_problem(harness.load_cell(tmp_path / "BENCHMARK.json", folder,
                                                   f"r{j}.bulk"), 77, torch.device("cpu"))
            for j in (0.0, 0.4))
    assert torch.equal(a.tables, b.tables)
    assert all(torch.equal(x, y) for x, y in zip(a.ring, b.ring))
    assert not np.array_equal(a.arrays["coords"][0], b.arrays["coords"][0])


@pytest.mark.parametrize("module", ["regular", "rectilinear"])
def test_each_reference_imports_only_torch_math_or_numpy(tmp_path, module):
    shutil.copy(ROOT / "portbench" / "reference" / f"{module}.py", tmp_path)
    names = harness.reference_imports(tmp_path)
    assert names and set(names) <= {"__future__", "math", "numpy", "torch"}
    tree = ast.parse((tmp_path / f"{module}.py").read_text())
    siblings = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level}
    assert siblings <= {"regular"}  # a sibling under reference/, which the same guard scans
