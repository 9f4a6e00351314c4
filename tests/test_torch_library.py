"""The kernels' custom ops (`interpn_tpu_torch/ops/library.py`) on the CPU.

`torch.library.opcheck` on each op with small CPU inputs (schema, fake
implementation, the dispatcher's checks); each op's CPU result bitwise
equal to the plain version it wraps, on every family, form and method, and
under each forced f64 engine; the engine argument taken as given (no
environment read at the op); the per-table caches built once across calls
through the op; the fake implementations' shapes; `kernel_route` building
its kernel callables from the ops.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from interpn_tpu_torch import config
from interpn_tpu_torch.ops import bspline, df64, dispatch, fused, i8, library

DIMS = (5, 4, 6)
N = 40
NCH = 3
METHODS = ("linear", "cubic", "nearest")


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


def _regular(dtype=torch.float64, nch=None, seed=0):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-1, 1, len(DIMS))
    steps = rng.uniform(0.3, 1.0, len(DIMS))
    shape = (nch, math.prod(DIMS)) if nch else (math.prod(DIMS),)
    vals = rng.standard_normal(shape)
    obs = [rng.uniform(starts[k] - 0.5, starts[k] + steps[k] * DIMS[k], N)
           for k in range(len(DIMS))]
    t = [torch.tensor(a, dtype=dtype) for a in (starts, steps, vals, *obs)]
    return list(DIMS), t[0], t[1], t[2], t[3:]


def _rectilinear(dtype=torch.float64, nch=None, seed=1):
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d)) for d in DIMS]
    shape = (nch, math.prod(DIMS)) if nch else (math.prod(DIMS),)
    vals = rng.standard_normal(shape)
    obs = [rng.uniform(g[0] - 0.5, g[-1] + 0.5, N) for g in grids]
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return [t(g) for g in grids], t(vals), [t(o) for o in obs]


def _bspline(k, dtype=torch.float64, nch=None, seed=2):
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d + 2)) for d in DIMS]
    dims = tuple(len(g) for g in grids)
    vals = rng.standard_normal((nch, math.prod(dims)) if nch else math.prod(dims))
    if nch:
        knots, coeffs = bspline.prep_bspline(grids, np.ascontiguousarray(vals.T), k)
        coeffs = np.ascontiguousarray(coeffs.T)
    else:
        knots, coeffs = bspline.prep_bspline(grids, vals, k)
    obs = [rng.uniform(g[0] - 0.3, g[-1] + 0.3, N) for g in grids]
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    return [t(kn) for kn in knots], t(coeffs), [t(o) for o in obs]


def _cases():
    """(id, op, args, plain): every op and method with its plain version's
    call on the same arguments."""
    cases = []
    for dtype in (torch.float32, torch.float64):
        s = str(dtype).split(".")[-1]
        for m in METHODS:
            d, st, sp, v, ob = _regular(dtype)
            cases.append((f"regular-{m}-{s}", library.regular,
                          (d, st, sp, v, ob, m, False, "native"),
                          lambda d=d, st=st, sp=sp, v=v, ob=ob, m=m: fused.plain_regular(
                              tuple(d), st, sp, v, tuple(ob), m, False)))
            d, st, sp, v, ob = _regular(dtype, NCH)
            cases.append((f"regular_stack-{m}-{s}", library.regular_stack,
                          (d, st, sp, v, ob, m, True),
                          lambda d=d, st=st, sp=sp, v=v, ob=ob, m=m: fused.plain_regular_stack(
                              tuple(d), st, sp, v, tuple(ob), m, True)))
            g, v, ob = _rectilinear(dtype)
            cases.append((f"rectilinear-{m}-{s}", library.rectilinear,
                          (g, v, ob, m, True, "native"),
                          lambda g=g, v=v, ob=ob, m=m: fused.plain_rectilinear(
                              tuple(g), v, tuple(ob), m, True)))
            g, v, ob = _rectilinear(dtype, NCH)
            cases.append((f"rectilinear_stack-{m}-{s}", library.rectilinear_stack,
                          (g, v, ob, m, False),
                          lambda g=g, v=v, ob=ob, m=m: fused.plain_rectilinear_stack(
                              tuple(g), v, tuple(ob), m, False)))
        for k in (3, 5):
            kt, c, ob = _bspline(k, dtype)
            cases.append((f"bspline-k{k}-{s}", library.bspline, (kt, c, ob, k, "native"),
                          lambda kt=kt, c=c, ob=ob, k=k: fused.plain_bspline(
                              tuple(kt), c, tuple(ob), k)))
            kt, c, ob = _bspline(k, dtype, NCH)
            cases.append((f"bspline_stack-k{k}-{s}", library.bspline_stack, (kt, c, ob, k),
                          lambda kt=kt, c=c, ob=ob, k=k: fused.plain_bspline_stack(
                              tuple(kt), c, tuple(ob), k)))
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cpu_result_is_the_plain_version(case):
    _, op, args, plain = case
    got = op(*args)
    want = plain()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


OPCHECK = [c for c in CASES if c[0].endswith("float64")]


@pytest.mark.parametrize("case", OPCHECK, ids=[c[0] for c in OPCHECK])
def test_opcheck(case):
    _, op, args, _ = case
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", library.NAMES)
def test_fake_shapes(name):
    """The fake implementations give (n,), or (nch, n) for a stack, on the
    table's device in its dtype, without running the wrapper."""
    stacked = name.endswith("_stack")
    case = next(c for c in CASES if c[0].split("-")[0] == name)
    args = case[2]
    with FakeTensorMode() as mode:
        fake = [[mode.from_tensor(t) for t in a] if isinstance(a, list) and a
                and isinstance(a[0], torch.Tensor) else
                mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        out = getattr(library, name)(*fake)
    assert tuple(out.shape) == ((NCH, N) if stacked else (N,))
    assert out.dtype == torch.float32 and out.device.type == "cpu"


def test_overload_is_the_registered_op():
    for name in library.NAMES:
        assert library.overload(name) is getattr(torch.ops.interpn_tpu_torch, name).default


def test_unknown_engine_raises():
    d, st, sp, v, ob = _regular()
    with pytest.raises(ValueError, match="engine must be one of"):
        library.regular(d, st, sp, v, ob, "linear", True, "gather")


@pytest.fixture
def engines(monkeypatch):
    """CPU tensors taken for CUDA ones, and K8's and K9's contractions
    counting their calls."""
    calls = []

    def wrap(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    monkeypatch.setattr(df64, "contract", wrap("df64", df64.contract))
    monkeypatch.setattr(i8, "contract", wrap("i8", i8.contract))
    monkeypatch.delenv(dispatch.F64_ENV, raising=False)
    return calls


ENGINE_CASES = [("regular", "linear"), ("regular", "cubic"), ("rectilinear", "cubic"),
                ("rectilinear", "linear")]


@pytest.mark.parametrize("engine", ["df64", "i8"])
@pytest.mark.parametrize("family,method", ENGINE_CASES)
def test_forced_engine_is_the_engines_plain_chain(engines, monkeypatch, family, method,
                                                   engine):
    """The op asked for an engine runs that engine's plain chain on a
    finite f64 table, bitwise, whatever INTERPN_TPU_F64 says now (set to
    the other engine here): the engine rides in the call."""
    other = "i8" if engine == "df64" else "df64"
    monkeypatch.setenv(dispatch.F64_ENV, other)
    module = df64 if engine == "df64" else i8
    if family == "regular":
        d, st, sp, v, ob = _regular()
        got = library.regular(d, st, sp, v, ob, method, True, engine)
        want = module.plain_regular(tuple(d), st, sp, v, tuple(ob), method, True)
    else:
        g, v, ob = _rectilinear()
        got = library.rectilinear(g, v, ob, method, True, engine)
        want = module.plain_rectilinear(tuple(g), v, tuple(ob), method, True)
    assert engines == [engine, engine]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("engine", ["df64", "i8"])
def test_forced_engine_bspline_is_k8(engines, engine):
    kt, c, ob = _bspline(3)
    got = library.bspline(kt, c, ob, 3, engine)
    want = df64.plain_bspline(tuple(kt), c, tuple(ob), 3)
    assert engines == ["df64", "df64"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("engine", ["df64", "i8"])
def test_engine_declined_runs_native(engines, engine):
    """A table with a NaN, an f32 table and nearest keep the native
    wrapper under an engine argument."""
    d, st, sp, v, ob = _regular()
    v = v.clone()
    v[3] = float("nan")
    for args in ((d, st, sp, v, ob, "cubic", True, engine),
                 (*_regular(torch.float32)[:5], "linear", True, engine),
                 (*_regular()[:5], "nearest", True, engine)):
        engines.clear()
        got = library.regular(*args)
        want = fused.plain_regular(tuple(args[0]), *args[1:4], tuple(args[4]), args[5], True)
        assert engines == []
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_native_engine_ignores_the_environment(engines, monkeypatch):
    monkeypatch.setenv(dispatch.F64_ENV, "df64")
    d, st, sp, v, ob = _regular()
    library.regular(d, st, sp, v, ob, "cubic", True, "native")
    assert engines == []


@pytest.mark.parametrize("engine", ["df64", "i8"])
def test_engine_preparation_built_once_across_calls(engines, monkeypatch, engine):
    """Through the op, the table's split or decomposition is made at the
    first call and found in the per-table cache at the next."""
    built = []
    for cache in (df64._SPLITS, df64._TAPS, i8._PREPS):
        monkeypatch.setattr(cache, "entries", {})

        def get(vals, extra, build, _cache=cache, _get=cache.get):
            return _get(vals, extra, lambda: built.append(_cache) or build())

        monkeypatch.setattr(cache, "get", get)
    d, st, sp, v, ob = _regular(seed=5)
    for _ in range(3):
        library.regular(d, st, sp, v, ob, "cubic", True, engine)
    assert built == [df64._SPLITS if engine == "df64" else i8._PREPS]
    assert engines == [engine] * 3


def test_kernel_route_calls_the_ops(monkeypatch):
    """`kernel_route`'s kernel callables (single and stack, each family)
    are the custom ops: a spy on each op's wrapper sees one call."""
    calls = []
    for name in ("eval_regular", "eval_regular_stack", "eval_rectilinear",
                 "eval_rectilinear_stack", "eval_bspline", "eval_bspline_stack"):
        fn = getattr(fused, name)
        monkeypatch.setattr(fused, name, lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    d, st, sp, v, ob = _regular()
    route = dispatch.kernel_route("regular", "cubic", tuple(d), False)
    route.kernel(st, sp, v, *ob)
    route.stack.kernel(st, sp, v[None].expand(2, -1).contiguous(), *ob)
    g, v, ob = _rectilinear()
    route = dispatch.kernel_route("rectilinear", "linear", len(g))
    route.kernel(*g, v, *ob)
    route.stack.kernel(*g, v[None].expand(2, -1).contiguous(), *ob)
    kt, c, ob = _bspline(3)
    route = dispatch.kernel_route("bspline", 3, len(kt))
    route.kernel(*kt, c, *ob)
    route.stack.kernel(*kt, c[None].expand(2, -1).contiguous(), *ob)
    assert calls == ["eval_regular", "eval_regular_stack", "eval_rectilinear",
                     "eval_rectilinear_stack", "eval_bspline", "eval_bspline_stack"]


def test_export_records_each_kernel_op(monkeypatch):
    """`torch.export` of a kernel route (CPU tensors taken for CUDA ones)
    records the family's op as one node, with the engine INTERPN_TPU_F64
    forces at trace time: the node keeps it."""
    monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    monkeypatch.setenv(dispatch.F64_ENV, "df64")
    d, st, sp, v, ob = _regular()

    class Regular(torch.nn.Module):
        def forward(self, *o):
            return dispatch.cubic_regular(tuple(d), st, sp, v, o, True)

    program = torch.export.export(Regular(), tuple(ob))
    nodes = [n for n in program.graph.nodes if n.target == library.overload("regular")]
    assert len(nodes) == 1 and nodes[0].args[-1] == "df64"

    g, v, ob = _rectilinear(torch.float32)

    class Rect(torch.nn.Module):
        def forward(self, *o):
            return dispatch.nearest_rectilinear(tuple(g), v, o)

    program = torch.export.export(Rect(), tuple(ob))
    nodes = [n for n in program.graph.nodes if n.target == library.overload("rectilinear")]
    assert len(nodes) == 1 and nodes[0].args[-1] == "native"
