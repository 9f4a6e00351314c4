"""The port's persistent interpolator classes (`interpn_tpu_torch.models`)
against the JAX package's on the CPU, built through both packages from the
same numpy arrays made from a seed.

Bars: nearest exact; values at f64 rtol = atol = 1e-13 * s and f32 1e-5 * s,
s = max(1, max|table|), where a B-spline's table is its coefficients (its
error scales with them, as tests/test_torch_bspline.py holds); gradients at
the same bars with s = max(1, max|gradient|). `.eval_torch` is bitwise the
port's `ops` call on the same tensors, and `raw`'s result; JSON bytes equal
the JAX package's and `tests/data/api_surface.json`'s golden models. The
queries reach a tenth of the span past each edge (f32 queries far out
amplify the rounding of the edge polynomials, and the JAX package's jitted
program may contract multiply-adds into FMAs).
"""

import copy
import json
import math
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("pydantic")

import interpn_tpu as it  # noqa: E402
import interpn_tpu_torch as tt  # noqa: E402
from interpn_tpu_torch import config, convert, ops, raw  # noqa: E402
from interpn_tpu_torch.models._device import DeviceInterpolator  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "api_surface.json"
BAR = {np.float32: 1e-5, np.float64: 1e-13}
DIMS = (7, 6, 8)
SPLINE_K = {"cubic_spline": 3, "quintic": 5}
CASES = [
    ("MultilinearRegular", {}), ("MulticubicRegular", {}),
    ("MulticubicRegular", {"linearize_extrapolation": False}), ("NearestRegular", {}),
    ("MultilinearRectilinear", {}), ("MulticubicRectilinear", {}), ("NearestRectilinear", {}),
    *((f"TensorSpline{kind}", {"method": m}) for kind in ("Regular", "Rectilinear")
      for m in ("pchip", "cubic_spline", "quintic")),
]


def _id(case):
    name, kw = case
    return "-".join([name, *(str(v) for v in kw.values())])


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")  # the JAX package's device path
    with config.device("cpu"):
        yield


def _arrays(dtype, seed=0, n=200):
    """(regular args, rectilinear args, regular queries, rectilinear queries)
    as numpy arrays of `dtype`."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-1, 1, len(DIMS)).astype(dtype)
    steps = rng.uniform(0.3, 1.0, len(DIMS)).astype(dtype)
    vals = rng.standard_normal(math.prod(DIMS)).astype(dtype)
    grids = [np.cumsum(0.3 + rng.random(d)).astype(dtype) for d in DIMS]
    axes = [s + h * np.arange(d) for s, h, d in zip(starts, steps, DIMS)]

    def queries(ax):
        return [rng.uniform(a[0] - 0.1 * (a[-1] - a[0]), a[-1] + 0.1 * (a[-1] - a[0]), n)
                .astype(dtype) for a in ax]

    return (list(DIMS), starts, steps, vals), (grids, vals), queries(axes), queries(grids)


def _models(case, dtype, seed=0):
    """(JAX model, port model, queries, the arrays it was built from)."""
    name, kw = case
    reg, rect, obs_reg, obs_rect = _arrays(dtype, seed)
    args, obs = (reg, obs_reg) if "Regular" in name else (rect, obs_rect)
    return (getattr(it, name).new(*args, **kw), getattr(tt, name).new(*args, **kw), obs, args)


def _ops_call(case, args, obs_t):
    """The port's `ops` call a class of `case` makes, on tensors made from
    the same arrays independently of the class."""
    name, kw = case
    dtype = torch.from_numpy(args[-1]).dtype
    cpu = torch.device("cpu")
    method = kw.get("method") or {"Multilinear": "linear", "Multicubic": "cubic",
                                  "Nearest": "nearest"}[re.match("[A-Z][a-z]+", name)[0]]
    regular = "Regular" in name
    if method in SPLINE_K:
        if regular:
            dims, starts, steps, vals = args
            axes = [s + h * np.arange(d) for s, h, d in
                    zip(starts.astype(np.float64), steps.astype(np.float64), dims)]
        else:
            axes, vals = [g.astype(np.float64) for g in args[0]], args[1]
        knots, coeffs = ops.prep_bspline(axes, vals.astype(np.float64), SPLINE_K[method])
        kt, ct = convert.bspline_from_numpy(knots, coeffs, device=cpu, dtype=dtype)
        return ops.bspline_eval(kt, ct, obs_t, SPLINE_K[method]), float(np.abs(coeffs).max())
    lin = (kw.get("linearize_extrapolation", True),) if method == "cubic" else ()
    if regular:
        dims, st, sp, v = convert.regular_grid_from_numpy(*args, device=cpu, dtype=dtype)
        res = getattr(ops, f"{method}_regular")(dims, st, sp, v, obs_t, *lin)
    else:
        g, v = convert.rectilinear_grid_from_numpy(*args, device=cpu, dtype=dtype)
        res = getattr(ops, f"{method}_rectilinear")(g, v, obs_t, *lin)
    return res, float(np.abs(args[-1]).max())


def _bar(dtype, scale):
    b = BAR[dtype] * max(1.0, scale)
    return dict(rtol=b, atol=b)


@pytest.mark.parametrize("case", CASES, ids=_id)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_class_matches_jax(case, dtype):
    """`.eval` against the JAX package's `.eval`; `.eval_torch` bitwise the
    `ops` call (and `raw`'s result for a reference class); the JSON bytes
    equal and parsed back; `.gradient_torch` against `.gradient_jax`;
    `check_bounds` the same flags."""
    jm, tm, obs, args = _models(case, dtype)
    js = jm.model_dump_json()
    assert tm.model_dump_json() == js
    back = type(tm).model_validate_json(js)
    assert back.model_dump_json() == js

    obs_t = tuple(torch.from_numpy(o) for o in obs)
    want_t, scale = _ops_call(case, args, obs_t)
    got_t = tm.eval_torch(obs_t)
    assert got_t.dtype == want_t.dtype and got_t.shape == (len(obs[0]),)
    torch.testing.assert_close(got_t, want_t, rtol=0, atol=0, equal_nan=True)

    got = tm.eval(obs)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, got_t.numpy())
    np.testing.assert_array_equal(back.eval(obs), got)
    if "Nearest" in case[0]:
        np.testing.assert_array_equal(got, jm.eval(obs))
    else:
        np.testing.assert_allclose(got, jm.eval(obs), **_bar(dtype, scale))
    if not case[0].startswith("TensorSpline"):
        kind = "regular" if "Regular" in case[0] else "rectilinear"
        method = re.match("[A-Z][a-z]+", case[0])[0]
        method = {"Multilinear": "linear", "Multicubic": "cubic", "Nearest": "nearest"}[method]
        fn = getattr(raw, f"interpn_{method}_{kind}_{'f32' if dtype == np.float32 else 'f64'}")
        lin = (case[1].get("linearize_extrapolation", True),) if method == "cubic" else ()
        out = np.zeros(len(obs[0]), dtype)
        fn(*args, *lin, obs, out)
        np.testing.assert_array_equal(got, out)

    g_jax = [np.asarray(g) for g in jm.gradient_jax(obs)]
    g_port = tm.gradient_torch(obs)
    assert len(g_port) == len(DIMS)
    gscale = max(float(np.abs(g).max()) for g in g_jax)
    for k, (a, b) in enumerate(zip(g_port, g_jax)):
        np.testing.assert_allclose(a.numpy(), b, **_bar(dtype, gscale), err_msg=f"axis {k}")

    flags = tm.check_bounds(obs, 1e-8)
    assert flags.all()  # the queries reach past each edge
    np.testing.assert_array_equal(flags, jm.check_bounds(obs, 1e-8))
    inside = [np.full(3, np.median(o), dtype) for o in obs]
    assert not tm.check_bounds(inside, 1e-8).any()


def test_golden_json_bytes():
    """The nine golden models of tests/data/api_surface.json: the port parses
    each and dumps the same bytes, and a port model built with `.new()`
    from the JAX model's arrays dumps them too."""
    golden = json.loads(GOLDEN.read_text())["golden_json"]
    assert len(golden) == 9
    for name, js in golden.items():
        cls_name = name.removesuffix("_f32")
        port = getattr(tt, cls_name).model_validate_json(js)
        assert port.model_dump_json() == js, name
        jm = getattr(it, cls_name).model_validate_json(js)
        fields = {k: getattr(jm, k) for k in type(jm).model_fields}
        if "grids" in fields:
            args = ([g.data for g in fields["grids"]], fields["vals"].data)
        else:
            args = (fields["dims"], fields["starts"].data, fields["steps"].data,
                    fields["vals"].data)
        kw = {k: fields[k] for k in ("method", "linearize_extrapolation") if k in fields}
        assert getattr(tt, cls_name).new(*args, **kw).model_dump_json() == js, name


@pytest.mark.parametrize("case", [CASES[1], CASES[7], CASES[11]], ids=_id)
def test_pickle_after_eval_scrubs_the_device_side(case):
    jm, tm, obs, _ = _models(case, np.float64, seed=3)
    before = tm.eval(obs)
    assert tm._dev is not None
    clone = pickle.loads(pickle.dumps(tm))
    assert clone._dev is None
    np.testing.assert_array_equal(clone.eval(obs), before)
    assert clone.model_dump_json() == tm.model_dump_json()
    np.testing.assert_array_equal(copy.deepcopy(tm).eval(obs), before)


def test_second_call_reuses_the_cached_tables():
    """The grid and table go to the device once, at the first evaluation;
    `warmup` puts them there ahead of it."""
    _, tm, obs, _ = _models(CASES[0], np.float32)
    tm.warmup(16)
    cached = tm._dev.tensors("cpu")
    ptrs = [t.data_ptr() for t in cached]
    tm.eval(obs)
    tm.eval_torch(tuple(torch.from_numpy(o) for o in obs))
    assert tm._dev.tensors("cpu") is cached
    assert [t.data_ptr() for t in cached] == ptrs


def _undersized():
    z2 = np.zeros(2)
    return [
        ("MultilinearRegular", ([1], np.zeros(1), np.ones(1), np.zeros(1)), {}),
        ("MultilinearRectilinear", ([np.array([0.0])], np.zeros(1)), {}),
        ("MulticubicRegular", ([3, 3], z2, np.ones(2), np.zeros(9)), {}),
        ("MulticubicRectilinear", ([np.array([0.0, 1.0, 2.0])], np.zeros(3)), {}),
        ("NearestRegular", ([1], np.zeros(1), np.ones(1), np.zeros(1)), {}),
        ("NearestRectilinear", ([np.array([0.0])], np.zeros(1)), {}),
        ("TensorSplineRectilinear", ([np.arange(3.0), np.arange(3.0)], np.zeros(9)),
         {"method": "pchip"}),
        ("TensorSplineRectilinear", ([np.arange(5.0), np.arange(7.0)], np.zeros(35)),
         {"method": "quintic"}),
        ("TensorSplineRegular", ([3, 4], z2, np.ones(2), np.zeros(12)),
         {"method": "cubic_spline"}),
    ]


@pytest.mark.parametrize("name,args,kw", _undersized(), ids=lambda x: x if isinstance(x, str)
                         else None)
def test_undersized_grid_raises_at_eval_not_construction(name, args, kw):
    jm = getattr(it, name).new(*args, **kw)
    tm = getattr(tt, name).new(*args, **kw)  # construction accepts it
    obs = [np.array([0.5])] * tm.ndims()
    for jmeth, tmeth in (("eval", "eval"), ("eval_unchecked", "eval_unchecked"),
                         ("eval_jax", "eval_torch"), ("gradient_jax", "gradient_torch")):
        with pytest.raises(AssertionError) as want:
            getattr(jm, jmeth)(obs)
        with pytest.raises(AssertionError) as got:
            getattr(tm, tmeth)(obs)
        assert str(got.value) == str(want.value), tmeth


def _bad_evals():
    """(id, call(model)) on a 2D MultilinearRegular f64 model that both
    packages refuse alike."""
    f32 = np.float32
    obs = [np.full(10, 0.5), np.full(10, 0.5)]
    return [
        ("out-size", lambda m: m.eval(obs, np.zeros(7))),
        ("obs-sizes", lambda m: m.eval([np.full(10, 0.5), np.full(9, 0.5)])),
        ("too-few-obs", lambda m: m.eval([np.full(10, 0.5)])),
        ("too-many-obs", lambda m: m.eval(obs + [np.full(10, 0.5)])),
        ("obs-f32", lambda m: m.eval([o.astype(f32) for o in obs])),
        ("out-f32", lambda m: m.eval(obs, np.zeros(10, f32))),
        ("unchecked-obs-f32", lambda m: m.eval_unchecked([o.astype(f32) for o in obs])),
        ("nan", lambda m: m.eval([np.array([np.nan]), np.array([0.5])])),
        ("inf", lambda m: m.eval_unchecked([np.array([0.5]), np.array([np.inf])],
                                           np.zeros(1))),
        ("far", lambda m: m.eval([np.array([1e300]), np.array([0.5])])),
        ("bounds-f32", lambda m: m.check_bounds([o.astype(f32) for o in obs], 1e-8)),
        ("torch-obs-sizes", lambda m: m.eval_jax([np.full(10, 0.5), np.full(9, 0.5)])
         if hasattr(m, "eval_jax") else m.eval_torch([np.full(10, 0.5), np.full(9, 0.5)])),
    ]


@pytest.mark.parametrize("call", [c for _, c in _bad_evals()], ids=[i for i, _ in _bad_evals()])
def test_eval_errors_match_jax(call):
    args = ([5, 5], np.zeros(2), np.full(2, 0.25), np.arange(25.0))
    with pytest.raises((AssertionError, TypeError)) as want:
        call(it.MultilinearRegular.new(*args))
    with pytest.raises(want.type) as got:
        call(tt.MultilinearRegular.new(*args))
    assert str(got.value) == str(want.value)


def test_unrepresentable_only_where_the_reference_raises():
    """eval_torch never raises on NaN or inf coordinates; a rectilinear
    class and the spline classes never raise it; the matching values are
    the JAX package's."""
    reg = ([5, 5], np.zeros(2), np.full(2, 0.25), np.arange(25.0))
    obs = [np.array([np.nan, 0.5, np.inf]), np.array([0.5, 0.5, 0.5])]
    tm = tt.MultilinearRegular.new(*reg)
    got = tm.eval_torch([torch.from_numpy(o) for o in obs]).numpy()
    np.testing.assert_array_equal(got, np.asarray(it.MultilinearRegular.new(*reg).eval_jax(obs)))
    for name, args, kw in (("MultilinearRectilinear", ([np.linspace(0, 1, 5)] * 2,
                                                       np.arange(25.0)), {}),
                           ("TensorSplineRegular", reg, {"method": "pchip"})):
        want = getattr(it, name).new(*args, **kw).eval(obs)
        np.testing.assert_array_equal(getattr(tt, name).new(*args, **kw).eval(obs), want)


def test_f32_model_takes_list_observations():
    m = tt.MultilinearRegular.new([5, 5], np.zeros(2, np.float32),
                                  np.full(2, 0.25, np.float32), np.arange(25.0, dtype=np.float32))
    for fn in (m.eval, m.eval_unchecked):
        out = fn([[0.5, 0.6], [0.5, 0.6]])
        assert out.dtype == np.float32 and out.shape == (2,) and np.isfinite(out).all()
    with pytest.raises(TypeError, match="expected a float32 array, got float64"):
        m.eval([np.full(2, 0.5), np.full(2, 0.5)])


def test_eval_writes_a_tensor_out():
    m = tt.MulticubicRectilinear.new([np.linspace(0, 1, 5)] * 2, np.arange(25.0))
    obs = [torch.linspace(0, 1, 7, dtype=torch.float64)] * 2
    out = torch.zeros(7, dtype=torch.float64)
    assert m.eval(obs, out) is out
    np.testing.assert_array_equal(out.numpy(), m.eval([o.numpy() for o in obs]))


def _construction_errors():
    z2 = np.zeros(2)
    g = [np.array([0.0, 2.0, 1.0, 3.0]), np.arange(4.0)]
    return [
        ("steps", lambda m: m.MultilinearRegular.new([4, 5], z2, np.array([0.0, 1.0]),
                                                     np.zeros(20))),
        ("vals-size", lambda m: m.MultilinearRegular.new([4, 5], z2, np.ones(2), np.zeros(7))),
        ("ndims", lambda m: m.NearestRegular.new([2] * 7, np.zeros(7), np.ones(7),
                                                 np.zeros(2**7))),
        ("monotonic", lambda m: m.TensorSplineRectilinear.new(g, np.zeros(16), method="pchip")),
        ("method", lambda m: m.TensorSplineRegular.new([4, 4], z2, np.ones(2), np.zeros(16),
                                                       method="nope")),
        ("dtypes", lambda m: m.MulticubicRegular(
            dims=[4], starts=m.models.ArrayF64(data=np.zeros(1)),
            steps=m.models.ArrayF32(data=np.ones(1)), vals=m.models.ArrayF64(data=np.zeros(4)),
            linearize_extrapolation=True)),
    ]


@pytest.mark.parametrize("call", [c for _, c in _construction_errors()],
                         ids=[i for i, _ in _construction_errors()])
def test_construction_errors_match_jax(call):
    with pytest.raises(Exception) as want:
        call(it)
    with pytest.raises(Exception) as got:
        call(tt)
    assert type(got.value).__name__ == type(want.value).__name__
    msg = re.compile(r"Assertion failed, (.*?) \[type=", re.DOTALL)
    assert msg.findall(str(got.value)) == msg.findall(str(want.value))


def test_numpy_eval_without_a_device_raises(monkeypatch):
    """No device asked for and no CUDA device: a numpy evaluation raises
    RuntimeError rather than carrying on on the CPU; CPU tensors still
    compute where they live."""
    m = tt.MultilinearRegular.new([5, 5], np.zeros(2), np.full(2, 0.25), np.arange(25.0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obs = [np.full(3, 0.5), np.full(3, 0.5)]
    with config.device(None):
        for call in (m.eval, m.eval_torch, m.gradient_torch, lambda o: m.check_bounds(o, 0.0)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call(obs)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.warmup(4)
        got = m.eval_torch([torch.from_numpy(o) for o in obs])
        assert got.device.type == "cpu"


def test_device_side_without_pydantic():
    """Where pydantic is missing, the package imports without the classes
    and `DeviceInterpolator` evaluates from plain numpy arrays, equal to the
    class here."""
    code = (
        "import importlib.util, sys\n"
        "real = importlib.util.find_spec\n"
        "importlib.util.find_spec = lambda n, *a: None if n.split('.')[0] == 'pydantic' "
        "else real(n, *a)\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'pydantic':\n"
        "            raise ImportError('no pydantic here')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "import interpn_tpu_torch as tt\n"
        "from interpn_tpu_torch.models._device import DeviceInterpolator\n"
        "assert tt.__all__ == ['__version__', 'raw', 'interpn', 'interpn_stack'], tt.__all__\n"
        "assert not hasattr(tt, 'MultilinearRegular')\n"
        "assert 'pydantic' not in sys.modules\n"
        "tt.config.set_device('cpu')\n"
        "d = DeviceInterpolator('pchip', np.arange(25.0), dims=(5, 5), starts=np.zeros(2),\n"
        "                       steps=np.full(2, 0.25), min_grid=4)\n"
        "print(repr(d.eval([np.array([0.3, 0.6]), np.array([0.1, 0.9])]).tolist()))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                         capture_output=True, text=True)
    m = tt.TensorSplineRegular.new([5, 5], np.zeros(2), np.full(2, 0.25), np.arange(25.0),
                                   method="pchip")
    want = m.eval([np.array([0.3, 0.6]), np.array([0.1, 0.9])])
    assert eval(res.stdout.strip()) == want.tolist()
    d = DeviceInterpolator("pchip", np.arange(25.0), dims=(5, 5), starts=np.zeros(2),
                           steps=np.full(2, 0.25), min_grid=4)
    np.testing.assert_array_equal(d.eval([np.array([0.3, 0.6]), np.array([0.1, 0.9])]), want)
