"""Serving artifacts of the port (`interpn_tpu_torch.aot`) on the CPU.

A port of `tests/test_aot.py`, one test for each of its tests: the served
result is bitwise equal to the model's own `eval_torch` (every family, f32
and f64, the spline models), and held against the JAX package's served
artifact on the same seeded numpy inputs at that file's tolerances (exact
for nearest, 2e-15 for f64, 2e-6 for f32, relative and absolute); bucket
padding and selection, the error messages, a fresh process that imports
only `interpn_tpu_torch.aot`. Beyond it: each kernel-backed class exported
on its kernel route (CPU tensors taken for CUDA ones) holds its op as one
node and serves through it bitwise; the engine of a forced INTERPN_TPU_F64
stays pinned to the export; a JAX artifact, a truncated one and a CUDA
artifact without a CUDA device are refused.
"""

from __future__ import annotations

import io
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import interpn_tpu as it
from interpn_tpu import aot as jaot

import interpn_tpu_torch as itt
from interpn_tpu_torch import aot, config
from interpn_tpu_torch.ops import df64, dispatch, library

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(42)
KERNEL_OPS = {library.overload(n) for n in library.NAMES}


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


def _grid(ndims, n=6):
    x = np.linspace(0.0, 2.0, n)
    mesh = np.meshgrid(*([x] * ndims), indexing="ij")
    vals = np.cos(mesh[0])
    for m in mesh[1:]:
        vals = vals + 0.3 * m * m
    return x, vals


def _models(pkg, dtype):
    x, vals = _grid(3)
    dims = [len(x)] * 3
    starts = np.full(3, x[0], dtype)
    steps = np.full(3, x[1] - x[0], dtype)
    v = vals.ravel().astype(dtype)
    grids = [x.astype(dtype)] * 3
    return [
        pkg.MultilinearRegular.new(dims, starts, steps, v),
        pkg.MulticubicRegular.new(dims, starts, steps, v),
        pkg.NearestRegular.new(dims, starts, steps, v),
        pkg.MultilinearRectilinear.new(grids, v),
        pkg.MulticubicRectilinear.new(grids, v),
        pkg.NearestRectilinear.new(grids, v),
    ]


def _spline_models(pkg, method):
    x, vals = _grid(2, n=7)
    dims = [len(x)] * 2
    return (pkg.TensorSplineRegular.new(dims, np.full(2, x[0]), np.full(2, x[1] - x[0]),
                                        vals.ravel(), method=method),
            pkg.TensorSplineRectilinear.new([x] * 2, vals.ravel(), method=method))


def _obs(n, dtype, ndims=3):
    return tuple(RNG.uniform(-0.3, 2.3, n).astype(dtype) for _ in range(ndims))


def _against_jax(got, jmodel, obs, bucket, nearest, dtype):
    """The port's served result against the JAX package's served artifact
    of the same model on the same inputs, at tests/test_aot.py's bars."""
    want = np.asarray(jaot.load(jaot.export_eval(jmodel, bucket)).eval_jax(obs))
    got = got.numpy()
    if nearest:
        np.testing.assert_array_equal(got, want)
    else:
        tol = 2e-15 if dtype == np.float64 else 2e-6
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_round_trip_parity_all_families(dtype):
    for model, jmodel in zip(_models(itt, dtype), _models(it, dtype)):
        served = aot.load(aot.export_eval(model, 64))
        obs = _obs(64, dtype)
        got = served.eval_torch(obs)
        _bitwise(got, model.eval_torch(obs))
        _against_jax(got, jmodel, obs, 64, "Nearest" in type(model).__name__, dtype)


@pytest.mark.parametrize("method", ["pchip", "cubic_spline", "quintic"])
def test_round_trip_parity_spline_models(method):
    for model, jmodel in zip(_spline_models(itt, method), _spline_models(it, method)):
        served = aot.load(aot.export_eval(model, 48))
        obs = _obs(48, np.float64, ndims=2)
        got = served.eval_torch(obs)
        _bitwise(got, model.eval_torch(obs))
        _against_jax(got, jmodel, obs, 48, False, np.float64)


def test_padding_to_bucket_matches_exact_batch():
    model = _models(itt, np.float64)[1]  # cubic regular
    served = aot.load(aot.export_eval(model, 64))
    obs = _obs(13, np.float64)
    got = served.eval_torch(obs)
    assert got.shape == (13,)
    _bitwise(got, model.eval_torch(obs))
    jmodel = _models(it, np.float64)[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.eval_jax(obs)), rtol=1e-13)


def test_bucket_selection_and_overflow():
    model = _models(itt, np.float64)[0]
    served = aot.load(aot.export_eval(model, [128, 32, 32]))
    assert served.batch_sizes == [32, 128]
    obs = _obs(100, np.float64)
    out = served.eval_torch(obs)  # -> 128 bucket
    assert out.shape == (100,)
    _bitwise(out, model.eval_torch(obs))
    with pytest.raises(ValueError, match="largest compiled bucket"):
        served.eval_torch(_obs(200, np.float64))
    with pytest.raises(ValueError, match="positive"):
        aot.export_eval(model, [])
    with pytest.raises(ValueError, match="positive"):
        aot.export_eval(model, [8, 0])


def test_empty_batch_and_dimension_mismatch():
    model = _models(itt, np.float64)[0]
    served = aot.load(aot.export_eval(model, 8))
    assert served.eval_torch(_obs(0, np.float64)).shape == (0,)
    with pytest.raises(AssertionError, match="Dimension mismatch"):
        served.eval_torch(_obs(8, np.float64)[:2])
    with pytest.raises(AssertionError, match="Dimension mismatch"):
        served.eval_torch((*_obs(8, np.float64)[:2], np.zeros(5)))


def test_rejects_garbage_bytes():
    with pytest.raises(ValueError, match="artifact"):
        aot.load(b"definitely not an artifact")
    blob = aot.export_eval(_models(itt, np.float64)[0], 8)
    with pytest.raises(ValueError, match="truncated"):
        aot.load(blob[:-10])


def test_rejects_a_jax_artifact():
    jblob = jaot.export_eval(_models(it, np.float64)[0], 8)
    with pytest.raises(ValueError, match="JAX.*artifact"):
        aot.load(jblob)


def test_callable_alias_and_repr():
    model = _models(itt, np.float32)[0]
    served = aot.load(aot.export_eval(model, 16))
    obs = _obs(16, np.float32)
    _bitwise(served(obs), served.eval_torch(obs))
    assert "MultilinearRegular" in repr(served) and "cpu" in repr(served)


def test_takes_tensors_and_casts_to_the_artifact_dtype():
    model = _models(itt, np.float32)[4]  # cubic rectilinear
    served = aot.load(aot.export_eval(model, 32))
    obs = _obs(20, np.float64)
    got = served.eval_torch([torch.from_numpy(o) for o in obs])
    assert got.dtype == torch.float32
    _bitwise(got, model.eval_torch([o.astype(np.float32) for o in obs]))


def _header(blob):
    return json.loads(aot._read(blob, len(b"ITTAOT1\n"))[0])


def test_header():
    model = _models(itt, np.float32)[3]
    blob = aot.export_eval(model, [16, 4])
    meta = _header(blob)
    assert blob.startswith(b"ITTAOT1\n")
    assert meta == {"class": "MultilinearRectilinear", "ndims": 3, "dtype": "float32",
                    "batch_sizes": [4, 16], "device": "cpu", "engine": None,
                    "torch": torch.__version__}


def test_default_device_needs_cuda_or_a_request():
    """Without a request the artifact is for the CUDA device, which this
    process may not have: then export raises, as numpy inputs do."""
    model = _models(itt, np.float64)[0]
    with config.device(None):
        if torch.cuda.is_available():
            assert _header(aot.export_eval(model, 4))["device"].startswith("cuda")
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                aot.export_eval(model, 4)


def test_cuda_artifact_without_cuda_raises(monkeypatch):
    """A CUDA artifact is served on CUDA or not at all: never moved."""
    blob = aot.export_eval(_models(itt, np.float64)[0], 8)
    meta = _header(blob)
    meta["device"] = "cuda:0"
    head = json.dumps(meta).encode()
    (size,) = struct.unpack(">Q", blob[8:16])
    forged = blob[:8] + struct.pack(">Q", len(head)) + head + blob[16 + size:]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no such CUDA device"):
        aot.load(forged)


def _program(blob):
    """The first bucket's program."""
    _, off = aot._read(blob, len(b"ITTAOT1\n"))
    return torch.export.load(io.BytesIO(aot._read(blob, off)[0]))


@pytest.fixture
def kernel_route(monkeypatch):
    """The ops take their kernel route (the custom ops) on CPU tensors."""
    monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    monkeypatch.delenv(dispatch.F64_ENV, raising=False)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_classes_export_their_op(kernel_route, dtype):
    """On its kernel route each kernel-backed class's program is its op's
    node and a reshape, and serves bitwise its eval_torch; pchip's is its
    gather tree, with no op."""
    models = [*_models(itt, dtype),
              *(m for method in ("cubic_spline", "quintic", "pchip")
                for m in _spline_models(itt, method)[:1])]
    for model in models:
        blob = aot.export_eval(model, 16)
        targets = [n.target for n in _program(blob).graph.nodes if n.op == "call_function"]
        kernels = [t for t in targets if t in KERNEL_OPS]
        if getattr(model, "method", None) == "pchip":
            assert not kernels and _header(blob)["engine"] is None
        else:
            assert len(kernels) == 1, (type(model).__name__, targets)
            assert set(targets) <= KERNEL_OPS | {torch.ops.aten.reshape.default}, targets
            assert _header(blob)["engine"] == "native"
        obs = _obs(11, dtype, model.ndims())
        _bitwise(aot.load(blob).eval_torch(obs), model.eval_torch(obs))


def test_engine_stays_pinned_to_the_export(kernel_route, monkeypatch):
    """Exported under INTERPN_TPU_F64=df64 the program runs K8 whatever the
    variable says at serve time; exported without it, the native kernel."""
    calls = []
    contract = df64.contract
    monkeypatch.setattr(df64, "contract", lambda *a: calls.append(1) or contract(*a))
    model = _models(itt, np.float64)[1]
    obs = _obs(20, np.float64)
    monkeypatch.setenv(dispatch.F64_ENV, "df64")
    want = model.eval_torch(obs)
    pinned = aot.export_eval(model, 32)
    monkeypatch.delenv(dispatch.F64_ENV)
    native = aot.export_eval(model, 32)
    assert (_header(pinned)["engine"], _header(native)["engine"]) == ("df64", "native")
    calls.clear()
    _bitwise(aot.load(pinned).eval_torch(obs), want)
    assert calls == [1]
    monkeypatch.setenv(dispatch.F64_ENV, "df64")
    calls.clear()
    got = aot.load(native).eval_torch(obs)
    assert calls == []
    monkeypatch.delenv(dispatch.F64_ENV)
    _bitwise(got, model.eval_torch(obs))


def test_i8_engine_stays_pinned_to_the_export(kernel_route, monkeypatch):
    """Exported under INTERPN_TPU_F64=i8 the program runs K9 (its plain
    chain here, `i8.contract`) whatever the variable says at serve time,
    bitwise eval_torch under i8; exported without it, the native kernel
    even with i8 set at serve time."""
    from interpn_tpu_torch.ops import i8

    calls = []
    contract = i8.contract
    monkeypatch.setattr(i8, "contract", lambda *a: calls.append(1) or contract(*a))
    model = _models(itt, np.float64)[1]
    obs = _obs(20, np.float64)
    monkeypatch.setenv(dispatch.F64_ENV, "i8")
    want = model.eval_torch(obs)
    assert calls == [1]
    pinned = aot.export_eval(model, 32)
    monkeypatch.delenv(dispatch.F64_ENV)
    native = aot.export_eval(model, 32)
    assert (_header(pinned)["engine"], _header(native)["engine"]) == ("i8", "native")
    calls.clear()
    _bitwise(aot.load(pinned).eval_torch(obs), want)
    assert calls == [1]
    monkeypatch.setenv(dispatch.F64_ENV, "i8")
    calls.clear()
    got = aot.load(native).eval_torch(obs)
    assert calls == []
    monkeypatch.delenv(dispatch.F64_ENV)
    _bitwise(got, model.eval_torch(obs))


@pytest.mark.parametrize("route", ["gather", "kernel"])
def test_serves_without_model_in_fresh_process(tmp_path: Path, monkeypatch, route):
    """The deployment contract: a process that imports only
    `interpn_tpu_torch.aot` (no model built, no dispatch) loads the
    artifact and reproduces this process's eval_torch bit for bit; on the
    kernel route it serves through the custom op."""
    if route == "kernel":
        monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    model = _models(itt, np.float64)[4]  # cubic rectilinear: its plain version is not its gather tree
    obs = _obs(32, np.float64)
    want = model.eval_torch(obs).numpy()
    art = tmp_path / "m.ittaot"
    art.write_bytes(aot.export_eval(model, 32))
    np.save(tmp_path / "obs.npy", np.stack(obs))
    script = (
        "import sys\n"
        "import numpy as np\n"
        "from interpn_tpu_torch import aot\n"
        f"sm = aot.load(open(r'{art}','rb').read())\n"
        f"obs = np.load(r'{tmp_path / 'obs.npy'}')\n"
        f"np.save(r'{tmp_path / 'out.npy'}', sm.eval_torch(tuple(obs)).numpy())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'interpn_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", script], check=True, timeout=300, cwd=ROOT)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)
