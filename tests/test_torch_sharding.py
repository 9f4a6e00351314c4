"""The port's obs-axis data parallelism (`interpn_tpu_torch.parallel`) on a
mesh of 8 CPU entries, against the JAX package's on its 8 virtual CPU
devices (`tests/conftest.py`).

A port of `tests/test_sharding.py`: every evaluator's shards, concatenated,
are bitwise the single-device op on the same inputs, and within the JAX
package's sharded result at that file's bars (nearest exact; f64 2e-15,
f32 2e-6 relative, 100 times that absolute; the extensions and stacks
1e-12), for each method and grid kind, the stacks and the extensions. The
HLO collective checks become: each shard on its mesh entry's device, the
grid and table one copy a distinct device, nothing copied for inputs
already in place. Also `pad_to_multiple` (numpy and tensors), a batch that
does not divide, the `dims=` and table-size errors, the forced f64 engines'
preparation hoisted to build time, and `make_mesh()` without CUDA.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import interpn_tpu
import jax
from interpn_tpu import parallel as jparallel

import interpn_tpu_torch as itt
from interpn_tpu_torch import config, ops, parallel
from interpn_tpu_torch.ops import df64, dispatch, i8
from interpn_tpu_torch.parallel.sharding import Shards, Sharding

CPU = torch.device("cpu")
MESH = parallel.make_mesh(["cpu"] * 8)


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest should configure 8 CPU devices"
    return jparallel.make_mesh()


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _grid3(n=8):
    x = np.linspace(0.0, 10.0, n)
    xg, yg, zg = np.meshgrid(x, x, x, indexing="ij")
    return x, (np.sin(xg) + yg * zg).ravel()


def _single(method, regular, garrs, vals, obs, dims=(8, 8, 8), lin=True):
    """The single-device op on the same inputs, as tensors of vals' dtype."""
    v = _t(vals)
    ob = tuple(_t(o, v.dtype) for o in obs)
    extra = (lin,) if method == "cubic" else ()
    if regular:
        return getattr(ops, f"{method}_regular")(dims, _t(garrs[0], v.dtype),
                                                 _t(garrs[1], v.dtype), v, ob, *extra)
    return getattr(ops, f"{method}_rectilinear")(tuple(_t(g, v.dtype) for g in garrs), v, ob,
                                                 *extra)


def _check_shards(out, n, lead=()):
    assert isinstance(out, Shards) and len(out) == len(MESH)
    for s, d in zip(out, MESH):
        assert s.device == d and tuple(s.shape) == (*lead, n // len(MESH))


def _bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
def test_sharded_matches_single_device(jmesh, method):
    x, vals = _grid3()
    rng = np.random.default_rng(99)
    n = 4096
    obs = tuple(rng.uniform(-2.0, 12.0, n) for _ in range(3))
    garrs = (np.zeros(3), np.full(3, x[1] - x[0]))
    f = parallel.sharded_evaluator(MESH, method=method, regular=True)
    out = f(garrs, vals, parallel.shard_obs(obs, MESH), dims=(8, 8, 8))
    _check_shards(out, n)
    got = out.concat(CPU)
    _bitwise(got, _single(method, True, garrs, vals, obs))
    jf = jparallel.sharded_evaluator(jmesh, method=method, regular=True)
    want = np.asarray(jf(garrs, vals, jparallel.shard_obs(obs, jmesh), dims=(8, 8, 8)))
    if method == "nearest":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-15, atol=2e-13)


def test_output_shards_and_no_copies():
    """Each shard computes on its mesh entry's device; replicating to a
    mesh whose entries share one device makes one copy, and none of a
    tensor already there; a chunk of a tensor already on its device is a
    view of it."""
    x, vals = _grid3()
    rng = np.random.default_rng(7)
    obs = tuple(torch.from_numpy(rng.uniform(0, 10, 4096)) for _ in range(3))
    shards = parallel.shard_obs(obs, MESH)
    assert all(s.data_ptr() == obs[0][512 * i:].data_ptr() for i, s in enumerate(shards[0]))
    v = torch.from_numpy(vals)
    rep = parallel.replicated(MESH).place(v)
    assert len(rep) == 8 and all(r is rep[0] for r in rep) and rep[0].data_ptr() == v.data_ptr()
    assert parallel.obs_sharding(MESH) == Sharding(MESH, True)
    assert parallel.replicated(MESH) == Sharding(MESH, False)
    f = parallel.sharded_evaluator(MESH, method="cubic", regular=True)
    out = f((np.zeros(3), np.full(3, x[1] - x[0])), v, shards, dims=(8, 8, 8))
    _check_shards(out, 4096)


def test_rectilinear_sharded(jmesh):
    g = np.array([0.0, 0.5, 2.0, 3.5, 4.0, 7.0, 10.0])
    gg = np.meshgrid(g, g, indexing="ij")
    vals = (gg[0] * 2 - gg[1]).ravel()
    rng = np.random.default_rng(3)
    obs = tuple(rng.uniform(-1, 11, 1024) for _ in range(2))
    f = parallel.sharded_evaluator(MESH, method="linear", regular=False)
    out = f((g, g), vals, parallel.shard_obs(obs, MESH)).concat(CPU)
    np.testing.assert_allclose(out.numpy(), obs[0] * 2 - obs[1], atol=1e-12)
    _bitwise(out, _single("linear", False, (g, g), vals, obs))


def test_pad_to_multiple():
    x = np.arange(10.0)
    padded, n = parallel.pad_to_multiple(x, 8)
    assert padded.shape[0] == 16 and n == 10
    assert np.all(padded[10:] == x[-1])
    same, n2 = parallel.pad_to_multiple(np.arange(16.0), 8)
    assert same.shape[0] == 16 and n2 == 16
    t = torch.arange(10.0)
    padded_t, n3 = parallel.pad_to_multiple(t, 8)
    assert n3 == 10
    np.testing.assert_array_equal(padded_t.numpy(), padded)
    whole = torch.arange(16.0)
    assert parallel.pad_to_multiple(whole, 8)[0] is whole


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
@pytest.mark.parametrize("regular", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_all_families_sharded_match_unsharded(jmesh, method, regular, dtype):
    x, vals = _grid3()
    rng = np.random.default_rng(17)
    n = 2048
    obs = tuple(rng.uniform(-2.0, 12.0, n).astype(dtype) for _ in range(3))
    vals = vals.astype(dtype)
    garrs = ((np.zeros(3, dtype), np.full(3, x[1] - x[0], dtype)) if regular
             else tuple(x.astype(dtype) for _ in range(3)))
    f = parallel.sharded_evaluator(MESH, method=method, regular=regular)
    out = f(garrs, vals, parallel.shard_obs(obs, MESH), dims=(8, 8, 8))
    _check_shards(out, n)
    got = out.concat(CPU)
    _bitwise(got, _single(method, regular, garrs, vals, obs))
    jf = jparallel.sharded_evaluator(jmesh, method=method, regular=regular)
    want = np.asarray(jf(garrs, vals, jparallel.shard_obs(obs, jmesh), dims=(8, 8, 8)))
    if method == "nearest":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        rtol = 2e-15 if dtype == np.float64 else 2e-6
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * 100)


def test_nondivisible_batch_through_pad_to_multiple():
    x, vals = _grid3()
    rng = np.random.default_rng(23)
    n = 8 * 300 + 3
    obs = tuple(rng.uniform(0.0, 10.0, n) for _ in range(3))
    garrs = (np.zeros(3), np.full(3, x[1] - x[0]))
    f = parallel.sharded_evaluator(MESH, method="cubic", regular=True)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        f(garrs, vals, obs, dims=(8, 8, 8))
    padded = [parallel.pad_to_multiple(o, 8) for o in obs]
    assert padded[0][0].shape[0] % 8 == 0 and padded[0][1] == n
    out = f(garrs, vals, parallel.shard_obs(tuple(p for p, _ in padded), MESH),
            dims=(8, 8, 8)).concat(CPU)[:n]
    _bitwise(out, _single("cubic", True, garrs, vals, obs))


def test_sharded_regular_requires_dims():
    x, vals = _grid3()
    f = parallel.sharded_evaluator(MESH, method="linear")
    with pytest.raises(TypeError, match="requires dims="):
        f((np.zeros(3), np.ones(3)), vals, (np.zeros(8),) * 3)


def test_obs_shard_count_must_match_the_mesh():
    x, vals = _grid3()
    f = parallel.sharded_evaluator(MESH, method="linear")
    obs = parallel.shard_obs((np.zeros(16),) * 3, MESH[:4])
    with pytest.raises(ValueError, match="4 shards for a mesh of 8"):
        f((np.zeros(3), np.ones(3)), vals, obs, dims=(8, 8, 8))


def test_make_mesh():
    """CUDA devices unless others are asked for; none at all raises."""
    assert MESH == (CPU,) * 8
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in parallel.make_mesh())
    else:
        with pytest.raises(RuntimeError, match=r"make_mesh\(\['cpu'\] \* 8\)"):
            parallel.make_mesh()
    with pytest.raises(ValueError, match="at least one device"):
        parallel.make_mesh([])


def test_all_matches_the_jax_package():
    assert sorted(parallel.__all__) == sorted(jparallel.__all__)
    assert parallel.OBS_AXIS == jparallel.OBS_AXIS


class TestPreparedEvaluator:
    """prepared_evaluator: the replicas made once at build; under a forced
    f64 engine its table preparation too (the port's counterpart of the
    JAX package's hoisted i8 decomposition)."""

    @staticmethod
    def _case(n=8192, seed=7, lo=0.0, hi=9.5):
        x = np.linspace(0.0, 10.0, 20)
        xg, yg, zg = np.meshgrid(x, x, x, indexing="ij")
        vals = np.sin(xg) + yg * zg
        rng = np.random.default_rng(seed)
        obs = tuple(rng.uniform(lo, hi, n) for _ in range(3))
        return x, vals.ravel(), np.zeros(3), np.full(3, x[1] - x[0]), obs

    @pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
    @pytest.mark.parametrize("regular", [True, False])
    def test_matches_single_device_and_jax(self, jmesh, method, regular):
        x, vals, starts, steps, obs = self._case(n=2048)
        garrs = (starts, steps) if regular else (x, x, x)
        dims = (20, 20, 20) if regular else None
        f = parallel.prepared_evaluator(MESH, garrs, vals, dims=dims, method=method,
                                        regular=regular)
        got = f(parallel.shard_obs(obs, MESH))
        _check_shards(got, 2048)
        got = got.concat(CPU)
        _bitwise(got, _single(method, regular, garrs, vals, obs, dims=(20, 20, 20)))
        jf = jparallel.prepared_evaluator(jmesh, garrs, vals, dims=dims, method=method,
                                          regular=regular)
        want = np.asarray(jf(jparallel.shard_obs(obs, jmesh)))
        if method == "nearest":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-15, atol=2e-13)

    @staticmethod
    def _spy(monkeypatch):
        """CPU tensors taken for CUDA ones; every build of a per-table
        cache entry and every K8 / K9 contraction recorded."""
        events = []
        monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
        for name, cache in (("split", df64._SPLITS), ("taps", df64._TAPS),
                            ("i8", i8._PREPS)):
            monkeypatch.setattr(cache, "entries", {})

            def get(vals, extra, build, _name=name, _get=cache.get):
                return _get(vals, extra, lambda: events.append(_name) or build())

            monkeypatch.setattr(cache, "get", get)
        for name, module in (("K8", df64), ("K9", i8)):
            contract = module.contract
            monkeypatch.setattr(module, "contract", lambda *a, _n=name, _c=contract:
                                events.append(_n) or _c(*a))
        return events

    @pytest.mark.parametrize("engine,built,kernel", [("i8", ["i8"], "K9"),
                                                     ("df64", ["split", "taps"], "K8")])
    def test_forced_engine_preparation_hoisted(self, monkeypatch, engine, built, kernel):
        events = self._spy(monkeypatch)
        monkeypatch.setenv(dispatch.F64_ENV, engine)
        x, vals, starts, steps, obs = self._case(n=1024)
        f = parallel.prepared_evaluator(MESH, (starts, steps), vals, dims=(20, 20, 20),
                                        method="cubic")
        assert events == built  # one replica: every mesh entry is the CPU
        events.clear()
        got = f(parallel.shard_obs(obs, MESH)).concat(CPU)
        assert events == [kernel] * 8  # one launch a shard, nothing built
        events.clear()
        want = _single("cubic", True, (starts, steps), vals, obs, dims=(20, 20, 20))
        _bitwise(got, want)

    def test_unforced_hoists_nothing(self, monkeypatch):
        events = self._spy(monkeypatch)
        monkeypatch.delenv(dispatch.F64_ENV, raising=False)
        x, vals, starts, steps, obs = self._case(n=1024)
        f = parallel.prepared_evaluator(MESH, (starts, steps), vals, dims=(20, 20, 20),
                                        method="cubic")
        f(parallel.shard_obs(obs, MESH))
        assert events == []
        monkeypatch.setenv(dispatch.F64_ENV, "i8")
        f = parallel.prepared_evaluator(MESH, (starts.astype(np.float32),
                                               steps.astype(np.float32)),
                                        vals.astype(np.float32), dims=(20, 20, 20),
                                        method="cubic")
        f(tuple(o.astype(np.float32) for o in obs))
        assert events == []  # f32 is no target of the engines

    def test_regular_requires_dims(self):
        x, vals, starts, steps, obs = self._case()
        with pytest.raises(TypeError, match="requires dims="):
            parallel.prepared_evaluator(MESH, (starts, steps), vals, method="cubic")


class TestPreparedExtensions:
    @staticmethod
    def _case(n=8192, seed=11):
        x = np.linspace(0.0, 10.0, 12)
        xg, yg = np.meshgrid(x, x, indexing="ij")
        vals = np.sin(xg) + 0.3 * yg**2
        rng = np.random.default_rng(seed)
        obs = tuple(rng.uniform(0.0, 10.0, n) for _ in range(2))
        return x, vals.ravel(), obs

    @pytest.mark.parametrize("method", ["pchip", "cubic_spline", "quintic"])
    @pytest.mark.parametrize("regular", [True, False])
    def test_matches_single_chip(self, jmesh, method, regular):
        x, vals, obs = self._case(n=2048)
        if regular:
            x = np.arange(12.0)  # integer spacing: exactly regular
            obs = tuple(o * 1.1 for o in obs)
        garrs = (np.zeros(2), np.ones(2)) if regular else (x, x)
        dims = (12, 12) if regular else None
        f = parallel.prepared_evaluator(MESH, garrs, vals, dims=dims, method=method,
                                        regular=regular)
        out = f(parallel.shard_obs(obs, MESH))
        _check_shards(out, 2048)
        got = out.concat(CPU)
        ob = tuple(_t(o) for o in obs)
        if method == "pchip":
            single = (ops.pchip_regular((12, 12), _t(garrs[0]), _t(garrs[1]), _t(vals), ob)
                      if regular else ops.pchip_rectilinear((_t(x), _t(x)), _t(vals), ob))
        else:
            k = 3 if method == "cubic_spline" else 5
            knots, coeffs = ops.prep_bspline([x, x], vals, k)
            single = ops.bspline_eval(tuple(_t(t) for t in knots), _t(coeffs), ob, k)
        _bitwise(got, single)
        ref = interpn_tpu.interpn([np.asarray(o) for o in obs], [x, x], vals, method=method)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
        jf = jparallel.prepared_evaluator(jmesh, garrs, vals, dims=dims, method=method,
                                          regular=regular)
        want = np.asarray(jf(jparallel.shard_obs(obs, jmesh)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)

    def test_grid_floor(self):
        x = np.linspace(0.0, 1.0, 5)
        with pytest.raises(AssertionError, match="at least 6 entries"):
            parallel.prepared_evaluator(MESH, (x, x), np.zeros(25), method="quintic",
                                        regular=False)

    @pytest.mark.parametrize("method", ["pchip", "cubic_spline"])
    def test_table_size_mismatch(self, method):
        x, vals, obs = self._case()
        with pytest.raises(AssertionError, match="Dimension mismatch"):
            parallel.prepared_evaluator(MESH, (x, x), vals[:-1], method=method, regular=False)

    def test_regular_requires_dims(self):
        x, vals, obs = self._case()
        with pytest.raises(TypeError, match="requires dims="):
            parallel.prepared_evaluator(MESH, (np.zeros(2), np.ones(2)), vals,
                                        method="cubic_spline")


class TestPreparedStackEvaluator:
    @staticmethod
    def _case(nch=3, n=8192, seed=13):
        x = np.arange(12.0)  # exactly regular
        xg, yg = np.meshgrid(x, x, indexing="ij")
        rng = np.random.default_rng(seed)
        vals = np.stack([np.sin(xg + c) + 0.3 * yg**2 for c in range(nch)]).reshape(nch, -1)
        obs = tuple(rng.uniform(0.0, 11.0, n) for _ in range(2))
        return x, vals, obs

    @staticmethod
    def _single_stack(method, regular, x, vals, obs):
        ob = tuple(_t(o) for o in obs)
        st, sp, g = _t(np.zeros(2)), _t(np.ones(2)), (_t(x), _t(x))
        if method == "pchip":
            return torch.stack([ops.pchip_regular((12, 12), st, sp, _t(v), ob) if regular
                                else ops.pchip_rectilinear(g, _t(v), ob) for v in vals])
        if method in ("cubic_spline", "quintic"):
            k = 3 if method == "cubic_spline" else 5
            knots, coeffs = ops.prep_bspline([x, x], np.ascontiguousarray(vals.T), k)
            return ops.bspline_eval_stack(tuple(_t(t) for t in knots),
                                          _t(np.ascontiguousarray(coeffs.T)), ob, k)
        if regular:
            return getattr(ops, f"{method}_regular_stack")((12, 12), st, sp, _t(vals), ob)
        return getattr(ops, f"{method}_rectilinear_stack")(g, _t(vals), ob)

    @pytest.mark.parametrize(
        "method", ["linear", "cubic", "nearest", "pchip", "cubic_spline", "quintic"])
    @pytest.mark.parametrize("regular", [True, False])
    def test_matches_interpn_stack(self, jmesh, method, regular):
        x, vals, obs = self._case(n=2048)
        garrs = (np.zeros(2), np.ones(2)) if regular else (x, x)
        f = parallel.prepared_stack_evaluator(MESH, garrs, vals,
                                              dims=(12, 12) if regular else None,
                                              method=method, regular=regular)
        out = f(parallel.shard_obs(obs, MESH))
        _check_shards(out, 2048, lead=(3,))
        got = out.concat(CPU)
        assert got.shape == (3, 2048)
        _bitwise(got, self._single_stack(method, regular, x, vals, obs))
        ref = interpn_tpu.interpn_stack([np.asarray(o) for o in obs], [x, x], vals,
                                        method=method)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
        ours = itt.interpn_stack([np.asarray(o) for o in obs], [x, x], vals, method=method)
        np.testing.assert_allclose(got.numpy(), ours, rtol=1e-12, atol=1e-12)

    def test_errors(self):
        x, vals, obs = self._case()
        with pytest.raises(TypeError, match="requires dims="):
            parallel.prepared_stack_evaluator(MESH, (np.zeros(2), np.ones(2)), vals,
                                              method="linear")
        with pytest.raises(AssertionError, match="Dimension mismatch"):
            parallel.prepared_stack_evaluator(MESH, (x, x), vals.ravel(), regular=False)
        with pytest.raises(AssertionError, match="at least 6 entries"):
            parallel.prepared_stack_evaluator(MESH, (x[:5], x[:5]), vals[:, :25],
                                              method="quintic", regular=False)


def test_sharded_evaluator_pchip_generic(jmesh):
    x = np.arange(10.0)
    xg, yg = np.meshgrid(x, x, indexing="ij")
    vals = (np.sin(xg) + 0.2 * yg**2).ravel()
    rng = np.random.default_rng(31)
    obs = tuple(rng.uniform(0.0, 9.0, 2048) for _ in range(2))
    garrs = (np.zeros(2), np.ones(2))
    f = parallel.sharded_evaluator(MESH, method="pchip", regular=True)
    out = f(garrs, vals, parallel.shard_obs(obs, MESH), dims=(10, 10))
    _check_shards(out, 2048)
    got = out.concat(CPU)
    ob = tuple(_t(o) for o in obs)
    _bitwise(got, ops.pchip_regular((10, 10), _t(garrs[0]), _t(garrs[1]), _t(vals), ob))
    jf = jparallel.sharded_evaluator(jmesh, method="pchip", regular=True)
    want = np.asarray(jf(garrs, vals, jparallel.shard_obs(obs, jmesh), dims=(10, 10)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)
    g = parallel.sharded_evaluator(MESH, method="pchip", regular=False)
    out_r = g((x, x), vals, parallel.shard_obs(obs, MESH)).concat(CPU)
    _bitwise(out_r, ops.pchip_rectilinear((_t(x), _t(x)), _t(vals), ob))
    np.testing.assert_allclose(out_r.numpy(), want, rtol=1e-12, atol=1e-12)
