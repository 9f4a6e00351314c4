"""The port's spans (`interpn_tpu_torch/utils/tracing.py`) and the
benchmark's readers of them (`portbench/spans.py`, `portbench/metrics/`).

On the CPU: nothing records and no span opens without a profiler; under
one, each entry records its spans in order, a class call one `entry`, a
call into a tensor `out` its flag, one `sync` and `finish`, each span a
profiler range `interpn.<span>`; results are those of an untraced call; the
rectilinear classes, as the benchmark's `rect4d20_f64_cubic.bulk` cell
drives them, record their spans as the regular ones, and that cell's 20^4
float64 cubic table takes the `taps` route; an exported program is the same
with a profiler open; the ring refuses a window it has overwritten; each
reader gives the value computed by hand on a hand-built ring, and nothing
without the tracing module. The tests marked `gpu` hold the wrapper's
`route` and `launch` spans, the launch counts and routes (one
`rectilinear_cubic` and one `rectilinear_cubic_pack` launch a call on the
rectilinear cell's path), and the flag's CUDA events on the card, and that
no range lands on the device's timeline. The file imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""

from __future__ import annotations

import importlib
import inspect
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from interpn_tpu_torch import aot, config, ops, raw
from interpn_tpu_torch.models import (MulticubicRectilinear, MulticubicRegular,
                                      MultilinearRectilinear, MultilinearRegular)
from interpn_tpu_torch.ops import dispatch, fused
from interpn_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import spans  # noqa: E402
from portbench.harness import load_module  # noqa: E402

DIMS = (5, 6, 7)
N = 300
CELL_DIMS = (20, 20, 20, 20)  # the rectilinear cell's table
READERS = ("entry.predispatch_ms", "dispatch.host_ms", "wrappers.route_ms",
           "entry.syncs_per_step", "entry.flag_device_ms")


@pytest.fixture(autouse=True)
def _on_cpu():
    with config.device("cpu"):
        yield


def _model(cls=MultilinearRegular, dtype=np.float32):
    rng = np.random.default_rng(7)
    starts = np.array([0.0, -1.0, 2.0], dtype)
    steps = np.array([0.5, 0.25, 1.0], dtype)
    vals = rng.standard_normal(int(np.prod(DIMS))).astype(dtype)
    return cls.new(list(DIMS), starts, steps, vals)


def _obs(device="cpu", dtype=torch.float32, n=N):
    gen = torch.Generator().manual_seed(3)
    his = (2.0, 0.25, 8.0)
    return tuple((torch.rand(n, generator=gen, dtype=torch.float64) * (hi + 2) - 1)
                 .to(dtype).to(device) for hi in his)


def _rect_model(cls, dims, linearize=None):
    """A rectilinear class over jittered axes on [0, 10] (each inner node
    moved by up to a fifth of the even spacing) and a table uniform in [0, 1)."""
    rng = np.random.default_rng(5)
    coords = []
    for dim in dims:
        u = np.zeros(dim)
        u[1:-1] = rng.uniform(-0.2, 0.2, dim - 2)
        coords.append((np.arange(dim) + u) * 10.0 / (dim - 1))
    vals = rng.uniform(0, 1, math.prod(dims))
    kw = {} if linearize is None else {"linearize_extrapolation": linearize}
    return cls.new(coords, vals, **kw)


def _rect_obs(ndims, device="cpu", n=N):
    """Float64 queries uniform over [-0.5, 10.5] on each axis, the
    rectilinear cell's box."""
    gen = torch.Generator().manual_seed(11)
    return tuple((torch.rand(n, generator=gen, dtype=torch.float64) * 11 - 0.5).to(device)
                 for _ in range(ndims))


# the classes whose `eval_torch` spans are held: the regular model of
# `_model`, and the rectilinear classes at 3 and 4 axes, the cubic one with
# and without linearised extrapolation
CLASS_CASES = [(MultilinearRegular, DIMS, None),
               (MulticubicRectilinear, (5, 6, 4), True),
               (MulticubicRectilinear, (5, 6, 4), False),
               (MulticubicRectilinear, (4, 5, 4, 6), True),
               (MulticubicRectilinear, (4, 5, 4, 6), False),
               (MultilinearRectilinear, (5, 6, 4), None),
               (MultilinearRectilinear, (4, 5, 4, 6), None)]
CLASS_IDS = [f"{cls.__name__}-{len(dims)}d" + ("" if lin is None else f"-{lin}")
             for cls, dims, lin in CLASS_CASES]


def _case(cls, dims, linearize, device="cpu", n=N):
    """(model, queries) of a case of CLASS_CASES."""
    if cls is MultilinearRegular:
        return _model(), _obs(device, n=n)
    return _rect_model(cls, dims, linearize), _rect_obs(len(dims), device, n)


def _calls(model, obs, out):
    """Each entry the benchmark drives, by name."""
    t = model._device().tensors(obs[0].device)
    stack = torch.stack([t[2], t[2] * 2])
    return {
        "eval_torch": lambda: model.eval_torch(obs),
        "eval_out": lambda: model.eval(obs, out=out),
        "gradient_torch": lambda: model.gradient_torch(obs)[0],
        "ops": lambda: ops.linear_regular(DIMS, t[0], t[1], t[2], obs),
        "stack": lambda: ops.cubic_regular_stack(DIMS, t[0], t[1], stack, obs, True),
        "raw": lambda: raw.interpn_linear_regular_f32(list(DIMS), t[0], t[1], t[2], obs,
                                                     torch.empty_like(obs[0])),
    }


def _recorded(fn):
    """(fn's result, the ring's records it wrote, the profiler's events)
    under a CPU profiler."""
    before = tracing.RING.written
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn()
    return got, _since(before), prof.events()


def _since(before):
    """The records the ring took since it had written `before`."""
    kept = tracing.RING.kept()
    return kept[len(kept) - (tracing.RING.written - before):]


def _names(rows):
    return [tracing.SPANS[int(r[0])] for r in rows]


def _one(rows, name):
    got = rows[rows[:, 0] == tracing.SPANS.index(name)]
    assert len(got) == 1, (name, _names(rows))
    return got[0]


# --- off ---------------------------------------------------------------------------


def test_nothing_records_without_a_profiler(monkeypatch):
    """No span opens, no range opens and no record is written with no
    profiler; with one, the same patches see the spans open."""
    model = _model()
    obs = _obs()
    calls = _calls(model, obs, torch.empty(N))
    opened = []
    monkeypatch.setattr(tracing, "_enter", lambda sid: opened.append(sid) or -1)
    monkeypatch.setattr(tracing, "_RANGE", lambda name: opened.append(name))
    monkeypatch.setattr(tracing.RING, "write", lambda *a: opened.append(a))
    before = tracing.RING.written
    for _ in range(100):
        for call in calls.values():
            call()
    assert tracing.RING.written == before
    assert opened == []
    assert not tracing.profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        calls["eval_torch"]()
    assert tracing.ENTRY in opened and tracing.DISPATCH in opened


SWITCH = ("_is_profiler_enabled", "tracing.call(", "tracing.span(")


def test_only_the_tracing_module_reads_the_switch():
    """Every span is declared by `tracing.traced`: no other module of the
    package tests the profiler's switch or opens a span by hand."""
    package = ROOT / "interpn_tpu_torch"
    found = [f"{path.relative_to(ROOT)}: {word}"
             for path in sorted(package.rglob("*.py")) if path != package / "utils" / "tracing.py"
             for word in SWITCH if word in path.read_text()]
    assert found == []


# each function declared in a span by `tracing.traced`, by module and name
TRACED = {
    "raw": ["_interpn_regular", "_interpn_rectilinear"],
    "_entry": ["copy_into"],
    "models._device.DeviceInterpolator": ["eval_torch", "_torch_inputs", "eval_unchecked",
                                          "_out_inputs", "gradient_torch"],
    "ops": ["bspline_eval", "bspline_eval_stack"],
    "ops.dispatch": ["_route", "_regular", "_rect_route"],
    "ops.stack": ["_regular_stack", "_rectilinear_stack"],
    "ops.fused": ["_chosen", "_regular", "_rectilinear", "_bspline"],
    "ops.df64": ["eval_regular", "eval_rectilinear", "eval_bspline"],
    "ops.i8": ["eval_regular", "eval_rectilinear"],
    "ops.unrep": ["flag"],
    "utils.tracing": ["host_numpy"],
}


def _traced(where, name):
    module = where.removesuffix(".DeviceInterpolator")
    obj = importlib.import_module(f"interpn_tpu_torch.{module}")
    return getattr(obj.DeviceInterpolator if where != module else obj, name)


@pytest.mark.parametrize("where,name", [(w, n) for w, names in TRACED.items() for n in names],
                         ids=[f"{w}.{n}" for w, names in TRACED.items() for n in names])
def test_a_traced_function_keeps_its_signature_and_docstring(where, name):
    fn = _traced(where, name)
    plain = fn.__wrapped__  # the undecorated function
    assert inspect.signature(fn) == inspect.signature(plain)
    assert (fn.__name__, fn.__qualname__, fn.__doc__) == (plain.__name__, plain.__qualname__,
                                                          plain.__doc__)
    if not name.startswith("_"):
        assert plain.__doc__


@pytest.mark.parametrize("name", ["eval_torch", "eval_out", "gradient_torch", "ops", "stack",
                                  "raw"])
def test_spans_change_no_result(name):
    model = _model()
    obs = _obs()
    out = torch.empty(N)
    plain = _calls(model, obs, out)[name]().clone()
    got, rows, _ = _recorded(_calls(model, obs, out)[name])
    assert len(rows) >= 2
    torch.testing.assert_close(got, plain, rtol=0, atol=0, equal_nan=True)


# --- on ----------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("case", CLASS_CASES, ids=CLASS_IDS)
def test_eval_torch_records_entry_around_checks_then_dispatch(monkeypatch, case, kernel):
    """One `entry` holds `checks`, then `dispatch`; on the kernel route (the
    wrapper's plain version on CPU tensors) the `wrapper` sits in `dispatch`."""
    if kernel:
        monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    model, obs = _case(*case)
    plain = model.eval_torch(obs)
    got, rows, _ = _recorded(lambda: model.eval_torch(obs))
    torch.testing.assert_close(got, plain, rtol=0, atol=0, equal_nan=True)
    assert sorted(_names(rows)) == ["checks", "dispatch", "entry"] + ["wrapper"] * kernel
    entry, checks, dispatch_ = (_one(rows, n) for n in ("entry", "checks", "dispatch"))
    assert entry[1] <= checks[1] < checks[2] <= dispatch_[1] < dispatch_[2] <= entry[2]
    assert (entry[3], checks[3], dispatch_[3]) == (0, 1, 1)
    if kernel:
        wrapper = _one(rows, "wrapper")
        assert dispatch_[1] < wrapper[1] < wrapper[2] <= dispatch_[2] and wrapper[3] == 2
    assert (rows[:, 4] == -1).all()  # no events on the CPU


def test_the_rectilinear_cells_table_takes_the_taps_route():
    """1.28 MB of float64 is above the staging cap, so one 20^4 f64 cubic
    table is read through its cubic pack."""
    assert math.prod(CELL_DIMS) * 8 > fused.STAGE_BYTES
    assert fused.rectilinear_route(CELL_DIMS, torch.float64, "cubic") == "taps"
    assert fused.RECT_LAYOUTS["taps"] == "rectilinear_cubic_pack"


def test_eval_into_a_tensor_records_the_flag_one_sync_and_finish():
    model = _model()
    obs = _obs()
    obs[0][5] = float("nan")  # the flag is set, and the call raises
    out = torch.empty(N)
    with pytest.raises(AssertionError, match="Unrepresentable coordinate value"):
        _recorded(lambda: model.eval(obs, out=out))
    _, rows, _ = _recorded(lambda: model.eval(_obs(), out=out))
    assert sorted(_names(rows)) == ["checks", "dispatch", "entry", "finish", "sync",
                                    "unrep_flag"]
    entry, flag, sync, finish = (_one(rows, n) for n in ("entry", "unrep_flag", "sync", "finish"))
    assert entry[1] < flag[1] < flag[2] <= sync[1] < sync[2] <= finish[1] < finish[2] <= entry[2]


@pytest.mark.parametrize("name", ["eval_torch", "eval_out", "gradient_torch"])
def test_a_class_call_records_one_entry(name):
    model = _model()
    obs = _obs()
    _, rows, _ = _recorded(_calls(model, obs, torch.empty(N))[name])
    assert _names(rows).count("entry") == 1
    assert _one(rows, "entry")[3] == 0 and (rows[:, 3] >= 0).all()


@pytest.mark.parametrize("name", ["ops", "stack", "raw"])
def test_an_ops_or_raw_call_records_its_own_entry(name):
    model = _model()
    _, rows, _ = _recorded(_calls(model, _obs(), torch.empty(N))[name])
    entry = _one(rows, "entry")
    assert entry[3] == 0
    assert ((rows[:, 1] >= entry[1]) & (rows[:, 2] <= entry[2])).all()
    assert "dispatch" in _names(rows)


def test_raw_counts_each_read_to_the_host(monkeypatch):
    """`raw` from tensors reads the steps (its checks), the flag and, into
    a numpy `out`, the result: three syncs; into a tensor `out`, two."""
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")
    model = _model()
    obs = _obs()
    t = model._device().tensors(obs[0].device)
    for out, syncs in ((np.empty(N, np.float32), 3), (torch.empty(N), 2)):
        _, rows, _ = _recorded(
            lambda: raw.interpn_linear_regular_f32(list(DIMS), t[0], t[1], t[2], obs, out))
        assert _names(rows).count("sync") == syncs


def test_each_span_is_a_profiler_range(monkeypatch):
    """Every span on the CPU's path is a profiler range `interpn.<span>`;
    the kernel route (the wrapper's plain version on CPU tensors) adds the
    `wrapper` span under `dispatch`."""
    monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    model = _model()
    obs = _obs()
    _, rows, events = _recorded(lambda: model.eval(obs, out=torch.empty(N)))
    ranges = {e.name for e in events if e.name.startswith("interpn.")}
    want = {"entry", "checks", "dispatch", "wrapper", "unrep_flag", "sync", "finish"}
    assert set(_names(rows)) == want
    assert ranges == {f"interpn.{n}" for n in want}
    wrapper, dispatch_ = _one(rows, "wrapper"), _one(rows, "dispatch")
    assert dispatch_[1] < wrapper[1] < wrapper[2] < dispatch_[2] and wrapper[3] == 2


def test_an_export_is_the_same_with_a_profiler_open(monkeypatch):
    monkeypatch.setattr(dispatch, "_impl", lambda vals: "kernel")
    model = _model(MulticubicRegular, np.float64)

    def graphs():
        served = aot.load(aot.export_eval(model, [16, 40], device="cpu"))
        return [str(call.graph) for call in served._calls.values()]

    closed = graphs()
    before = tracing.RING.written
    with profile(activities=[ProfilerActivity.CPU]):
        opened = graphs()
    assert opened == closed
    assert any("interpn_tpu_torch.regular" in g for g in closed)
    assert tracing.RING.written == before


# --- the ring ----------------------------------------------------------------------


def test_the_ring_refuses_a_window_it_has_overwritten():
    ring = tracing.Ring(8)
    for i in range(20):  # records i: [100 i, 100 i + 50]
        ring.write(tracing.SYNC, 100 * i, 100 * i + 50, 0, -1)
    assert (ring.written, ring.overwritten) == (20, 12)
    kept = ring.kept()
    assert kept[:, 1].tolist() == [100 * i for i in range(12, 20)]
    # record 11 closed at 1150 and is gone: a window from there may miss it
    assert ring.between(1100, 10**6) is None
    assert ring.between(1250, 10**6) is None  # 1250 is record 12's close
    assert ring.between(1251, 10**6)[:, 1].tolist() == [1300 + 100 * i for i in range(7)]
    assert ring.between(1300, 1750)[:, 1].tolist() == [1300, 1400, 1500, 1600, 1700]
    assert ring.device_ns(ring.between(1300, 1450)).tolist() == [50.0, 50.0]


def test_a_reader_over_an_overwritten_window_gives_nothing(monkeypatch):
    ring = tracing.Ring(4)
    for i in range(6):
        ring.write(tracing.ENTRY, 1000 * i, 1000 * i + 500, 0, -1)
    monkeypatch.setitem(sys.modules, spans.MODULE,
                        SimpleNamespace(SPANS=tracing.SPANS, RING=ring))
    old = _run(starts=[0], ends=[6000], steps=6)
    assert spans.window(old) is None
    assert all(_reader(name).read(old) is None for name in READERS)
    assert spans.window(_run(starts=[2600], ends=[6000], steps=3)) is not None


# --- the readers -------------------------------------------------------------------


def _reader(name):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                       "metric_" + name.replace(".", "_"))


def _run(starts, ends, steps):
    return SimpleNamespace(window=SimpleNamespace(starts=starts, ends=ends, steps=steps))


def _hand_ring():
    """Two steps in the window [1000, 10000] and one record before it: a
    checked call, then a call with no flag."""
    ring = tracing.Ring(64)
    records = [
        ("entry", 100, 900, 0), ("sync", 200, 300, 1),  # before the window
        ("checks", 1100, 1300, 1), ("route", 1700, 1900, 3), ("launch", 2000, 2900, 3),
        ("wrapper", 1600, 3000, 2), ("dispatch", 1500, 3500, 1), ("unrep_flag", 3600, 3800, 1),
        ("sync", 3850, 3900, 1), ("finish", 3910, 3990, 1), ("entry", 1000, 4000, 0),
        ("route", 5600, 6600, 3), ("wrapper", 5500, 7000, 2), ("dispatch", 5400, 8000, 1),
        ("entry", 5000, 9000, 0),
    ]
    for name, a, b, depth in records:
        ring.write(tracing.SPANS.index(name), a, b, depth, -1)
    return ring


# by hand, over the two steps: dispatch starts 500 and 400 ns after its
# entry; dispatch 2000 - 1400 and 2600 - 1500 ns of its own; routes 200 and
# 1000 ns; one sync; the flag 200 ns on the host
HAND = {"entry.predispatch_ms": 450e-6, "dispatch.host_ms": 850e-6, "wrappers.route_ms": 600e-6,
        "entry.syncs_per_step": 0.5, "entry.flag_device_ms": 100e-6}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_the_hand_computed_value(monkeypatch, name):
    monkeypatch.setitem(sys.modules, spans.MODULE,
                        SimpleNamespace(SPANS=tracing.SPANS, RING=_hand_ring()))
    got = _reader(name).read(_run(starts=[1000], ends=[10000], steps=2))
    assert got == pytest.approx(HAND[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_nothing_without_the_tracing_module(monkeypatch, name):
    monkeypatch.delitem(sys.modules, spans.MODULE)
    assert _reader(name).read(_run(starts=[1000], ends=[10000], steps=2)) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_nothing_for_a_window_with_no_entry(monkeypatch, name):
    monkeypatch.setitem(sys.modules, spans.MODULE,
                        SimpleNamespace(SPANS=tracing.SPANS, RING=_hand_ring()))
    assert _reader(name).read(_run(starts=[9500], ends=[10000], steps=1)) is None


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_recorded(fn):
    before = tracing.RING.written
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = fn()
        torch.cuda.synchronize()
    return got, _since(before), prof


def _card_call(name, device):
    """(the call `name`, the launches it makes a call where they are known):
    `rect4d20` is the benchmark's rectilinear cell's path at its 20^4 f64
    cubic table, one K2 cubic launch on its cubic pack a call."""
    if name.startswith("rect4d20"):
        model = _rect_model(MulticubicRectilinear, CELL_DIMS, name == "rect4d20")
        obs = _rect_obs(len(CELL_DIMS), device, 10_000)
        return (lambda: model.eval_torch(obs)), {"rectilinear_cubic": 1,
                                                 "rectilinear_cubic_pack": 1}
    return _calls(_model(), _obs(device), None)[name], None


def _launched(before):
    return {k: v - before.get(k, 0) for k, v in fused.launches.items() if v != before.get(k, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["eval_torch", "stack", "rect4d20", "rect4d20-no-linearize"])
def test_card_wrapper_route_and_launch_spans(cuda, name):
    call, want = _card_call(name, cuda)
    plain = call()  # builds the library and caches the tensors on the card
    torch.cuda.synchronize()
    launches = dict(fused.launches)
    plain = call().clone()
    untraced = _launched(launches)
    launches = dict(fused.launches)
    got, rows, prof = _card_recorded(call)
    traced = _launched(launches)
    assert traced == untraced and sum(traced.values()) >= 1
    assert want is None or untraced == want
    torch.testing.assert_close(got, plain, rtol=0, atol=0, equal_nan=True)
    names = _names(rows)
    for n in ("entry", "dispatch", "wrapper", "route", "launch"):
        assert names.count(n) == 1, names
    if want is not None:
        assert names.count("checks") == 1 and "sync" not in names, names
    dispatch_, wrapper, route, launch = (_one(rows, n) for n in
                                         ("dispatch", "wrapper", "route", "launch"))
    assert dispatch_[1] < wrapper[1] <= route[1] < route[2] <= launch[1] < launch[2] <= wrapper[2]
    assert (wrapper[3], route[3], launch[3]) == (2, 3, 3)


@pytest.mark.gpu
def test_card_flag_records_its_events(cuda):
    model = _model()
    out = torch.empty(N, device=cuda)
    # the first flag on the card builds its library, inside the span
    model.eval(_obs(cuda), out=out)
    _, rows, _ = _card_recorded(lambda: model.eval(_obs(cuda), out=out))
    flag = _one(rows, "unrep_flag")
    assert flag[4] >= 0
    assert _names(rows).count("sync") == 1
    device = tracing.RING.device_ns(flag[None, :])
    assert device is not None and 0 < device[0] < 1e9


@pytest.mark.gpu
def test_card_ranges_stay_off_the_device_timeline(cuda):
    from torch.autograd import DeviceType

    model = _model()
    out = torch.empty(N, device=cuda)
    _, _, prof = _card_recorded(lambda: (model.eval_torch(_obs(cuda)),
                                         model.eval(_obs(cuda), out=out)))
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.name().startswith("interpn.")}
    device = {e.name() for e in events if e.name().startswith("interpn.")
              and e.device_type() == DeviceType.CUDA}
    assert {"interpn.entry", "interpn.launch", "interpn.unrep_flag"} <= host
    assert device == set()
