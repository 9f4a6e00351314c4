"""The port's build machinery and numerics settings, on the CPU (no nvcc
here: the build's success path runs on the card, through chip_smoke.py and
tests/test_torch_gpu.py)."""

import pytest
import torch

from interpn_tpu_torch import _build, config


def test_library_path_names_sources_and_flags(monkeypatch):
    path = _build.library_path("fused_regular")
    assert path == _build.library_path("fused_regular")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libfused_regular_") and path.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.library_path("fused_regular") != path


def test_sources_ship_in_csrc():
    # each names the TPU kernels it replaces
    src = (_build.CSRC / "fused_regular.cu").read_text()
    assert 'extern "C" int interpn_regular(' in src
    assert "pallas_v3.py::_pallas_v3" in src
    src = (_build.CSRC / "fused_rectilinear.cu").read_text()
    assert 'extern "C" int interpn_rectilinear(' in src
    assert "_pallas_v3_pre" in src and "_pallas_v3_rect" in src
    assert '#include "interp_common.cuh"' in src


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_failed_compile_raises_and_leaves_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")  # exits 1
    so = _build.BUILD_DIR / "libx_0.so"
    with pytest.raises(RuntimeError, match="nvcc failed with exit code 1"):
        _build._compile(_build.CSRC / "fused_regular.cu", so)
    assert list(_build.BUILD_DIR.iterdir()) == []


def test_parts_compile_apart_and_link_once(monkeypatch, tmp_path):
    """A source with PARTS: one nvcc -c per unit (without -shared), then one
    link of the objects into the library; the log holds every step's
    output, and no object is left behind. A library's name hashes every
    unit."""
    fake = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {calls}\n"
                    "while [ \"$1\" != -o ]; do shift; done; touch \"$2\"; echo ptxas ok\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    src = _build.CSRC / "fused_rectilinear_stack.cu"
    assert [u.name for u in _build._units(src)] == ["fused_rectilinear_stack.cu",
                                                     "fused_rectilinear_stack_lerp.cu"]
    so = _build.BUILD_DIR / "libx_0.so"
    _build._compile(src, so)
    lines = calls.read_text().splitlines()
    assert len(lines) == 3
    compiles = sorted(lines[:2], key=lambda line: line.endswith("_lerp.cu"))  # run at once
    for line, unit in zip(compiles, _build._units(src)):
        assert " -c " in f" {line} " and "-shared" not in line and line.endswith(str(unit))
    assert "-shared" in lines[2] and lines[2].count(".o") == 2
    assert so.exists() and so.with_suffix(".log").read_text() == "ptxas ok\n" * 3
    assert sorted(p.name for p in _build.BUILD_DIR.iterdir()) == ["libx_0.log", "libx_0.so"]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for unit in _build._units(src):
        (csrc / unit.name).write_text(unit.read_text())
    monkeypatch.setattr(_build, "CSRC", csrc)
    path = _build.library_path("fused_rectilinear_stack")
    (csrc / "fused_rectilinear_stack_lerp.cu").write_text("// changed\n")
    assert _build.library_path("fused_rectilinear_stack") != path


def test_failed_part_raises_and_leaves_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")  # exits 1
    so = _build.BUILD_DIR / "libx_0.so"
    with pytest.raises(RuntimeError, match="nvcc failed with exit code 1"):
        _build._compile(_build.CSRC / "fused_rectilinear_stack.cu", so)
    assert list(_build.BUILD_DIR.iterdir()) == []


def test_require_ieee_fp32():
    config.require_ieee_fp32()  # PyTorch's defaults
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    old_precision = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            config.require_ieee_fp32()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("high")  # also turns TF32 on
        with pytest.raises(RuntimeError, match="allow_tf32|'highest'"):
            config.require_ieee_fp32()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
        torch.set_float32_matmul_precision(old_precision)


def test_default_device_is_torchs(monkeypatch):
    """The default is torch's current CUDA device, whatever torch's own
    default device is; a request overrides it; without a card and without a
    request the port raises rather than compute on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with torch.device("meta"):
        assert config.default_device() == torch.device("cuda", 1)
    with config.device("cpu") as dev:
        assert dev == torch.device("cpu") == config.default_device()
        with config.device("meta"):
            assert config.default_device() == torch.device("meta")
        assert config.default_device() == torch.device("cpu")
    assert config.default_device() == torch.device("cuda", 1)
    config.set_device("cpu")
    try:
        assert config.default_device() == torch.device("cpu")
    finally:
        config.set_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"config\.set_device\('cpu'\)"):
        config.default_device()


class _FakeEvent:
    """A CUDA event whose query() says whether the spin still held."""

    pending = True

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def query(self):
        return not _FakeEvent.pending

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 2.0


def _fake_cuda(monkeypatch, spins):
    from interpn_tpu_torch.utils import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    monkeypatch.setattr(profiling, "_spin_cycles", 1 << 22)
    return profiling


def test_timer_head_start_is_bounded(monkeypatch):
    """A pass that never gets ahead (a function that synchronises) doubles
    the spin up to the cap and returns, flagged, rather than raise or spin
    on; one that does get ahead keeps the spin it needed."""
    spins = []
    profiling = _fake_cuda(monkeypatch, spins)
    _FakeEvent.pending = False
    t = profiling.cuda_time(lambda b: None, [0] * 4)
    assert not t.ahead and t.device_ms == 0.5 and t.loop_ms == 0.5
    assert spins == [1 << c for c in range(22, 28)] and t.spin_cycles == profiling._SPIN_MAX
    spins.clear()
    _FakeEvent.pending = True
    t = profiling.cuda_time(lambda b: None, [0] * 4)
    assert t.ahead and spins == [profiling._SPIN_MAX]


def test_timers_let_exceptions_through_and_profiler_retries(monkeypatch):
    profiling = _fake_cuda(monkeypatch, [])

    def boom(_):
        raise KeyError("timed function")

    for timer in (profiling.cuda_time, profiling.profiled_time):
        with pytest.raises(KeyError, match="timed function"):
            timer(boom, [0] * 4)
    seen = []

    def events(run):
        run()
        seen.append(1)
        # the first pass records nothing; the second drops 2 of 40 events
        return [(0, 0.0), (38, 57.0)][len(seen) - 1]

    monkeypatch.setattr(profiling, "_device_events", events)
    t = profiling.profiled_time(lambda b: None, [0] * 20)
    assert t == profiling.Profiled(57.0 / 1e3 / 38 * 2, 38, 2, 2)
    # a one-kernel call that lost 11 of its 20 events still counts one a call
    monkeypatch.setattr(profiling, "_device_events", lambda run: (9, 18.0))
    assert profiling.profiled_time(lambda b: None, [0] * 20) == profiling.Profiled(
        18.0 / 1e3 / 9, 9, 1, 1)
    monkeypatch.setattr(profiling, "_device_events", lambda run: (0, 0.0))
    assert profiling.profiled_time(lambda b: None, [0] * 20) == profiling.Profiled(
        None, 0, 0, profiling.PROFILER_TRIES)
