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
