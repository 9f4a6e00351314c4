"""One seeded round of each leg of `scripts/fuzz_torch.py`, the port
against the JAX package on the CPU at small sizes; the gather leg also on
jittered 100-point axes with a standard normal table."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("pydantic")

_PATH = Path(__file__).resolve().parent.parent / "scripts" / "fuzz_torch.py"


@pytest.fixture(scope="module")
def fuzz():
    spec = importlib.util.spec_from_file_location("fuzz_torch", _PATH)
    module = importlib.util.module_from_spec(spec)
    sys.modules["fuzz_torch"] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")


LEGS = ["gather", "raw", "interpn", "interpn_stack", "pchip", "one_dim", "classes",
        "functional", "compat"]


@pytest.mark.parametrize("leg", LEGS)
def test_leg_round(fuzz, leg):
    assert sorted(fuzz.LEGS) == sorted(LEGS)
    fuzz.run_round(leg, np.random.default_rng(LEGS.index(leg)))


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_on_jittered_100_point_axes(fuzz, seed):
    what = fuzz.run_round("gather", np.random.default_rng(seed), jittered=True)
    assert "jittered 100-point" in what


def test_disagreement_is_reported(fuzz):
    with pytest.raises(fuzz.Disagreement, match="not bitwise"):
        fuzz.agree(np.array([1.0]), np.array([1.0 + 1e-15]), np.float64, 1.0, "x", exact=True)
    with pytest.raises(fuzz.Disagreement, match="outside"):
        fuzz.agree(np.array([1.0]), np.array([1.001]), np.float32, 1.0, "x")
    fuzz.agree(np.array([1.0, np.nan]), np.array([1.0 + 1e-13, np.nan]), np.float64, 1.0, "x")
