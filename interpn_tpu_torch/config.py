"""Device and numerics settings of the port.

Host (numpy) inputs to `raw.*` and `interpn()` compute on the CUDA device
(`torch.cuda.current_device()`) unless the caller asks for another device
with `set_device(...)` or, for a block of code, `with device(...):`.
Without a CUDA device and without such a request they raise RuntimeError:
the port never carries on quietly on the CPU. Tensor inputs compute where
they live, whatever is set here.

Numpy inputs with a numpy `out` go to the native C++ engine
(`interpn_tpu_torch.native`) when the CPU is the device in force
(`cpu_requested`), or when INTERPN_TPU_NATIVE_THRESHOLD asks for it on
small batches; INTERPN_TPU_NATIVE=0 turns the engine off. No call falls
back from the card to the CPU when a CUDA call fails.

The port's path holds no matrix product, but its results are compared with
plain PyTorch versions that could hold one. PyTorch's defaults keep float32
products in full float32 (`torch.backends.cuda.matmul.allow_tf32` False,
`torch.get_float32_matmul_precision()` "highest"); TF32 would keep about
three decimal digits. `require_ieee_fp32` checks that nobody changed them.

What of `interpn_tpu/config.py` has no counterpart here, and why:

* the x64 switch (`jax_enable_x64`, INTERPN_TPU_NO_X64): torch has float64
  natively, so there is nothing to enable;
* the persistent XLA compilation cache and `host_feature_tag`, which keys
  it by the host's CPU features: the port's compiled state is the kernel
  libraries that `_build.py` builds from `csrc/` into its build directory,
  and the serving artifacts of `aot.py`;
* `INDEX_DTYPE`: the kernels' index width is fixed in `csrc/` (int32
  indices, refused above 2^31 entries by the wrappers in `ops/fused.py`).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_requested: torch.device | None = None


def set_device(dev) -> None:
    """Place host (numpy) inputs on `dev` ("cpu", "cuda:1", a
    torch.device), or go back to the CUDA default with None."""
    global _requested
    _requested = None if dev is None else torch.device(dev)


@contextlib.contextmanager
def device(dev) -> Iterator[torch.device]:
    """`set_device(dev)` for the body of a `with` block, then the earlier
    setting again."""
    global _requested
    before = _requested
    set_device(dev)
    try:
        yield _requested
    finally:
        _requested = before


def default_device() -> torch.device:
    """The device that host (numpy) inputs are placed on: the requested one,
    else the current CUDA device. Raises RuntimeError when neither exists."""
    if _requested is not None:
        return _requested
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError(
        "interpn_tpu_torch: no CUDA device for numpy inputs; to compute on the "
        "CPU, ask for it with interpn_tpu_torch.config.set_device('cpu') or "
        "`with interpn_tpu_torch.config.device('cpu'):`"
    )


def cpu_requested() -> bool:
    """Whether the caller asked for the CPU as the device of host (numpy)
    inputs (`set_device("cpu")` or `with device("cpu"):`)."""
    return _requested is not None and _requested.type == "cpu"


def require_ieee_fp32() -> None:
    """Raise RuntimeError unless float32 matrix products run in full
    float32 (no TF32)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True; the port's "
            "float32 results are specified in IEEE float32"
        )
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        raise RuntimeError(
            f"float32 matmul precision is {precision!r}, expected 'highest'"
        )
