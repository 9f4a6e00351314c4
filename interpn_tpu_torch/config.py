"""Device and numerics settings of the port.

Host (numpy) inputs to `raw.*` and `interpn()` compute on the CUDA device
(`torch.cuda.current_device()`) unless the caller asks for another device
with `set_device(...)` or, for a block of code, `with device(...):`.
Without a CUDA device and without such a request they raise RuntimeError:
the port never carries on quietly on the CPU. Tensor inputs compute where
they live, whatever is set here.

The port's path holds no matrix product, but its results are compared with
plain PyTorch versions that could hold one. PyTorch's defaults keep float32
products in full float32 (`torch.backends.cuda.matmul.allow_tf32` False,
`torch.get_float32_matmul_precision()` "highest"); TF32 would keep about
three decimal digits. `require_ieee_fp32` checks that nobody changed them.
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
