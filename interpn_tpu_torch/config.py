"""Device and numerics settings of the port.

Host (numpy) inputs are placed on `torch.get_default_device()`: the caller
chooses the device with `torch.set_default_device`, and a host that has a
card still computes on the CPU unless told otherwise.

The port's path holds no matrix product, but its results are compared with
plain PyTorch versions that could hold one. PyTorch's defaults keep float32
products in full float32 (`torch.backends.cuda.matmul.allow_tf32` False,
`torch.get_float32_matmul_precision()` "highest"); TF32 would keep about
three decimal digits. `require_ieee_fp32` checks that nobody changed them.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device that host (numpy) inputs are placed on."""
    return torch.get_default_device()


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
