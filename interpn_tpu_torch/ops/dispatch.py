"""Implementation selection between the Hopper kernel and the gather tree.

Counterpart of `interpn_tpu/ops/dispatch.py` for regular-grid linear
evaluation. The JAX package picks among five engines from static trace
information; here the device decides: a CUDA tensor goes to the kernel
(`ops/fused.py`, f32 and f64, any batch size), a CPU tensor to the gather
tree (`ops/linear.py`). The kernel reads only the stencil, so the TPU's
finite-table guard, batch floor and grid-size caps have no counterpart.

The kernel has no backward kernel (nor had the TPU kernel), so gradients of
the kernel path come from the gather tree, as the JAX package's
`_with_gather_jvp` takes tangents from it.
"""

from __future__ import annotations

import torch

from . import fused as _fused
from .linear import linear_regular as _linear_reg_gather


class LinearRegularKernel(torch.autograd.Function):
    """Forward: the fused kernel. Backward: the vector-Jacobian product of
    the gather tree at the same inputs."""

    @staticmethod
    def forward(ctx, dims, starts, steps, vals, *obs):
        ctx.dims = dims
        ctx.save_for_backward(starts, steps, vals, *obs)
        return _fused.eval_regular(dims, starts, steps, vals, obs)

    @staticmethod
    def backward(ctx, grad_out):
        dims = ctx.dims

        def gather(st, sp, v, *ob):
            return _linear_reg_gather(dims, st, sp, v, ob)

        _, vjp_fn = torch.func.vjp(gather, *ctx.saved_tensors)
        return (None, *vjp_fn(grad_out))


def _impl(vals: torch.Tensor) -> str:
    """'kernel' for a CUDA tensor, 'gather' otherwise."""
    return "kernel" if vals.device.type == "cuda" else "gather"


def linear_regular(dims, starts, steps, vals, obs):
    """Multilinear eval on a regular grid; obs is a tuple of ndims tensors of
    one shape, and the result has that shape."""
    dims = tuple(int(d) for d in dims)
    if _impl(vals) == "kernel":
        shape = obs[0].shape
        flat = [o.reshape(-1).contiguous() for o in obs]
        out = LinearRegularKernel.apply(
            dims, starts.contiguous(), steps.contiguous(), vals.contiguous(), *flat
        )
        return out.reshape(shape)
    return _linear_reg_gather(dims, starts, steps, vals, obs)
