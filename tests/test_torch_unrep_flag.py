"""The regular grids' unrepresentable-coordinate flag on the CPU
(`ops.unrep.flag`): on CPU tensors it is its plain passes
(`ops.unrep.plain`) and launches nothing; the plain predicate is numpy's
floor((x - start) / step) outside [-2^63, 2^63) on adversarial queries
(`utils.testing.unrep_edge_cases`) at the first, middle and last query of
1, 3 and 8 axes, and so is the same predicate without the floor, which the
kernel skips; the wrapper refuses what its kernel does not take. The
kernel (`csrc/unrep_flag.cu`) against the plain passes on the card:
`tests/test_torch_gpu.py`."""

import numpy as np
import pytest
import torch

from interpn_tpu_torch.ops import unrep
from interpn_tpu_torch.utils.testing import unrep_edge_cases

N = 7
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _numpy_flag(starts, steps, obs, floor=True) -> bool:
    """numpy's flag; `floor=False` drops the floor, as the kernel does."""
    dtype = starts.dtype.type
    big = dtype(2.0**63)
    rnd = np.floor if floor else (lambda v: v)
    with np.errstate(all="ignore"):
        floc = [rnd((x - starts[k]) / steps[k]) for k, x in enumerate(obs)]
    return any(bool(np.any(~((f >= -big) & (f < big)))) for f in floc)


def _tensors(starts, steps, obs):
    t = [torch.from_numpy(a) for a in (starts, steps, *obs)]
    return t[0], t[1], t[2:]


def _refused(kind):
    """(starts, steps, obs) of a call the wrapper refuses, and the error."""
    starts, steps = torch.zeros(2), torch.ones(2)
    obs = [torch.zeros(N), torch.zeros(N)]
    if kind == "dtype":
        return starts, steps, [obs[0], obs[1].double()], TypeError
    if kind == "device":
        return starts, steps, [obs[0], obs[1].to("meta")], ValueError
    if kind == "strided":
        return starts, steps, [obs[0], torch.zeros(2 * N)[::2]], ValueError
    if kind == "lengths":
        return starts, steps, [obs[0], torch.zeros(N + 1)], ValueError
    return torch.zeros(9), torch.ones(9), [torch.zeros(N)] * 9, ValueError  # nine axes


CASES = [pytest.param(dtype, name, id=f"{np.dtype(dtype).name}-{name}")
         for dtype in (np.float32, np.float64)
         for name, *_ in unrep_edge_cases(dtype)]
CASES += [pytest.param(None, kind, id=f"refuses-{kind}")
          for kind in ("dtype", "device", "strided", "lengths", "nine-axes")]


@pytest.mark.parametrize("dtype,case", CASES)
def test_unrep_flag_on_the_cpu(dtype, case):
    before = unrep.launches
    if dtype is None:
        starts, steps, obs, error = _refused(case)
        with pytest.raises(error):
            unrep.flag(starts, steps, obs)
        assert unrep.launches == before
        return
    _, x, s, h, expect = next(c for c in unrep_edge_cases(dtype) if c[0] == case)
    rng = np.random.default_rng(3)
    for ndims in (1, 3, 8):
        for pos in (0, N // 2, N - 1):
            starts = rng.uniform(-1, 1, ndims).astype(dtype)
            steps = rng.uniform(0.3, 1, ndims).astype(dtype)
            obs = [(starts[k] + steps[k] * rng.uniform(-5, 25, N)).astype(dtype)
                   for k in range(ndims)]
            axis = (pos + ndims) % ndims
            starts[axis], steps[axis] = s, h
            obs[axis] = rng.uniform(-5, 25, N).astype(dtype)
            obs[axis][pos] = x
            want = _numpy_flag(starts, steps, obs)
            assert want == expect == _numpy_flag(starts, steps, obs, floor=False)
            plain = unrep.plain(*_tensors(starts, steps, obs))
            got = unrep.flag(*_tensors(starts, steps, obs))
            assert got.dtype == torch.bool and got.shape == () and got.device.type == "cpu"
            assert bool(plain) == bool(got) == want, (ndims, pos)
    assert unrep.launches == before
