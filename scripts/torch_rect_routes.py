#!/usr/bin/env python3
"""Times every route of one linear or nearest rectilinear table (K2 linear,
K3: direct, guided, staged) of the `interpn_tpu_torch` found first on
sys.path, on one CUDA card.

    PYTHONPATH=DIR python3 scripts/torch_rect_routes.py TAG

DIR is the root of a checkout, or of a copy of `interpn_tpu_torch/` with a
variant of the kernel (put there beside a copy of `chip_smoke.py`); TAG
labels its lines. Run it on two copies in one call to compare them. Each
case is a table of random values on `chip_smoke.py`'s jittered axes
(`bench_rect_axes`) or on its geometric ones (`rect_axes`: cells growing
by 1.3 from one to the next, over [0, 10]), and 20 batches of 1e6 queries
uniform in [-0.5, 10.5]. On each, every route the copy has
(`fused._relaid_launch`) is held
bitwise against the plain version on the first batch and timed by CUDA
events behind a head start (`utils/profiling.py::cuda_time`) in the order
direct, guided, staged, guided, direct; a route over its cap prints "over
cap". Each line ends with registers / static shared bytes / local bytes /
blocks an SM of the guided and staged instantiations
(`fused.regular_info(..., family="rectilinear")`).
"""

import sys

import numpy as np
import torch

import chip_smoke as cs
from interpn_tpu_torch.ops import fused
from interpn_tpu_torch.utils.profiling import cuda_time

F32, F64 = torch.float32, torch.float64
N, BATCHES = 1_000_000, 20
# (method, points an axis, ndims, dtype, axes)
CASES = [
    ("linear", 20, 3, F32, "jittered"), ("nearest", 20, 3, F32, "jittered"),
    ("linear", 20, 3, F64, "jittered"), ("nearest", 20, 3, F64, "jittered"),
    ("linear", 100, 3, F32, "jittered"), ("linear", 1000, 2, F32, "jittered"),
    ("nearest", 1000, 2, F32, "jittered"), ("linear", 20, 3, F32, "geometric"),
    ("nearest", 20, 3, F32, "geometric"), ("nearest", 100, 3, F32, "jittered"),
    ("linear", 100, 3, F64, "jittered"), ("linear", 40, 3, F32, "jittered"),
    ("linear", 60, 3, F32, "jittered"), ("nearest", 60, 3, F32, "jittered"),
    ("linear", 300, 2, F32, "jittered"), ("nearest", 300, 2, F32, "jittered"),
    ("linear", 30, 3, F64, "jittered"), ("linear", 12, 4, F32, "jittered"),
    ("linear", 20, 4, F32, "jittered"), ("nearest", 20, 4, F32, "jittered"),
    ("linear", 3000, 1, F32, "jittered"), ("linear", 8, 5, F64, "jittered"),
]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_rect_routes: torch.cuda.is_available() is False; needs a CUDA device")
    tag = sys.argv[1]
    cuda = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    for method, n, nd, dtype, kind in CASES:
        dims = (n,) * nd
        axes = (cs.bench_rect_axes(n, nd) if kind == "jittered"
                else [cs.rect_axes("geometric", n, None)] * nd)
        grids = tuple(torch.as_tensor(a, dtype=dtype, device=cuda) for a in axes)
        vals = torch.as_tensor(rng.standard_normal(n**nd), dtype=dtype, device=cuda)
        batches = [tuple(torch.rand(N, generator=gen, device=cuda, dtype=dtype) * 11 - 0.5
                         for _ in range(nd)) for _ in range(BATCHES)]
        cols = (fused._VOIDP * nd)(*(g.data_ptr() for g in grids))
        want = fused.plain_rectilinear(grids, vals, batches[0], method)
        res = {}
        for route in ("direct", "guided", "staged", "guided", "direct"):
            def fn(ob, route=route):
                return fused._relaid_launch("rectilinear", route, fused.RECT_LAYOUTS, dims, vals,
                                            ob, method, True, N, False, cols)
            try:
                if route not in res:
                    cs.bitwise(fn(batches[0]), want, f"{tag} {method} {dims} {route}")
                res.setdefault(route, []).append(round(cuda_time(fn, batches).device_ms, 5))
            except RuntimeError:
                res[route] = ["over cap"]
        info = {}
        for route in ("guided", "staged"):
            try:
                got = fused.regular_info(method, dtype, nd, route, False, "rectilinear")
                info[route] = "/".join(str(v) for v in got.values())
            except RuntimeError:
                info[route] = "none"
        print(f"{tag}: {method} {n}^{nd} {str(dtype)[6:]} {kind}: {res} info {info}", flush=True)


if __name__ == "__main__":
    main()
