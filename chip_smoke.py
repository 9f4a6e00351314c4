#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (interpn_tpu_torch) on one GPU.

Builds the port's kernel from `interpn_tpu_torch/csrc/`, holds it against its
plain PyTorch version on the card, then drives the port's main path, a 3D
20^3 regular grid evaluated multilinearly in f32 at 1e6 queries, through the
entry points a user calls, and times the kernel beside the plain version.

    python3 chip_smoke.py

Phases, one line each: 1 build, 2 kernel vs plain (f32/f64, 1-8D),
3 node exactness, 4 main path (launch counts and checks), 5 timing. A failed
phase raises and the script exits non-zero. The last two lines are the
kernels' JSON record and {"ok": true, "device": {...}}. Without a CUDA device
it exits non-zero before any result.
"""

from __future__ import annotations

import itertools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN = 1_000_000  # queries on the main path
N_CHECK = 100_000  # queries per kernel-vs-plain case
N_BATCHES = 20  # distinct batches per timing
LO, HI = -0.5, 10.5  # query range: the [0, 10] grid plus extrapolation
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}  # rtol = atol, kernel vs plain
CHECK_DIMS = [(50,), (20,) * 2, (20,) * 3, (12,) * 4, (8,) * 5, (6,) * 6, (5,) * 7, (4,) * 8]


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_grid(n: int, ndims: int = 3):
    """The JAX package's benchmark grid: n points on [0, 10] per axis,
    vals = sin(x0) + 0.37 * (x1 + ... ), as float64 numpy."""
    x = np.linspace(0.0, 10.0, n)
    mesh = np.meshgrid(*([x] * ndims), indexing="ij")
    vals = np.sin(mesh[0])
    for m in mesh[1:]:
        vals = vals + m * 0.37
    return x, vals


def numpy_reference(dims, starts, steps, vals, obs):
    """Independent float64 multilinear evaluation: the sum over the 2^N
    corners of the product of per-axis weights times the corner value."""
    grid = np.asarray(vals, np.float64).reshape(dims)
    locs, ts = [], []
    for k, x in enumerate(obs):
        x = np.asarray(x, np.float64)
        floc = np.floor((x - starts[k]) / steps[k])
        loc = np.clip(floc, 0, dims[k] - 2).astype(np.int64)
        locs.append(loc)
        ts.append((x - (starts[k] + steps[k] * loc)) / steps[k])
    out = np.zeros(len(obs[0]))
    for corner in itertools.product((0, 1), repeat=len(dims)):
        w = np.ones(len(obs[0]))
        for k, c in enumerate(corner):
            w = w * (ts[k] if c else 1.0 - ts[k])
        out += w * grid[tuple(loc + c for loc, c in zip(locs, corner))]
    return out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin].double() - b[fin].double()).abs().max()) if fin.any() else 0.0


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    from interpn_tpu_torch import _build, config, convert, interpn, raw
    from interpn_tpu_torch.ops import fused, linear
    from interpn_tpu_torch.utils.profiling import cuda_time

    config.require_ieee_fp32()
    cuda = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    # 1. build -----------------------------------------------------------
    cached = _build.library_path("fused_regular").exists()
    t0 = time.perf_counter()
    fused._lib()
    build_s = time.perf_counter() - t0
    ptxas = _build.library_path("fused_regular").with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", ptxas))
    log(f"phase 1 build: fused_regular.cu in {build_s:.3f} s"
        f"{' (already built)' if cached else ''}; {len(regs)} kernels, "
        f"registers {min(regs)}..{max(regs)}, spill stores {spills} bytes")

    # 2. kernel vs plain on the card, f32/f64, 1-8D ---------------------------
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.float64):
        worst, mismatched = 0.0, 0
        for dims in CHECK_DIMS:
            nd = len(dims)
            starts = rng.uniform(-1, 1, nd)
            steps = rng.uniform(0.3, 1.0, nd)
            vals = rng.standard_normal(math.prod(dims))
            obs = []
            for k in range(nd):
                span = steps[k] * (dims[k] - 1)
                o = rng.uniform(starts[k] - 0.5 * span, starts[k] + 1.5 * span, N_CHECK)
                o[rng.integers(0, N_CHECK, 30)] = rng.choice([np.nan, np.inf, -np.inf], 30)
                obs.append(o)
            grid = convert.regular_grid_from_numpy(
                dims, starts, steps, vals, device=cuda, dtype=dtype
            )
            ob = convert.obs_from_numpy(obs, device=cuda, dtype=dtype)
            got = fused.eval_regular(*grid, ob)
            want = linear.linear_regular(*grid, ob)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got, want, rtol=TOL[dtype], atol=TOL[dtype], equal_nan=True,
                msg=lambda m, d=dims: f"{d} {dtype}: {m}",
            )
            worst = max(worst, max_abs_err(got, want))
            same = (got == want) | (torch.isnan(got) & torch.isnan(want))
            mismatched += int((~same).sum())
        log(f"phase 2 kernel vs plain {str(dtype)[6:]}: 1-8D x {N_CHECK} queries "
            f"(extrapolation, NaN, +-inf) within rtol=atol={TOL[dtype]:g}; "
            f"max_abs_err {worst:.3e}, {mismatched} results not bitwise equal")

    # 3. node exactness ---------------------------------------------------------
    vals = rng.standard_normal(8000)
    idx = np.stack(np.meshgrid(*[np.arange(20)] * 3, indexing="ij")).reshape(3, -1)
    interior = torch.from_numpy(np.all(idx <= 18, axis=0)).to(cuda)
    for dtype in (torch.float32, torch.float64):
        grid = convert.regular_grid_from_numpy(
            (20, 20, 20), np.zeros(3), np.full(3, 0.5), vals, device=cuda, dtype=dtype
        )
        got = fused.eval_regular(*grid, convert.obs_from_numpy(
            [i * 0.5 for i in idx], device=cuda, dtype=dtype))
        if not torch.equal(got[interior], grid[3][interior]):
            raise AssertionError(f"{dtype}: interior grid nodes not reproduced exactly")
    log(f"phase 3 nodes: all {int(interior.sum())} interior nodes of a 20^3 "
        "step-0.5 grid reproduce vals exactly (f32, f64)")

    # 4. the main path ------------------------------------------------------------
    x, vals64 = bench_grid(20)
    dims = np.array([20, 20, 20])
    vals32 = vals64.ravel().astype(np.float32)
    starts = np.zeros(3, np.float32)
    steps = np.full(3, x[1] - x[0], np.float32)
    obs_np = [rng.uniform(LO, HI, N_MAIN).astype(np.float32) for _ in range(3)]
    obs_t = [torch.from_numpy(o).to(cuda) for o in obs_np]
    grid_t = [torch.from_numpy(a).to(cuda) for a in (starts, steps, vals32)]
    out_np = np.zeros(N_MAIN, np.float32)
    out_t = torch.zeros(N_MAIN, device=cuda)
    torch.cuda.synchronize()

    fused.launches = 0
    counts = []
    with torch.device(cuda):
        raw.interpn_linear_regular_f32(dims, starts, steps, vals32, obs_np, out_np)
        counts.append(fused.launches)
        raw.interpn_linear_regular_f32(dims, *grid_t, obs_t, out_t)
        counts.append(fused.launches)
        via_interpn = interpn(
            obs_np, [x.astype(np.float32)] * 3, vals32.reshape(20, 20, 20),
            method="linear", assume_regular=True,
        )
        counts.append(fused.launches)
    torch.cuda.synchronize()
    main_launches = fused.launches
    if counts != [1, 2, 3]:
        raise AssertionError(f"kernel launch counts after each call: {counts}")

    results = {"raw(numpy)": out_np, "raw(cuda)": out_t.cpu().numpy(), "interpn": via_interpn}
    for name, r in results.items():
        if r.shape != (N_MAIN,) or r.dtype != np.float32 or not np.isfinite(r).all():
            raise AssertionError(f"{name}: {r.shape} {r.dtype}, finite={np.isfinite(r).all()}")
        np.testing.assert_array_equal(r, out_np, err_msg=name)
    cpu_args = convert.regular_grid_from_numpy(
        dims, starts, steps, vals32, device="cpu", dtype=torch.float32)
    cpu = linear.linear_regular(*cpu_args, tuple(torch.from_numpy(o) for o in obs_np))
    np.testing.assert_allclose(out_np, cpu.numpy(), rtol=1e-6, atol=1e-6)
    sub = slice(0, 2000)
    ref = numpy_reference((20, 20, 20), starts.astype(np.float64), steps.astype(np.float64),
                          vals32, [o[sub] for o in obs_np])
    np.testing.assert_allclose(out_np[sub], ref, rtol=1e-5, atol=1e-5)
    # the kernel against its plain version at the main path's shape
    k_out = fused.eval_regular((20, 20, 20), *grid_t, tuple(obs_t))
    p_out = linear.linear_regular((20, 20, 20), *grid_t, tuple(obs_t))
    torch.testing.assert_close(k_out, p_out, rtol=TOL[torch.float32], atol=TOL[torch.float32])
    main_err = max_abs_err(k_out, p_out)
    log(f"phase 4 main path: raw from numpy (default device cuda), raw from CUDA "
        f"tensors, interpn(); kernel launches {counts}; 20^3 f32 x {N_MAIN} queries "
        f"finite, equal across entry points, within 1e-6 of the CPU gather tree and "
        f"1e-5 of a float64 numpy reference; kernel vs plain max_abs_err {main_err:.3e}")

    # 5. timing ---------------------------------------------------------------------
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1234)
    timings = {}
    for label, n, dtype in (("20^3 f32", 20, torch.float32), ("20^3 f64", 20, torch.float64),
                            ("100^3 f32", 100, torch.float32)):
        xg, vg = bench_grid(n)
        g = convert.regular_grid_from_numpy(
            (n,) * 3, np.zeros(3), np.full(3, xg[1] - xg[0]), vg, device=cuda, dtype=dtype)[1:]
        batches = [
            tuple(torch.rand(N_MAIN, generator=gen, device=cuda, dtype=dtype) * (HI - LO) + LO
                  for _ in range(3))
            for _ in range(N_BATCHES)
        ]
        kern = lambda ob, g=g, n=n: fused.eval_regular((n,) * 3, *g, ob)  # noqa: E731
        plain = lambda ob, g=g, n=n: linear.linear_regular((n,) * 3, *g, ob)  # noqa: E731
        runs = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            runs[name].append(cuda_time(kern if name == "kernel" else plain, batches))
        k_dev, p_dev = (min(t.device_ms for t in runs[k]) for k in ("kernel", "plain"))
        k_loop, p_loop = (min(t.loop_ms for t in runs[k]) for k in ("kernel", "plain"))
        timings[label] = (k_dev, p_dev)
        log(f"phase 5 timing {label}, {N_BATCHES} distinct batches of {N_MAIN} queries "
            f"[{smi}]: kernel {k_dev:.4f} ms/call device time = {N_MAIN / k_dev * 1e3:,.0f} "
            f"q/s, {k_loop:.4f} ms/call back to back = {N_MAIN / k_loop * 1e3:,.0f} q/s; "
            f"plain gather tree {p_dev:.4f} ms/call device time = "
            f"{N_MAIN / p_dev * 1e3:,.0f} q/s, {p_loop:.4f} ms/call back to back = "
            f"{N_MAIN / p_loop * 1e3:,.0f} q/s; device-time speedup {p_dev / k_dev:.1f}x")
        if label == "20^3 f32":
            out = torch.empty(N_MAIN, device=cuda)
            for b in batches[:2]:
                raw.interpn_linear_regular_f32(dims, *g, list(b), out)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                raw.interpn_linear_regular_f32(dims, *g, list(b), out)
            torch.cuda.synchronize()
            raw_ms = (time.perf_counter() - t0) * 1e3 / N_BATCHES
            log(f"phase 5 timing {label} through raw.interpn_linear_regular_f32 from CUDA "
                f"tensors (validation, unrepresentable-value check, copy into out) [{smi}]: "
                f"{raw_ms:.4f} ms/call host clock = {N_MAIN / raw_ms * 1e3:,.0f} q/s")
        del batches

    log(smi)
    k_ms, p_ms = timings["20^3 f32"]
    log(json.dumps({"kernels": [{
        "name": "fused_regular_linear",
        "route": "cuda",
        "source": "interpn_tpu_torch/csrc/fused_regular.cu",
        "replaces": "interpn_tpu/ops/pallas_v3.py:586",
        "launches": main_launches,
        "max_abs_err": main_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
