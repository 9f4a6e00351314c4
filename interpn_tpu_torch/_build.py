"""Build-on-demand for the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` at first use into a shared
library with a plain C interface, named by a hash of its sources and flags,
in `_build/` beside this file (listed in .gitignore), and loaded with
ctypes. A second process finds the library already built. No PyTorch
headers are compiled, which keeps a build to seconds. A source with PARTS
is several units, each compiled by its own nvcc at once and linked into
the one library.

The flags target Hopper (`sm_90a`) and keep IEEE arithmetic: no fast math,
and `--fmad=false` so that no a*b+c is contracted into an FMA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# Sources built from more than one translation unit: `csrc/<name>.cu` and
# these beside it (the rectilinear stack kernel's linear and nearest
# instantiations; in one unit with the cubic ones its build took 199 s on the
# card's host).
PARTS = {"fused_rectilinear_stack": ("fused_rectilinear_stack_lerp",)}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's
    default install prefix."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the build of `csrc/<name>.cu` with the current sources and
    flags lives."""
    h = hashlib.sha256()
    for p in (*_units(CSRC / f"{name}.cu"), *sorted(CSRC.glob("*.cuh"))):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _units(src: Path) -> list[Path]:
    """The translation units of the source `src`: itself and its PARTS."""
    return [src, *(src.with_name(f"{part}.cu") for part in PARTS.get(src.stem, ()))]


def _run(cmd) -> str:
    """Run nvcc; its output (ptxas -v: registers, shared memory and spills of
    each kernel), or RuntimeError."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def _compile(src: Path, so: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    units = _units(src)
    objs = [tmp.with_name(f"{tmp.name}.{i}.o") for i in range(len(units))]
    try:
        if len(units) == 1:
            log = _run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)])
        else:  # each unit by its own nvcc, all at once, then one link
            flags = [f for f in NVCC_FLAGS if f != "-shared"]
            with ThreadPoolExecutor(max_workers=len(units)) as pool:
                logs = list(pool.map(
                    lambda u, o: _run([_nvcc(), *flags, "-c", "-o", str(o), str(u)]), units, objs))
            log = "".join(logs) + _run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)])
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed.
    Raises RuntimeError when nvcc is missing or fails."""
    lib = _libs.get(name)
    if lib is None:
        so = library_path(name)
        if not so.exists():
            _compile(CSRC / f"{name}.cu", so)
        lib = _libs[name] = ctypes.CDLL(str(so))
    return lib


def build_all(names) -> dict[str, float]:
    """Build every missing `csrc/<name>.cu` at once, one nvcc process per
    source, and return each build's wall seconds (0.0 where the library was
    already built). Raises RuntimeError if any build fails."""

    def build(name: str) -> float:
        so = library_path(name)
        if so.exists():
            return 0.0
        t0 = time.perf_counter()
        _compile(CSRC / f"{name}.cu", so)
        return time.perf_counter() - t0

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))
