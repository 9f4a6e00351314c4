"""The native CPU engine: ctypes bindings and the build of its library.

Counterpart of `interpn_tpu/native/__init__.py`, over the port's own copies
of its sources (`interpn_native.cpp`, `fastcall.c`, byte for byte the JAX
package's, which a test checks). The library is built on first use with
the JAX loader's g++ command, so that both engines give the same bits on
one host, into the port's `_build/` directory (listed in .gitignore), named
by a hash of the source, the flags and the host's CPU features: the build
uses `-march=native`, so a `_build/` copied to another machine never loads
a library made for another CPU.

The engine takes numpy buffers only, never a tensor. Where it serves
(`use_native`): numpy inputs with a numpy `out` take it when the CPU is the
device in force (`config.set_device("cpu")` or `with config.device("cpu"):`);
INTERPN_TPU_NATIVE_THRESHOLD=<n> asks for it on batches below n whatever
the device (batches of n or more go to the device in force, the card by
default); INTERPN_TPU_NATIVE=0 turns it off and =always on for every numpy
batch; INTERPN_TPU_NATIVE_THREADS sets its threads, as in the JAX package.
Unset, no numpy batch leaves the card's route. Every variable is read at
each call.

Call overhead: pointer arguments are passed as raw integers
(`ndarray.ctypes.data`) into `c_void_p` slots, and the model classes cache
a `prepare_*` closure that freezes the grid's arguments once. The optional
`fastcall.c` extension (CPython C API) takes the place of ctypes on a
prepared call where it builds (it needs `Python.h`); `fastcall_available()`
says whether it did.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import time
from pathlib import Path

import numpy as np

from .. import config

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "interpn_native.cpp"
_FASTCALL_SRC = _DIR / "fastcall.c"
BUILD_DIR = _DIR.parent / "_build"

# The JAX loader's command (`interpn_tpu/native/__init__.py::_build`).
# -ffp-contract=fast allows FMA contraction, as the reference's shipped
# wheels do; it is what makes the reference's own bitwise cubic node tests
# pass against this engine.
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-ffp-contract=fast",
             "-std=c++17", "-shared", "-fPIC", "-pthread")
FASTCALL_FLAGS = ("-O2", "-shared", "-fPIC")

# Seconds of this process's builds, by library ("engine", "fastcall"); a
# library found built is not in it.
build_seconds: dict[str, float] = {}

_lib = None
_tried = False

_VOIDP = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_DBL = ctypes.c_double


def host_tag() -> str:
    """A short fingerprint of this host's CPU (its machine type and feature
    flags), as `interpn_tpu/config.py::host_feature_tag` takes it."""
    feats = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                # x86 names them "flags", arm64 "Features"
                if line.startswith(("flags", "Features")):
                    feats.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
    except OSError:  # pragma: no cover - no procfs
        pass
    return "|".join(feats)


def _path(stem: str, src: Path, flags) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(host_tag().encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the engine's build for this source, these flags and this host
    lives."""
    return _path("libinterpn_native", _SRC, CXX_FLAGS)


def _fastcall_path() -> Path:
    return _path("_interpn_fastcall", _FASTCALL_SRC, FASTCALL_FLAGS)


def _compile(cmd_head, src: Path, out: Path, what: str) -> bool:
    """Run g++ into a file of this process and move it into place, so that
    processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run([*cmd_head, str(src), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
    except Exception:
        tmp.unlink(missing_ok=True)
        return False
    build_seconds[what] = time.perf_counter() - t0
    return True


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    # With the engine off and no build on disk, skip the build without
    # remembering it, so that turning INTERPN_TPU_NATIVE on again builds.
    path = library_path()
    if _native_mode() == "0" and not path.exists():
        return None
    _tried = True
    if not path.exists() and not _compile(["g++", *CXX_FLAGS], _SRC, path, "engine"):
        return None
    try:
        _lib = ctypes.CDLL(str(path))
    except OSError:
        _lib = None
    return _lib


_fastcall = None
_fastcall_tried = False


def _load_fastcall():
    """Build and import the `_interpn_fastcall` C extension (fastcall.c).
    Optional: without it the ctypes path serves, about 10 us slower a call."""
    global _fastcall, _fastcall_tried
    if _fastcall_tried:
        return _fastcall
    import importlib.machinery
    import importlib.util
    import sysconfig

    so = _fastcall_path()
    if _native_mode() == "0" and not so.exists():
        return None  # off and unbuilt: skip the build, remember nothing
    _fastcall_tried = True
    inc = sysconfig.get_paths()["include"]
    if not so.exists() and not _compile(["g++", *FASTCALL_FLAGS, f"-I{inc}", "-x", "c"],
                                        _FASTCALL_SRC, so, "fastcall"):
        return None
    try:
        loader = importlib.machinery.ExtensionFileLoader("_interpn_fastcall", str(so))
        spec = importlib.util.spec_from_loader("_interpn_fastcall", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _fastcall = mod
    except Exception:
        _fastcall = None
    return _fastcall


def available() -> bool:
    """Whether the engine's library is built and loaded (building it now
    if need be)."""
    return _load() is not None


def fastcall_available() -> bool:
    """Whether the fastcall extension built and loaded; without it the
    prepared calls go through ctypes."""
    return available() and _load_fastcall() is not None


def load_deferred() -> bool:
    """True while `_load` has skipped the build (INTERPN_TPU_NATIVE=0 with
    no library on disk) without remembering it: callers should not
    remember an unavailable engine yet."""
    return not _tried


def set_threads(n: int | None) -> bool:
    """Set the evaluation thread count (None or <= 0 restores auto: the
    INTERPN_TPU_NATIVE_THREADS variable, else hardware_concurrency capped at
    16). Threads take contiguous ranges of the queries; results are bitwise
    those of one thread."""
    lib = _load()
    if lib is None:
        return False
    lib.itn_set_threads(_INT(-1 if n is None or n <= 0 else int(n)))
    return True


# use_native is on the hot path of a one-query call; os.environ.get costs
# about 1.7 us a read, the raw environment dict about 50 ns.
try:
    _ENVDATA = os.environ._data  # posix: {bytes: bytes}
    _NATIVE_KEY = os.fsencode("INTERPN_TPU_NATIVE")
    _THRESHOLD_KEY = os.fsencode("INTERPN_TPU_NATIVE_THRESHOLD")

    def _native_mode() -> str:
        v = _ENVDATA.get(_NATIVE_KEY)
        return "1" if v is None else os.fsdecode(v)

    def _threshold() -> int | None:
        v = _ENVDATA.get(_THRESHOLD_KEY)
        return int(v) if v else None
except AttributeError:  # pragma: no cover - non-posix environ layout

    def _native_mode() -> str:
        return os.environ.get("INTERPN_TPU_NATIVE", "1")

    def _threshold() -> int | None:
        v = os.environ.get("INTERPN_TPU_NATIVE_THRESHOLD")
        return int(v) if v else None


def use_native(n: int) -> bool:
    """Whether a numpy batch of n queries with a numpy `out` takes the
    engine: off under INTERPN_TPU_NATIVE=0; on under =always; else on
    where the CPU is the device in force or n is below
    INTERPN_TPU_NATIVE_THRESHOLD; and only where the engine built."""
    mode = _native_mode()
    if mode == "0":
        return False
    if mode != "always" and not config.cpu_requested():
        threshold = _threshold()
        if threshold is None or n >= threshold:
            return False
    return available()


def _c(a, dtype):
    return np.ascontiguousarray(np.asarray(a).ravel(), dtype=dtype)


def _obs_ptrs(obs, dtype):
    """(kept-alive converted arrays, c_void_p[] of their data pointers)."""
    arrs = [_c(o, dtype) for o in obs]
    ptrs = (_VOIDP * len(arrs))(*(a.ctypes.data for a in arrs))
    return arrs, ptrs


def _obs_dtype_mismatch(obs, dtype) -> bool:
    """True when an observation input is an array of another dtype: the
    prepared calls then decline, so that the class's general path raises
    the reference's TypeError instead of `_c` casting quietly. Lists and
    scalars keep converting."""
    for o in obs:
        dt = getattr(o, "dtype", None)
        if dt is not None and dt != dtype:
            return True
    return False


def _fn_addr(fn) -> int:
    return ctypes.cast(fn, _VOIDP).value


def _compose(fast, slow):
    """The fastcall extension's call, with ctypes where it declines (it
    takes exact-dtype contiguous buffers only)."""
    if fast is None:
        return slow

    def call(obs, out) -> bool:
        if fast(obs, out):
            return True
        return slow(obs, out)

    return call


def _rc_result(rc: int) -> bool:
    """Map the engine's return code: 0 done, 2 raises the reference's
    unrepresentable-coordinate error (regular grids only), else False (the
    caller's plain path serves)."""
    if rc == 2:
        raise AssertionError("Unrepresentable coordinate value")
    return rc == 0


def _prepared(fn, head, keep, ndims, dtype, fast_args):
    """The prepared call of `fn(*head, obs_ptrs, out, n)`: `keep` holds the
    frozen buffers alive; `fast_args` are the fastcall extension's
    `prepare` arguments after the function address."""

    def call(obs, out) -> bool:
        if out.dtype != dtype:
            return False  # a raw pointer write would reinterpret `out`'s bits
        if _obs_dtype_mismatch(obs, dtype):
            return False  # the general path raises the reference's TypeError
        arrs, ptrs = _obs_ptrs(obs, dtype)
        # the kernel reads out.size queries from every obs pointer:
        # mismatched lengths would read out of bounds (the caller raises the
        # reference's "Dimension mismatch")
        if len(arrs) != ndims or any(a.size != out.size for a in arrs):
            return False
        rc = fn(*head, ptrs, _VOIDP(out.ctypes.data), _I64(out.size))
        del arrs  # alive through the C call; `keep` lives in the closure
        assert keep is not None
        return _rc_result(rc)

    fc = _load_fastcall()
    fast = None if fc is None else fc.prepare(_fn_addr(fn), *fast_args, keep)
    return _compose(fast, call)


def _width(dtype) -> int:
    return 8 if dtype == np.float64 else 4


# ---------------------------------------------------------------------------
# prepared (grid-frozen) callables: the model classes
# ---------------------------------------------------------------------------


def _prepare_regular(name, kind, max_dims, dims, starts, steps, vals, dtype, extra=()):
    lib = _load()
    ndims = len(dims)
    if lib is None or ndims > max_dims:
        return None
    fn = getattr(lib, f"{name}_{'f64' if dtype == np.float64 else 'f32'}")
    d64 = np.asarray(dims, dtype=np.int64)
    st, sp, v = _c(starts, dtype), _c(steps, dtype), _c(vals, dtype)
    head = (_VOIDP(d64.ctypes.data), _INT(ndims), _VOIDP(st.ctypes.data),
            _VOIDP(sp.ctypes.data), _VOIDP(v.ctypes.data), *extra)
    lin = int(extra[0].value) if extra else 0
    fast_args = (kind, ndims, lin, _width(dtype), tuple(int(x) for x in d64),
                 st.ctypes.data, sp.ctypes.data, None, v.ctypes.data)
    return _prepared(fn, head, (d64, st, sp, v), ndims, dtype, fast_args)


def prepare_linear_regular(dims, starts, steps, vals, dtype):
    return _prepare_regular("itn_linear_regular", 0, 8, dims, starts, steps, vals, dtype)


def prepare_nearest_regular(dims, starts, steps, vals, dtype):
    return _prepare_regular("itn_nearest_regular", 0, 6, dims, starts, steps, vals, dtype)


def prepare_cubic_regular(dims, starts, steps, vals, linearize, dtype):
    return _prepare_regular("itn_cubic_regular", 1, 8, dims, starts, steps, vals, dtype,
                            extra=(_INT(1 if linearize else 0),))


def _prepare_rect(name, max_dims, grids, vals, dtype, extra=()):
    lib = _load()
    ndims = len(grids)
    if lib is None or ndims > max_dims:
        return None
    fn = getattr(lib, f"{name}_{'f64' if dtype == np.float64 else 'f32'}")
    gs = [_c(g, dtype) for g in grids]
    gptrs = (_VOIDP * ndims)(*(g.ctypes.data for g in gs))
    d64 = np.asarray([g.size for g in gs], dtype=np.int64)
    v = _c(vals, dtype)
    head = (gptrs, _VOIDP(d64.ctypes.data), _INT(ndims), _VOIDP(v.ctypes.data), *extra)
    lin = int(extra[0].value) if extra else 0
    fast_args = (3 if extra else 2, ndims, lin, _width(dtype), tuple(int(x) for x in d64),
                 0, 0, tuple(g.ctypes.data for g in gs), v.ctypes.data)
    return _prepared(fn, head, (gs, gptrs, d64, v), ndims, dtype, fast_args)


def prepare_linear_rectilinear(grids, vals, dtype):
    return _prepare_rect("itn_linear_rectilinear", 8, grids, vals, dtype)


def prepare_nearest_rectilinear(grids, vals, dtype):
    return _prepare_rect("itn_nearest_rectilinear", 6, grids, vals, dtype)


def prepare_cubic_rectilinear(grids, vals, linearize, dtype):
    return _prepare_rect("itn_cubic_rectilinear", 8, grids, vals, dtype,
                         extra=(_INT(1 if linearize else 0),))


# ---------------------------------------------------------------------------
# one-shot calls: the flat raw API
# ---------------------------------------------------------------------------


def _dtype_of(out):
    return out.dtype.type


def linear_regular(dims, starts, steps, vals, obs, out) -> bool:
    call = prepare_linear_regular(dims, starts, steps, vals, _dtype_of(out))
    return call is not None and call(obs, out)


def nearest_regular(dims, starts, steps, vals, obs, out) -> bool:
    call = prepare_nearest_regular(dims, starts, steps, vals, _dtype_of(out))
    return call is not None and call(obs, out)


def cubic_regular(dims, starts, steps, vals, linearize, obs, out) -> bool:
    call = prepare_cubic_regular(dims, starts, steps, vals, linearize, _dtype_of(out))
    return call is not None and call(obs, out)


def linear_rectilinear(grids, vals, obs, out) -> bool:
    call = prepare_linear_rectilinear(grids, vals, _dtype_of(out))
    return call is not None and call(obs, out)


def nearest_rectilinear(grids, vals, obs, out) -> bool:
    call = prepare_nearest_rectilinear(grids, vals, _dtype_of(out))
    return call is not None and call(obs, out)


def cubic_rectilinear(grids, vals, linearize, obs, out) -> bool:
    call = prepare_cubic_rectilinear(grids, vals, linearize, _dtype_of(out))
    return call is not None and call(obs, out)


def _bounds(fn, head, obs, atol, out, ndims, dtype) -> bool:
    """Run a bounds check `fn(*head, obs_ptrs, atol, n, flags)` and copy its
    flags into `out`; False where it cannot serve (ragged obs: the
    reference scans each axis over its own length, the engine takes one
    n)."""
    arrs, ptrs = _obs_ptrs(obs, dtype)
    n = arrs[0].size
    if any(a.size != n for a in arrs):
        return False
    flags = np.zeros(ndims, dtype=np.uint8)
    rc = fn(*head, ptrs, _DBL(float(atol)), _I64(n), _VOIDP(flags.ctypes.data))
    if rc != 0:
        return False
    np.copyto(out, flags.astype(out.dtype))
    return True


def check_bounds_regular(dims, starts, steps, obs, atol, out, dtype) -> bool:
    """Per-dimension bounds flags on the host into `out` (bool or uint8).
    `dtype` is the entry point's (f32 or f64), not the inputs': the
    reference compares in the bound function's dtype."""
    lib = _load()
    ndims = len(dims)
    if lib is None or ndims == 0:
        return False
    fn = getattr(lib, f"itn_check_bounds_regular_{'f64' if dtype == np.float64 else 'f32'}")
    d64 = np.asarray(dims, dtype=np.int64)
    st, sp = _c(starts, dtype), _c(steps, dtype)
    head = (_VOIDP(d64.ctypes.data), _INT(ndims), _VOIDP(st.ctypes.data),
            _VOIDP(sp.ctypes.data))
    return _bounds(fn, head, obs, atol, out, ndims, dtype)


def check_bounds_rectilinear(grids, obs, atol, out, dtype) -> bool:
    """See `check_bounds_regular`."""
    lib = _load()
    ndims = len(grids)
    if lib is None or ndims == 0:
        return False
    fn = getattr(lib, f"itn_check_bounds_rectilinear_{'f64' if dtype == np.float64 else 'f32'}")
    gs = [_c(g, dtype) for g in grids]
    gptrs = (_VOIDP * ndims)(*(g.ctypes.data for g in gs))
    d64 = np.asarray([g.size for g in gs], dtype=np.int64)
    head = (gptrs, _VOIDP(d64.ctypes.data), _INT(ndims))
    return _bounds(fn, head, obs, atol, out, ndims, dtype)
