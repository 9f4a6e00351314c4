"""Ahead-of-time serving artifacts.

Counterpart of `interpn_tpu/aot.py`: `torch.export` serializes a model's
device evaluation (`models/_device.py::DeviceCore`, the grid and table its
buffers) to bytes that a serving process loads and calls without the
pydantic model, the dispatch layer or any retracing.

* An artifact holds one exported program per batch-size bucket, each with
  static shapes; a serving batch is padded to the smallest bucket that fits
  by repeating its own first coordinate, so the pad adds no out-of-domain
  or non-finite work, and the pad is sliced off.
* The kernels are the custom ops of `ops/library.py`: each is one node of
  the program, which a loaded program calls through the op's registration
  (importing this module registers the ops). pchip has no kernel; its
  program is its torch gather tree.
* The engine is pinned at export: each kernel node carries the f64 engine
  INTERPN_TPU_F64 forced when the program was traced (`native` where it
  forced none), and serving never reads the environment.
* `device` takes the place of the JAX package's `platforms`. A JAX program
  is lowered for named platforms and placed on a device when called; a
  torch program holds its buffers on the device it was exported on, and
  its kernel nodes launch what the op launches on that device. So the
  artifact is served on the device it names (the card unless the exporter
  asks for the CPU, `config.default_device()`), and loading an artifact
  exported for CUDA without a CUDA device raises.
* `eval_torch` semantics, as the JAX package's `eval_jax`: invalid
  coordinates give NaN or extrapolate, nothing raises per point, and there
  is no host sync.

Wire format: `ITTAOT1\\n` magic, 8-byte big-endian JSON-header length, the
JSON header {class, ndims, dtype, batch_sizes, device, engine, torch}, then
each bucket's `torch.export.save` bytes, length-prefixed, in header order.
`engine` is the engine of the program's kernel node, null where it has
none (pchip).
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np
import torch

from . import config
from .ops import library

_MAGIC = b"ITTAOT1\n"
_JAX_MAGIC = b"ITAOT1\n"  # interpn_tpu/aot.py's artifacts
_ENGINE_OPS = tuple(library.overload(name) for name in ("regular", "rectilinear", "bspline"))


def _program_engines(program) -> set:
    """The engines of the program's kernel nodes (the op's last argument)."""
    return {node.args[-1] for node in program.graph.nodes if node.target in _ENGINE_OPS}


def export_eval(model, batch_sizes, *, device=None) -> bytes:
    """Serialize `model`'s device evaluation into a self-contained artifact.

    Args:
        model: any of the eight interpolator classes.
        batch_sizes: one int or a sequence of ints, the observation-count
            buckets to export; more buckets, less padding at serve time,
            one program each.
        device: where the program computes and is served, by default
            `config.default_device()` (the CUDA device unless the caller
            asks for the CPU).

    Returns:
        bytes; load with `aot.load`.
    """
    sizes = [int(batch_sizes)] if np.isscalar(batch_sizes) else sorted(
        {int(n) for n in batch_sizes})
    if not sizes or any(n < 1 for n in sizes):
        raise ValueError("batch_sizes must be positive")
    device = config.default_device() if device is None else torch.device(device)
    interp = model._device()
    interp._check_float()
    interp.check_grid_sizes()
    core = interp.core(device)
    dtype = interp.torch_dtype
    blobs, engines = [], set()
    for n in sizes:
        args = tuple(torch.zeros(n, dtype=dtype, device=device) for _ in range(interp.ndims()))
        program = torch.export.export(core, args)
        program.example_inputs = None  # zeros of the bucket's size: not worth saving
        engines |= _program_engines(program)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blobs.append(buf.getvalue())
    header = json.dumps({
        "class": type(model).__name__,
        "ndims": interp.ndims(),
        "dtype": "float64" if dtype == torch.float64 else "float32",
        "batch_sizes": sizes,
        "device": str(device),
        "engine": engines.pop() if engines else None,
        "torch": torch.__version__,
    }).encode()
    out = [_MAGIC, struct.pack(">Q", len(header)), header]
    for b in blobs:
        out += [struct.pack(">Q", len(b)), b]
    return b"".join(out)


class ServingModel:
    """A loaded artifact: evaluation without the model.

    `eval_torch(obs)` takes ndims numpy arrays or tensors of one length up
    to the largest bucket, pads them to the smallest bucket that fits,
    calls that bucket's program on the artifact's device and returns the
    flat result there, the pad sliced off.
    """

    def __init__(self, meta: dict, programs: list):
        self.meta = meta
        self.ndims = int(meta["ndims"])
        self.dtype = torch.float64 if meta["dtype"] == "float64" else torch.float32
        self.device = torch.device(meta["device"])
        self.batch_sizes = [int(n) for n in meta["batch_sizes"]]
        self._calls = {n: p.module() for n, p in zip(self.batch_sizes, programs, strict=True)}

    def __repr__(self):
        return (f"ServingModel({self.meta['class']}, ndims={self.ndims}, "
                f"dtype={self.meta['dtype']}, batch_sizes={self.batch_sizes}, "
                f"device={self.device})")

    def eval_torch(self, obs) -> torch.Tensor:
        if len(obs) != self.ndims:
            raise AssertionError("Dimension mismatch")
        xs = [torch.as_tensor(x, dtype=self.dtype, device=self.device).reshape(-1)
              for x in obs]
        n = int(xs[0].shape[0])
        if any(int(x.shape[0]) != n for x in xs[1:]):
            raise AssertionError("Dimension mismatch")
        if n == 0:
            return torch.zeros(0, dtype=self.dtype, device=self.device)
        bucket = next((b for b in self.batch_sizes if b >= n), None)
        if bucket is None:
            raise ValueError(
                f"batch of {n} exceeds the largest compiled bucket "
                f"{self.batch_sizes[-1]}; re-export with a larger bucket"
            )
        if bucket != n:
            xs = [torch.cat([x, x[:1].expand(bucket - n)]) for x in xs]
        res = self._calls[bucket](*(x.contiguous() for x in xs))
        return res[:n] if bucket != n else res

    __call__ = eval_torch


def _read(blob: bytes, off: int) -> tuple[bytes, int]:
    """The length-prefixed field at `off` and the offset after it."""
    if off + 8 > len(blob):
        raise ValueError("truncated interpn_tpu_torch AOT artifact")
    (size,) = struct.unpack(">Q", blob[off:off + 8])
    off += 8
    if off + size > len(blob):
        raise ValueError("truncated interpn_tpu_torch AOT artifact")
    return blob[off:off + size], off + size


def load(blob: bytes) -> ServingModel:
    """Deserialize an `export_eval` artifact onto the device it names.
    ValueError for bytes that are not one (a JAX package artifact
    included); RuntimeError for a CUDA artifact where there is no such
    CUDA device."""
    blob = bytes(blob)
    if blob.startswith(_JAX_MAGIC):
        raise ValueError("an interpn_tpu (JAX) AOT artifact, not an interpn_tpu_torch one; "
                         "export the model with interpn_tpu_torch.aot.export_eval")
    if not blob.startswith(_MAGIC):
        raise ValueError("not an interpn_tpu_torch AOT artifact")
    raw_header, off = _read(blob, len(_MAGIC))
    try:
        meta = json.loads(raw_header.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError("corrupt interpn_tpu_torch AOT artifact header") from exc
    device = torch.device(meta["device"])
    if device.type == "cuda" and not (
            torch.cuda.is_available() and (device.index or 0) < torch.cuda.device_count()):
        raise RuntimeError(f"the artifact was exported for {device}, and this process has "
                           "no such CUDA device; export it again for the device to serve on")
    programs = []
    for _ in meta["batch_sizes"]:
        part, off = _read(blob, off)
        programs.append(torch.export.load(io.BytesIO(part)))
    return ServingModel(meta, programs)
