"""Query-axis chunking for evaluation paths with wide per-query temporaries.

Counterpart of `interpn_tpu/ops/_chunk.py`. The cubic gather tree fetches a
(4^N, n) corner matrix; at 12^5 f64 and 1e6 queries that is 8 GB. Chunks run
one after another, so the peak is one chunk's temporaries.
"""

from __future__ import annotations

import torch

# Bound each chunk's corner matrix to about this many bytes.
DEFAULT_CHUNK_BYTES = 2 * 1024 * 1024 * 1024


def chunk_queries(f, obs, row_elems: int, itemsize: int, chunk_bytes=None):
    """Evaluate ``f(obs_tuple)`` over query chunks sized so that a temporary
    of ``row_elems`` elements per query stays under ``chunk_bytes`` (default
    DEFAULT_CHUNK_BYTES, read at call time). `f` maps flat (m,) queries to
    an (m,) result; the result has obs[0]'s shape."""
    if chunk_bytes is None:
        chunk_bytes = DEFAULT_CHUNK_BYTES
    shape = obs[0].shape
    n = obs[0].numel()
    chunk = max(8192, chunk_bytes // max(row_elems * itemsize, 1))
    chunk = 1 << (chunk.bit_length() - 1)  # round down to a power of two
    flat = [o.reshape(-1) for o in obs]
    if n <= chunk:
        return f(tuple(flat)).reshape(shape)
    parts = [f(tuple(o[i : i + chunk] for o in flat)) for i in range(0, n, chunk)]
    return torch.cat(parts).reshape(shape)
