"""The class's `eval(obs, out=out)` into a preallocated device `out`:
upstream's benchmarked "prealloc" path. On a regular grid it raises the
reference's "Unrepresentable coordinate value", so the entry reads a flag
back to the host each call (`raw._unrep_flag`, `raw._raise_unrep`) and then
writes `out` (`raw._finish`)."""

from __future__ import annotations

from portbench.entries._classes import model as make_model

OUT = True


def build(problem):
    model = make_model(problem)
    return lambda obs, out: model.eval(obs, out=out)
