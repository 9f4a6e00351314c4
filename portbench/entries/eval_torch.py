"""The class's `eval_torch`: device-resident queries in, a new tensor on
their device out, no host sync (`models/_device.py::eval_torch`)."""

from __future__ import annotations

from portbench.entries._classes import model as make_model

OUT = False


def build(problem):
    model = make_model(problem)
    return lambda obs, out: model.eval_torch(obs)
