"""dispatch.host_ms: the host time a step of the port's `dispatch` spans
(`ops/dispatch.py::_route`: `KernelRoute.apply` and the custom op's
dispatcher) less the `wrapper` spans inside them, the kernel wrappers' own
time, over the traced window, in ms (`spans.py`). On CPU tensors dispatch
runs the gather tree, so there it reads the gather tree's time."""

from portbench import spans


def read(run):
    s = spans.window(run)
    if s is None:
        return None
    dispatch = s.of("dispatch")
    if not len(dispatch):
        return None
    wrappers = s.of("wrapper")
    own = spans.seconds(dispatch) - spans.seconds(wrappers[spans.inside(wrappers, dispatch)])
    return own / s.steps * 1e3
