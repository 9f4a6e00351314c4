"""wrappers.route_ms: the host time a step of the port's `route` spans
(the kernel wrappers' route choice with the free-bytes query that a stack
takes, `torch.cuda.mem_get_info`) over the traced window, in ms
(`spans.py`); 0 where the window dispatched but chose no route (CPU
tensors take the gather tree)."""

from portbench import spans


def read(run):
    s = spans.window(run)
    if s is None or not len(s.of("dispatch")):
        return None
    return spans.seconds(s.of("route")) / s.steps * 1e3
