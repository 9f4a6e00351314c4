"""k1_roofline: the least time of one step's work (`roofline.py`) over the
device time of one step, in percent, where the window launched K1 (the
regular single-table kernel, `csrc/fused_regular.cu`). The device time is
the step's whole device time (K1 and the layout launch its entry makes),
from head-start passes of the cell's call after the window (`timing.py`);
a call whose pass never got ahead (one that synchronises) gives nothing."""

from portbench import roofline

KERNELS = ("regular_linear", "regular_cubic", "regular_nearest")


def read(run):
    if run.device_step is None or not any(run.launches.get(k) for k in KERNELS):
        return None
    p = run.problem
    least, _ = roofline.least(p.dims, p.method, p.dtype, p.ntables, p.queries)
    return 100.0 * least / run.device_step.seconds
