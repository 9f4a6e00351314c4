"""k2_roofline: as k1_roofline, where the window launched K2 (the
rectilinear single-table kernel, `csrc/fused_rectilinear.cu`).

`roofline.py` counts a regular grid's least work, and a rectilinear step's
is taken as the same. Both departures only lower the least time, so the
share never overstates: the grid's bytes are counted as a start and a step
an axis where the kernel reads the axes' nodes (at 20^4 f64, 64 B against
640 B of a 401 MB step), and the locate's comparisons (a bisection of each
axis's nodes) are left out of the operations."""

from portbench import roofline

KERNELS = ("rectilinear_linear", "rectilinear_cubic")


def read(run):
    if run.device_step is None or not any(run.launches.get(k) for k in KERNELS):
        return None
    p = run.problem
    least, _ = roofline.least(p.dims, p.method, p.dtype, p.ntables, p.queries)
    return 100.0 * least / run.device_step.seconds
