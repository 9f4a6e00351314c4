"""k5_roofline: as k1_roofline, where the window launched K5 (the regular
stack kernel, `csrc/fused_regular_stack.cu`)."""

from portbench import roofline

KERNELS = ("regular_linear_stack", "regular_cubic_stack", "regular_nearest_stack")


def read(run):
    if run.device_step is None or not any(run.launches.get(k) for k in KERNELS):
        return None
    p = run.problem
    least, _ = roofline.least(p.dims, p.method, p.dtype, p.ntables, p.queries)
    return 100.0 * least / run.device_step.seconds
