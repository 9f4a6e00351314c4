"""wrappers.launches_per_step: the port's launch counters
(`interpn_tpu_torch.ops.fused.launches`, one count a wrapper launch,
layout launches included) summed over the window, per step."""


def read(run):
    return sum(run.launches.values()) / run.window.steps
