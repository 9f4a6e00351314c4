"""entry.flag_device_ms: the device time a step of the entry's
unrepresentable-value flag (`raw._unrep_flag`: on CUDA tensors the flag's
zeroing and one launch of `csrc/unrep_flag.cu`, its `unrep_flag` span), by
the CUDA events the span records around them, over the traced window, in ms
(`spans.py`); on CPU tensors, where the host runs the elementwise passes,
the span's host time. Nothing where the window computed no flag, or where
its events were reused before the window was read."""

from portbench import spans


def read(run):
    s = spans.window(run)
    if s is None:
        return None
    flags = s.of("unrep_flag")
    if not len(flags):
        return None
    device = s.tracing.RING.device_ns(flags)
    if device is None:
        return None
    return float(device.sum()) / s.steps / 1e6
