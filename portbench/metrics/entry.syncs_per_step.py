"""entry.syncs_per_step: the port's reads of a device value to the host
(its `sync` spans: the unrepresentable-value flag's `bool`, a copy into a
numpy `out`, a tensor grid's checks) over the traced window, per step
(`spans.py`)."""

from portbench import spans


def read(run):
    s = spans.window(run)
    if s is None:
        return None
    return len(s.of("sync")) / s.steps
