"""device.idle_pct: the share of the traced window in which the device had
no step's work, 100 x (1 - steps x device time of a step / window), with the
head-start device time of a step (`timing.py`); nothing for a call whose
pass never got ahead."""


def read(run):
    if run.device_step is None:
        return None
    win = run.window
    return 100.0 * (1.0 - win.steps * run.device_step.seconds / win.seconds)
