"""entry.host_ms: the mean host time of a call, from the call to its return
(before the synchronise), over every step of the traced window."""


def read(run):
    return float(run.window.call_seconds().mean()) * 1e3
