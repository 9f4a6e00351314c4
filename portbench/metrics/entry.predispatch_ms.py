"""entry.predispatch_ms: the port's host time from the start of its public
call to the start of its kernel dispatch (the entry's checks and
conversions, the cached tensors' lookup, the route's lookup), mean over the
`entry` spans of the traced window that hold a `dispatch` span, in ms
(`spans.py`)."""

from portbench import spans


def read(run):
    s = spans.window(run)
    if s is None:
        return None
    entries = s.of("entry")
    held, first = spans.first_within(entries, s.of("dispatch"))
    if not held.any():
        return None
    return float((first[held] - entries[held, 1]).mean()) / 1e6
