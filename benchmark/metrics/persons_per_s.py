"""Persons returned by every call completed in the window, over the
window's wall time (the host clock, from the first call's start to the
last call's end)."""


def read(rec):
    return rec.units / rec.window_s if rec.calls else None
