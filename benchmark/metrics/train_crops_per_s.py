"""Crops trained by every step of the window over the window's wall time
(the host clock; each step ends when its loss is on the host)."""


def read(rec):
    return rec.units / rec.window_s if rec.calls else None
