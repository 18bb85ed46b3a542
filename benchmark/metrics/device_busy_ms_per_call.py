"""The device's busy time (union of its operations' intervals) per call
of the profiled slice, in ms."""


def read(rec):
    if rec.profile is None or not rec.slice_calls:
        return None
    return 1e3 * rec.profile['busy_s'] / len(rec.slice_calls)
