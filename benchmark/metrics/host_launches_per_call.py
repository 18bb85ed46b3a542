"""Host calls that put work on the device (kernel launches, copies,
memsets, graph launches, as the profiler names them) per call of the
profiled slice."""


def read(rec):
    if rec.profile is None or not rec.slice_calls:
        return None
    return rec.profile['host_launches'] / len(rec.slice_calls)
