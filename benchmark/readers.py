"""Readers shared by the per-layer metrics of several entry points (each
metric's own file under ``benchmark/metrics/`` names the one it uses)."""

from benchmark import work


def idle_share(rec):
    """1 - (union of the device's operation intervals) / (the profiled
    slice's wall time), in %."""
    if rec.profile is None or rec.slice_s <= 0:
        return None
    return 100.0 * (1.0 - rec.profile['busy_s'] / rec.slice_s)


def mfu(rec):
    """The operations the window's calls outside the profiled slice need
    (``driver.flops``, counted on the reference) over that time and the
    card's fp32 peak, in %."""
    if rec.profile is None:
        return None
    profiled = {id(c) for c in rec.slice_calls}
    rest = [c for c in rec.calls if id(c) not in profiled]
    seconds = rec.window_s - rec.slice_s
    if not rest or seconds <= 0:
        return None
    flops = sum(rec.driver.flops(c) for c in rest)
    return 100.0 * flops / seconds / work.PEAK_FP32_FLOPS


def k1_roofline(rec):
    """K1's least time for the slice's calls (``driver.k1_bound_s``) over
    its device time: the mean of the ``lbs_kernel`` events the profiler
    saw times the launches (the program's launch counter, or the events
    seen where more), in %."""
    p = rec.profile
    if p is None:
        return None
    seen = sum(c for n, c in p['count_by_name'].items() if 'lbs_kernel' in n)
    if not seen:
        return None
    total = sum(t for n, t in p['by_name'].items() if 'lbs_kernel' in n)
    k1_s = total / seen * max(seen, rec.slice_k1_launches)
    return 100.0 * sum(rec.driver.k1_bound_s(c)
                       for c in rec.slice_calls) / k1_s
