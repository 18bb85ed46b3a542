"""Reading a ``torch.profiler`` trace of a slice of the window: the
device's busy time (the union of its kernel and copy intervals), its
operations by name, the host calls that put work on the device, and the
device's idle gaps named by what the host was doing meanwhile."""

from __future__ import annotations

import collections

# CUDA runtime and driver calls that put work on the device.
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                'cuLaunchKernelEx', 'cudaMemcpyAsync', 'cudaMemsetAsync',
                'cudaGraphLaunch')
TOP = 10


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def read(prof) -> dict:
    """Busy seconds, device operations, host launch calls, device seconds
    per operation name, and idle gaps by host activity, from a stopped
    profile."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA))
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_us, end = 0.0, float('-inf')
    by_name: dict = collections.defaultdict(float)
    count: dict = collections.defaultdict(int)
    gaps = []
    for s, t, name in dev:
        if s > end > float('-inf'):
            gaps.append((end, s))
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[name] += (t - s) / 1e6
        count[name] += 1
    return {'busy_s': busy_us / 1e6, 'device_ops': len(dev),
            'host_launches': sum(1 for e in host
                                 if e.name.startswith(LAUNCH_CALLS)),
            'by_name': dict(by_name), 'count_by_name': dict(count),
            'idle_by_host': _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> dict:
    """Idle seconds of the device by the host operation under way at each
    gap's middle: of those under way, the one that started last (the
    innermost, where calls nest), or 'host' where none is."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host)
    out: dict = collections.defaultdict(float)
    stack, k = [], 0
    for a, b in sorted(gaps):
        mid = (a + b) / 2
        while k < len(spans) and spans[k][0] <= mid:
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else 'host'] += (b - a) / 1e6
    return dict(out)


def breakdown(p: dict) -> dict:
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return {'device_ops': top(p['by_name']),
            'idle_gaps': top(p['idle_by_host'])}
