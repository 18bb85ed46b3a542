"""Reading the program's own spans (``spec_tpu_torch.utils.profiling.
spans()``) in a traced run. The program records spans only while a
profiler runs, so the spans there are those of the profiled slice: one
``predict`` root per call, its children (``predict/upload``, ...,
``predict/stage2_fetch``, ``predict/results``) and the stages'
``graph/<stage>/<replay|capture|eager>`` spans under it. A program that
records no spans gives the readers nothing, and they return None.

A call's time on the host splits three ways, which add up to its root
span: the time in its ``graph/*`` spans (copies into a graph's inputs,
the launch, the clone of its outputs), the time in the fetches (the host
waiting on the device), and the rest, the host glue. The stage-2 pad
share is the rows of the padded chunks that hold no person.
"""

from __future__ import annotations

import collections

ROOT = 'predict'
FETCHES = ('predict/stage1_fetch', 'predict/stage2_fetch')
STAGE2_INPUTS = 'predict/stage2_inputs'


def recorded() -> list:
    """The program's spans, or none where it records none."""
    from spec_tpu_torch.utils import profiling

    read = getattr(profiling, 'spans', None)
    return list(read()) if read is not None else []


def _is_graph(name: str) -> bool:
    return name.startswith('graph/')


def _is_fetch(name: str) -> bool:
    return name in FETCHES


def calls(spans) -> list:
    """(root, its descendants) for each ``predict`` root span."""
    by_call = collections.defaultdict(list)
    for s in spans:
        by_call[s.call].append(s)
    return [(s, [d for d in by_call[s.call] if d is not s])
            for s in spans if s.parent is None and s.name == ROOT]


def time_in(root, under, match) -> int:
    """Nanoseconds in the descendants of ``root`` whose names ``match``
    accepts, counting only the outermost of such spans that nest."""
    by_id = {s.id: s for s in under}
    total = 0
    for s in under:
        if not match(s.name):
            continue
        p = by_id.get(s.parent)
        while p is not None and not match(p.name):
            p = by_id.get(p.parent)
        if p is None:
            total += s.end_ns - s.start_ns
    return total


def split(root, under) -> dict:
    """One call's host time in ns: ``glue``, ``fetch`` and ``graph``,
    which add up to the root span."""
    graph = time_in(root, under, _is_graph)
    fetch = time_in(root, under, _is_fetch)
    either = time_in(root, under, lambda n: _is_graph(n) or _is_fetch(n))
    return {'glue': root.end_ns - root.start_ns - either, 'fetch': fetch,
            'graph': graph}


def ms_per_call(rec, part: str):
    """The mean of ``split(...)[part]`` over the slice's ``predict``
    calls, in ms; None without a profiled slice or a ``predict`` span."""
    if rec.profile is None:
        return None
    found = calls(recorded())
    if not found:
        return None
    return sum(split(r, u)[part] for r, u in found) / len(found) / 1e6


def stage2_pad_share(rec):
    """(rows - valid rows) / rows over the slice's stage-2 chunks, in %;
    None without a profiled slice or a stage-2 chunk."""
    if rec.profile is None:
        return None
    rows = valid = 0
    for _, under in calls(recorded()):
        for s in under:
            if s.name == STAGE2_INPUTS:
                rows += s.counts.get('rows', 0)
                valid += s.counts.get('valid', 0)
    return 100.0 * (rows - valid) / rows if rows else None
