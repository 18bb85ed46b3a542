"""glue_ms_per_call.predict: the mean ``predict`` span of the profiled
slice less the time in its ``graph/*`` and ``predict/*_fetch`` spans, in
ms: Python on the host that neither drives a stage graph nor waits on
the device (``benchmark.spans``)."""

from benchmark import spans


def read(rec):
    return spans.ms_per_call(rec, 'glue')
