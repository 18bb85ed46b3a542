"""fetch_wait_ms_per_call.predict: the mean time per ``predict`` call of
the profiled slice in its ``predict/stage1_fetch`` and
``predict/stage2_fetch`` spans, in ms: the host waiting on the device
(``benchmark.spans``)."""

from benchmark import spans


def read(rec):
    return spans.ms_per_call(rec, 'fetch')
