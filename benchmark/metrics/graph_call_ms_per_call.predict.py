"""graph_call_ms_per_call.predict: the mean time per ``predict`` call of
the profiled slice in its ``graph/*`` spans (copies into a stage graph's
inputs, the replay's launch, the clone of its outputs), in ms
(``benchmark.spans``)."""

from benchmark import spans


def read(rec):
    return spans.ms_per_call(rec, 'graph')
