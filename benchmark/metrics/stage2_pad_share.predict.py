"""stage2_pad_share.predict: the share of stage 2's padded rows that
hold no person, (rows - valid) / rows over the ``predict/stage2_inputs``
spans of the profiled slice, in % (``benchmark.spans``)."""

from benchmark.spans import stage2_pad_share as read  # noqa: F401
