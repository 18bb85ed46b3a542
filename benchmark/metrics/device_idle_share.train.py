"""device_idle_share.train: ``benchmark.readers.idle_share``, the work being the train steps of the slice."""

from benchmark.readers import idle_share as read  # noqa: F401
