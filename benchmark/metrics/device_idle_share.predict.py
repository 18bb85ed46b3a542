"""device_idle_share.predict: ``benchmark.readers.idle_share``, the work being the predict calls of the slice."""

from benchmark.readers import idle_share as read  # noqa: F401
