"""Thread-safe decoded-image LRU shared by loader threads (port of
``spec_tpu/data/cache.py``): ``CamDataset(decode_cache=N)`` keeps N
decoded frames, so the samples of a multi-person frame decode it once."""

from __future__ import annotations

import collections
import threading


class FrameCache:
    """Thread-safe LRU of decoded images keyed by the caller's key.

    Cached values are shared across loader threads and must be treated
    as read-only. ``get_or_compute`` deduplicates decodes in flight:
    siblings of one frame handed to the pool at once wait for the first
    one's decode instead of decoding the frame again."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d = collections.OrderedDict()
        self._lock = threading.Lock()
        self._inflight = {}
        self.hits = 0
        self.misses = 0

    def get_or_compute(self, key, fn):
        while True:
            with self._lock:
                val = self._d.get(key)
                if val is not None:
                    self._d.move_to_end(key)
                    self.hits += 1
                    return val
                event = self._inflight.get(key)
                if event is None:
                    event = threading.Event()
                    self._inflight[key] = event
                    self.misses += 1
                    break
            # another thread is decoding this key: wait, then look again
            # (the value may have been evicted, or its owner raised)
            event.wait()
        try:
            val = fn()
            with self._lock:
                self._d[key] = val
                self._d.move_to_end(key)
                while len(self._d) > self.capacity:
                    self._d.popitem(last=False)
            return val
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            event.set()
