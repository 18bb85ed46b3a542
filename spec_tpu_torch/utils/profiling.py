"""The trainer's part of ``spec_tpu/utils/profiling.py``: named
wall-clock stage timers and seeding. (The torch profiler and NVTX ranges
are ROADMAP.md §1 item 10, the next slice.)"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict

import numpy as np
import torch


class StepTimer:
    """Wall-clock per named stage, averaged over the last ``window``
    samples::

        timer = StepTimer()
        with timer('load'):
            batch = next(loader)
        print(timer.report())
    """

    def __init__(self, window: int = 100):
        self.window = window
        self._samples: Dict[str, collections.deque] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dq = self._samples.setdefault(
                name, collections.deque(maxlen=self.window))
            dq.append(time.perf_counter() - t0)

    def mean(self, name: str) -> float:
        dq = self._samples.get(name)
        return float(np.mean(dq)) if dq else float('nan')

    def report(self) -> str:
        return ' | '.join(f'{k} {self.mean(k) * 1e3:.1f}ms'
                          for k in sorted(self._samples))

    def as_dict(self) -> dict:
        return {k: self.mean(k) for k in self._samples}


def set_seed(seed: int, device='cpu') -> torch.Generator:
    """Seed numpy (not when ``seed`` < 0, the reference's SEED_VALUE=-1)
    and return a torch generator on ``device`` seeded with max(seed, 0):
    the counterpart of the JAX package's PRNGKey."""
    if seed >= 0:
        np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(max(int(seed), 0))
