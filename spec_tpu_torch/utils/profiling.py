"""Tracing, profiling and debugging (port of
``spec_tpu/utils/profiling.py``):

* :class:`StepTimer`: named wall-clock stages with running means;
* :func:`trace`: a ``torch.profiler`` session (CPU and CUDA activities)
  writing a Chrome/TensorBoard trace under a directory (the counterpart
  of ``jax.profiler.trace``);
* :func:`annotate`: a named region in that trace, and an NVTX range on
  CUDA (``TraceAnnotation``);
* :func:`nan_guard`: raise on a NaN or infinity produced on the device
  (``jax_debug_nans``);
* :func:`set_seed` and :func:`check_batch_gradient`.
"""

from __future__ import annotations

import collections
import contextlib
import os
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


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` session over the block: CPU activities, and
    CUDA kernels and copies when a card is present. On exit the trace is
    written under ``logdir`` as ``<host>_<pid>.<time>.pt.trace.json``
    (Chrome trace format: TensorBoard's profile plugin, Perfetto or
    chrome://tracing read it). Yields the profiler."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """A named region: a ``record_function`` range in :func:`trace`'s
    trace and, on CUDA, an NVTX range (for Nsight)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


# Set by :func:`nan_guard`; read by ``utils/graphs.StageGraph`` and
# ``train/steps.TrainStep`` after each call.
NAN_GUARD = False


def nan_guard(enable: bool = True) -> None:
    """Raise on any NaN or infinity produced on the device (the
    counterpart of ``jax_debug_nans``; debug runs only). With the guard
    on, autograd's anomaly mode checks every backward, and the outputs of
    every ``StageGraph`` call (each captured stage, eager or replayed)
    and every train step are checked after the call: a
    ``FloatingPointError`` names the stage. Each check reads a flag back
    from the device, one synchronization per call."""
    global NAN_GUARD
    NAN_GUARD = bool(enable)
    torch.autograd.set_detect_anomaly(NAN_GUARD)


def check_finite(name: str, out) -> None:
    """Raise ``FloatingPointError`` when a floating tensor in ``out``
    (tensors in any nesting of tuples, lists and dicts) holds a NaN or an
    infinity."""
    import torch.utils._pytree as pytree

    leaves = [t for t in pytree.tree_leaves(out)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not leaves:
        return
    finite = torch.stack([torch.isfinite(t).all() for t in leaves])
    if not bool(finite.all()):
        bad = [i for i, ok in enumerate(finite.tolist()) if not ok]
        raise FloatingPointError(
            f'nan_guard: {name} produced a NaN or infinity in output '
            f'tensor(s) {bad} of {len(leaves)}')


def check_batch_gradient(fn, batch_input, atol: float = 1e-6) -> bool:
    """Batch independence (the reference's ``CheckBatchGradient``):
    adding 1 to sample 0 must change no other sample's output by more
    than ``atol``. Catches leaks across the batch (train-mode BatchNorm
    in an eval path, a bad reshape). ``fn``: batch -> tensor with a
    leading batch dimension; ``batch_input``: (B, ...) tensor or array,
    B >= 2."""
    x = torch.as_tensor(batch_input)
    with torch.no_grad():
        base = fn(x)
        perturbed = x.clone()
        perturbed[0] += 1.0
        out = fn(perturbed)
        leak = (out[1:] - base[1:]).abs().max()
    return bool(leak <= atol)
