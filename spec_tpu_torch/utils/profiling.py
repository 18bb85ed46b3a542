"""Tracing, profiling and debugging (port of
``spec_tpu/utils/profiling.py``):

* :class:`StepTimer`: named wall-clock stages with running means, each
  stage also a span;
* :func:`trace`: a ``torch.profiler`` session (CPU and CUDA activities)
  writing a Chrome/TensorBoard trace under a directory (the counterpart
  of ``jax.profiler.trace``);
* :func:`annotate`: the port's span. While a profiler runs it is a named
  region in that trace, an NVTX range on CUDA (``TraceAnnotation``) and
  a record in memory (:func:`spans`); otherwise it costs one flag check;
* :func:`nan_guard`: raise on a NaN or infinity produced on the device
  (``jax_debug_nans``);
* :func:`set_seed` and :func:`check_batch_gradient`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch


class StepTimer:
    """Wall-clock per named stage, averaged over the last ``window``
    samples::

        timer = StepTimer()
        with timer('load'):
            batch = next(loader)
        print(timer.report())

    Each stage is also an :func:`annotate` span named ``prefix + name``
    (the trainer's: ``train/load``, ``train/h2d``, ...).
    """

    def __init__(self, window: int = 100, prefix: str = ''):
        self.window = window
        self.prefix = prefix
        self._samples: Dict[str, collections.deque] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            with annotate(self.prefix + name):
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


# Spans kept in memory, oldest dropped first.
MAX_SPANS = 100_000
_SPANS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_OPEN = threading.local()          # this thread's stack of open spans
_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class Span:
    """One recorded span: ``id``, its ``parent``'s id (None for a root),
    the ``call`` id its root opened (shared by every span under that
    root), start and end on ``time.perf_counter_ns``, and the counts."""
    name: str
    id: int
    parent: Optional[int]
    call: int
    start_ns: int
    end_ns: int
    counts: dict


class _Recording:
    """An open span while a profiler runs: a range in the profiler's
    trace, an NVTX range on CUDA, and a :class:`Span` appended to
    :func:`spans` on exit. True, so a count that costs work is computed
    only under ``if span:``.

    The range is a function-scope ``RecordFunction``
    (``_RecordFunctionFast``), a host event as an operator's is. A
    ``torch.profiler.record_function`` range is of user scope, which the
    profiler mirrors onto the device's timeline as an annotation over
    the kernels launched inside it: a trace's reader would take those
    for device work."""

    __slots__ = ('name', 'counts', 'id', 'parent', 'call', 'start_ns',
                 '_range', '_nvtx')

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts

    def count(self, **counts) -> None:
        """Set counts of this span (known only inside it)."""
        self.counts.update(counts)

    def __enter__(self):
        stack = getattr(_OPEN, 'stack', None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _OPEN.stack.pop()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        try:
            self._range.__exit__(*exc)
        finally:
            _SPANS.append(Span(self.name, self.id, self.parent, self.call,
                               self.start_ns, end, self.counts))
        return False


class _Off:
    """The span while no profiler runs: records nothing. False, so that
    ``if span:`` skips the work of a count."""

    __slots__ = ()

    def count(self, **counts) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def annotate(name: str, **counts):
    """A span named ``name`` over a ``with`` block, with integer counts
    (``rows=...``; more with ``span.count(...)`` inside the block).

    While a ``torch.profiler`` session runs (:func:`trace`, or any
    ``torch.profiler.profile``), the span is a named host range in its
    trace (beside the device's kernels, on its clock), an NVTX range on
    CUDA, and a :class:`Span` in :func:`spans`: a span opened
    inside another is its child and shares its root's call id. With no
    profiler running it does nothing past one flag check. A span must
    not stay open across a ``yield``, and none goes inside a captured
    stage body (a graph replay skips the body's Python)."""
    if not _profiler_enabled():
        return _OFF
    return _Recording(name, counts)


def spans() -> list:
    """The recorded spans, in the order they closed (children before
    their parent), the last :data:`MAX_SPANS` at most."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


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
