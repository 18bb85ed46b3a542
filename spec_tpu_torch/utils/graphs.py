"""Stage graphs: the port's counterpart of the reference's per-stage
``jax.jit``.

The JAX package compiles each serving stage once per input shape
(``spec_tpu/serving.py``: ``jax.jit(self._cam_forward)``,
``jax.jit(self._spec_forward)``) and the bench's pipeline step as one
program (``bench.py``), so a call costs one dispatch per stage. Eager
PyTorch issues every operation from Python instead. :class:`StageGraph`
captures a stage function once per input signature (the shape, dtype
and device of each tensor argument, the key jit compiles on) as a
``torch.cuda.CUDAGraph`` and replays it after that.

* **CUDA only.** Arguments on a CUDA device always go through a graph;
  on the CPU the function runs directly (the caller asked for the CPU).
  A capture that fails raises, naming the stage and the signature:
  nothing falls back to eager on the card. ``StageGraph.fn`` is the
  eager body, for tests that hold replays against it.
* **Arguments.** Positional arguments are tensors: the signature's
  static inputs. Keyword arguments are fixed for a graph: a
  ``torch.Generator`` is registered with it (each replay draws anew
  from the generator's state), any other value must be hashable and
  joins the signature.
* **Grad mode** is the caller's: the serving stages and the pipelines
  run under ``torch.inference_mode``; a train step records autograd
  and runs its backward inside the graph.
* **First call.** The function runs once eagerly on a side stream
  (PyTorch's rule for graphs), so libraries load, the kernels' one-time
  attribute calls happen and lazily built device constants
  (:func:`device_constant`) exist before the capture; then it is
  captured on the signature's static input buffers. The capture runs
  nothing, so the first call returns the eager run's output (a train
  step takes its step once per call).
* **Replay.** Later calls copy the arguments into the static inputs,
  replay the graph and clone the outputs out: the next replay of the
  same graph, or of another graph in the same memory pool, overwrites
  the static outputs.
* **Refresh.** A stage function with a ``refresh()`` method (a stage
  module whose buffers are derived from a model's weights, such as a
  folded trunk) has it called on the host before every call, eager,
  capture or replay: it updates those buffers in place when their
  sources changed, so a graph captured earlier reads the new values.
* **Launch counters.** The kernel wrappers and ``ops.attention`` count
  launches in Python, which a replay skips. The counts a capture made
  are taken back (the capture ran nothing) and added again on every
  replay.
* **Spans.** Each call is a ``profiling.annotate`` span,
  ``graph/<name>/replay``, ``graph/<name>/capture`` or
  ``graph/<name>/eager`` (arguments on the CPU), over the copy into the
  static inputs, the replay (or the warm-up and capture) and the clone
  of the outputs, with the count ``rows`` (the first argument's leading
  size); a replay span also counts the launches it adds back, per
  module (``launches_lbs``, ``launches_attention``, ...). Spans are
  recorded only while a profiler runs.
* **Memory.** A graph pins its memory pool, so each stage keeps at most
  ``MAX_GRAPHS`` signatures (least recently used evicted and freed).
  The stages of one model share a pool (``pool``), which is safe here
  because replays run in turn on one stream and each replay's outputs
  are cloned before the next.

A captured function must not read device values on the host
(``.item()``, ``.cpu()``), build tensors from host data (``torch.tensor``
of a list, indexing with a Python list) or take data-dependent shapes:
each of these fails the capture.
"""

from __future__ import annotations

import collections
from typing import Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from spec_tpu_torch.utils import profiling

MAX_GRAPHS = 8     # signatures kept per stage (jit's cache has no cap)
_CONSTANTS: dict = {}


def device_constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """``values`` (a list, tuple or numpy array) as a tensor on
    ``device``, built once per (values, dtype, device) and shared: callers
    must not write to it. While ``torch.export`` traces, it builds the
    constant afresh and does not cache it. Inside a captured stage it must
    already exist, from the warm-up run before the capture; building one
    during a capture raises. It is a normal tensor even when first built
    in inference mode, so a later train step can save it for backward."""
    arr = np.asarray(values)
    if torch.compiler.is_exporting():
        # a constant of the traced program, on its fake device: never
        # cached for later live calls
        return torch.as_tensor(arr, dtype=dtype, device=device)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype, str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        dev = torch.device(device)
        if dev.type == 'cuda' and torch.cuda.is_current_stream_capturing():
            raise RuntimeError('device_constant: a constant built during a '
                               'CUDA graph capture (warm up first)')
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = torch.as_tensor(arr, dtype=dtype,
                                                  device=dev)
    return t


def _launch_modules():
    from spec_tpu_torch.ops import attention, bottleneck, lbs, projection

    return (attention, bottleneck, lbs, projection)


def _counted(fn, *args, **kwargs):
    """``fn``'s result and the launches it counted, per module (those
    that counted any), with every counter put back as it was."""
    mods = _launch_modules()
    before = [m.LAUNCHES for m in mods]
    try:
        return fn(*args, **kwargs), [
            (m, m.LAUNCHES - b) for m, b in zip(mods, before)
            if m.LAUNCHES != b]
    finally:
        for m, b in zip(mods, before):
            m.LAUNCHES = b


def _flatten(out):
    """Outputs as a list of tensors and a function that rebuilds the
    structure (tensors in any nesting of tuples, lists and dicts)."""
    leaves, spec = pytree.tree_flatten(out)
    other = [x for x in leaves if not isinstance(x, torch.Tensor)]
    if other:
        raise TypeError(f'a stage returns tensors in tuples, lists or '
                        f'dicts, not {type(other[0]).__name__}')
    return leaves, lambda ts: pytree.tree_unflatten(list(ts), spec)


class _Captured:
    """One signature's graph, static buffers, launch counts and the
    generators registered with it (held, so that no other generator
    takes one's id while the graph lives)."""

    def __init__(self, graph, inputs, outputs, rebuild, launches,
                 generators):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.rebuild = rebuild
        self.launches = launches
        self.generators = generators


class StageGraph:
    """A stage function replayed as a CUDA graph per input signature.

    ``fn(*tensors, **fixed)`` returns tensors in any nesting of tuples,
    lists and dicts.
    ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with other
    stages, or None for a pool of each graph's own.
    """

    def __init__(self, name: str, fn: Callable, pool=None):
        self.name = name
        self.fn = fn
        self.pool = pool
        self._graphs: collections.OrderedDict = collections.OrderedDict()

    def signatures(self) -> list:
        """The captured signatures, least recently used first: a
        (shape, dtype, device) per tensor, then a (name, value) per fixed
        argument (a generator's value is its id)."""
        return list(self._graphs)

    def __call__(self, *args, **fixed):
        refresh = getattr(self.fn, 'refresh', None)
        if refresh is not None:
            refresh()
        out = self._call(*args, **fixed)
        if profiling.NAN_GUARD:
            profiling.check_finite(f'stage {self.name!r}', out)
        return out

    def _span(self, kind: str, args):
        span = profiling.annotate(f'graph/{self.name}/{kind}')
        if span and args and args[0].dim():
            span.count(rows=int(args[0].shape[0]))
        return span

    def _call(self, *args, **fixed):
        if not all(isinstance(a, torch.Tensor) for a in args):
            raise TypeError(f'stage {self.name!r} takes tensors only')
        if not any(a.is_cuda for a in args):
            with self._span('eager', args):
                return self.fn(*args, **fixed)
        key = tuple((tuple(a.shape), a.dtype, str(a.device)) for a in args)
        key += tuple((k, id(v) if isinstance(v, torch.Generator) else v)
                     for k, v in sorted(fixed.items()))
        with torch.cuda.device(args[0].device):
            entry = self._graphs.get(key)
            if entry is None:
                with self._span('capture', args):
                    entry, out = self._capture(key, args, fixed)
                self._graphs[key] = entry
                while len(self._graphs) > MAX_GRAPHS:
                    _, old = self._graphs.popitem(last=False)
                    old.graph.reset()
                return out
            self._graphs.move_to_end(key)
            return self._replay(entry, args)

    def _replay(self, entry: _Captured, args):
        """One replay of ``entry`` on ``args``: its launches added back to
        the counters and counted on its span."""
        with self._span('replay', args) as span:
            for static, a in zip(entry.inputs, args):
                static.copy_(a)
            entry.graph.replay()
            for mod, n in entry.launches:
                mod.LAUNCHES += n
            if span:
                span.count(**{'launches_' + mod.__name__.rsplit('.', 1)[-1]:
                              n for mod, n in entry.launches})
            return entry.rebuild([t.clone() for t in entry.outputs])

    def _capture(self, key, args, fixed) -> tuple:
        """Run on a side stream, then capture on static copies of
        ``args`` (which hold ``args`` afterwards). Returns the capture
        and a clone of the eager run's output."""
        device = args[0].device
        inputs = [a.clone() for a in args]
        side = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*inputs, **fixed)
        current.wait_stream(side)
        leaves, rebuild = _flatten(out)
        for t in leaves:
            t.record_stream(current)     # made on the side, read here
        # cloned, as a replay's are: an output may alias a static input
        out = rebuild([t.clone() for t in leaves])

        generators = [g for g in fixed.values()
                      if isinstance(g, torch.Generator)]
        graph = torch.cuda.CUDAGraph()

        def capture():
            for g in generators:
                graph.register_generator_state(g)
            with torch.cuda.graph(graph, pool=self.pool):
                return _flatten(self.fn(*inputs, **fixed))

        try:
            (outputs, rebuild), launches = _counted(capture)
        except Exception as e:
            raise RuntimeError(
                f'CUDA graph capture of stage {self.name!r} failed for '
                f'signature {_describe(key)}: {e}') from e
        return _Captured(graph, inputs, outputs, rebuild, launches,
                         generators), out


def _describe(key) -> str:
    def one(item):
        if len(item) == 2:                          # a fixed argument
            return f'{item[0]}={item[1]}'
        shape, dtype, device = item
        return f'{tuple(shape)} {str(dtype).replace("torch.", "")} {device}'

    return ', '.join(one(item) for item in key)
