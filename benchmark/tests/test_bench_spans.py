"""The span readers (``benchmark/spans.py``): on hand-made spans the host
glue, the fetch wait and the graph calls add up to the ``predict`` span
and the pad share is the empty rows of the stage-2 chunks; with no
span, or no profiled slice, the readers give nothing; on a tiny
predictor profiled on the CPU the three still add up."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark import spans as B
from spec_tpu_torch.utils.profiling import Span

NAMES = ('glue_ms_per_call.predict', 'fetch_wait_ms_per_call.predict',
         'graph_call_ms_per_call.predict')


def _call(call, t0, chunks):
    """A predict call at ``t0`` ms: upload 1 ms, stage-1 inputs 1, its
    graph 2, fetch 3, work list 1, then per chunk (rows, valid): inputs
    1, graph 2; then per chunk fetch 4 and results 1; 1 ms of the root's
    own at the end. Returns the spans, children first."""
    ids = iter(range(call + 1, call + 100))
    out, t = [], t0

    def span(name, ms, **counts):
        nonlocal t
        out.append(Span(name, next(ids), call, call, int(t * 1e6),
                        int((t + ms) * 1e6), counts))
        t += ms

    span('predict/upload', 1, bytes=10)
    span('predict/stage1_inputs', 1, rows=1, valid=1)
    span('graph/stage1/replay', 2, rows=1)
    span('predict/stage1_fetch', 3)
    span('predict/work_list', 1, persons=sum(v for _, v in chunks))
    for rows, valid in chunks:
        span('predict/stage2_inputs', 1, rows=rows, valid=valid)
        span('graph/stage2/replay', 2, rows=rows)
    for _, valid in chunks:
        span('predict/stage2_fetch', 4)
        span('predict/results', 1, persons=valid)
    t += 1
    out.append(Span('predict', call, None, call, int(t0 * 1e6),
                    int(t * 1e6), {'frames': 8}))
    return out


def _rec(spans_list, monkeypatch, profile=True):
    monkeypatch.setattr(B, 'recorded', lambda: list(spans_list))
    return run.Window(None, profile={} if profile else None)


def _read(name, rec):
    return run.read_metrics([{'name': name, 'unit': 'u'}], rec).get(
        name, {}).get('value')


def test_three_parts_add_up_to_the_call(monkeypatch):
    # call 1: chunks (32, 32), (32, 24); call 2: one chunk (16, 9)
    spans = (_call(1, 0.0, [(32, 32), (32, 24)])
             + _call(200, 100.0, [(16, 9)]))
    rec = _rec(spans, monkeypatch)
    glue, fetch, graph = (_read(n, rec) for n in NAMES)
    # call 1: 1+1+1+1+1+1+1+1 = 8 glue, 3+8 fetch, 2+4 graph: 25 ms
    # call 2: 1+1+1+1+1+1 = 6 glue, 3+4 fetch, 2+2 graph: 17 ms
    assert glue == pytest.approx((8 + 6) / 2)
    assert fetch == pytest.approx((11 + 7) / 2)
    assert graph == pytest.approx((6 + 4) / 2)
    roots = [s for s in spans if s.name == 'predict']
    assert glue + fetch + graph == pytest.approx(
        np.mean([(s.end_ns - s.start_ns) / 1e6 for s in roots]))


def test_pad_share(monkeypatch):
    spans = (_call(1, 0.0, [(32, 32), (32, 24)])
             + _call(200, 100.0, [(16, 9)]))
    rec = _rec(spans, monkeypatch)
    assert _read('stage2_pad_share.predict', rec) == pytest.approx(
        100.0 * (8 + 7) / (32 + 32 + 16))


def test_nested_graph_spans_count_once(monkeypatch):
    # a replicated stage's replica graphs inside an outer graph span
    spans = _call(1, 0.0, [(8, 8)])
    outer = next(s for s in spans if s.name == 'graph/stage2/replay')
    spans.insert(0, Span('graph/stage2/replay', 99, outer.id, 1,
                         outer.start_ns, outer.end_ns, {'rows': 8}))
    rec = _rec(spans, monkeypatch)
    assert _read('graph_call_ms_per_call.predict', rec) == pytest.approx(4)


def test_no_spans_no_reading(monkeypatch):
    for spans_list, profile in (([], True),
                                (_call(1, 0.0, [(8, 8)]), False)):
        rec = _rec(spans_list, monkeypatch, profile)
        for name in NAMES + ('stage2_pad_share.predict',):
            assert _read(name, rec) is None
    # spans of other roots only (a train step's graph)
    train = [Span('graph/train/replay', 1, None, 1, 0, 10, {'rows': 64})]
    rec = _rec(train, monkeypatch)
    assert all(_read(n, rec) is None for n in NAMES)


def test_a_program_without_spans_gives_none(monkeypatch):
    from spec_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, 'spans')
    assert B.recorded() == []


def test_on_a_profiled_tiny_predictor():
    from torch.profiler import ProfilerActivity, profile

    from spec_tpu_torch.serving import SpecPredictor
    from spec_tpu_torch.utils import profiling

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pred = SpecPredictor(device='cpu', backbone='resnet18',
                             camcalib_backbone='resnet18', min_size=64,
                             img_res=64, batch_size=4)
        rng = np.random.default_rng(3)
        frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
                  for _ in range(2)]
        boxes = [np.array([[40.0, 50.0, 30.0, 60.0]] * k, np.float32)
                 for k in (3, 2)]
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            pred.predict(frames, boxes)
        rec = run.Window(None, profile={})
        parts = [_read(name, rec) for name in NAMES]
        (root,) = [s for s in profiling.spans() if s.name == 'predict']
        assert all(p is not None and p >= 0 for p in parts)
        assert sum(parts) == pytest.approx(
            (root.end_ns - root.start_ns) / 1e6, rel=1e-9)
        # 5 persons in chunks of 4 and 1: no row is padding
        assert _read('stage2_pad_share.predict', rec) == 0.0
    finally:
        profiling.clear_spans()
        torch.set_num_threads(n)
