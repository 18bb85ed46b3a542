"""The port's spans (``spec_tpu_torch.utils.profiling.annotate``) on the
CPU: a tiny ``SpecPredictor`` under ``torch.profiler`` records one
``predict`` root per call whose children nest inside it, share its call
id, carry the counts of the padded batches and appear as host events
of function scope in the profiler's trace; with no profiler running
nothing is recorded and no profiler range is entered;
the record list is bounded; ``StageGraph`` and ``StepTimer`` open their
own spans.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spec_tpu_torch.utils import profiling as P
from spec_tpu_torch.utils.graphs import StageGraph

BATCH = 4
BOXES = [
    np.zeros((0, 4), np.float32),                       # no person
    np.array([[40.0, 55.0, 50.0, 50.0]], np.float32),
    np.array([[60.0, 50.0, 40.0, 70.0],
              [90.0, 40.0, 30.0, 55.0],                 # over the edge
              [120.0, 10.0, 45.0, 60.0]], np.float32),
    np.array([[40.0, 60.0, 30.0, 50.0],
              [50.0, 50.0, 40.0, 40.0],
              [30.0, 80.0, 20.0, 40.0]], np.float32),
]
PERSONS = sum(len(b) for b in BOXES)                    # 7: chunks 4 + 3
PREDICT_SPANS = {'predict/upload', 'predict/detect', 'predict/keyframes',
                 'predict/stage1_inputs', 'predict/stage1_fetch',
                 'predict/work_list', 'predict/stage2_inputs',
                 'predict/stage2_fetch', 'predict/results'}
GRAPH_SPANS = {'graph/stage1/eager', 'graph/stage2/eager'}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def pred():
    from spec_tpu_torch.serving import SpecPredictor

    return SpecPredictor(device='cpu', backbone='resnet18',
                         camcalib_backbone='resnet18', min_size=64,
                         img_res=64, batch_size=BATCH, cut_threshold=0.5)


def _frames():
    """Three landscape frames and one portrait: two stage-1 buckets."""
    rng = np.random.default_rng(0)
    return ([rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
             for _ in range(3)]
            + [rng.integers(0, 256, (128, 96, 3), dtype=np.uint8)])


@pytest.fixture
def no_spans():
    P.clear_spans()
    yield
    P.clear_spans()


def _check_tree(spans):
    """Every span nests inside its parent's interval and carries its
    root's call id; returns the roots and each root's descendants."""
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s.parent is None]
    under = {r.id: [] for r in roots}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.call == s.id
            continue
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.call == parent.call
        under[s.call].append(s)
    return roots, under


@pytest.mark.parametrize('every', [1, 8])
def test_predict_spans_under_a_profiler(pred, every, no_spans):
    pred.camcalib_every = every
    pred.reset_camera_stream(all_streams=True)
    frames = _frames()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [pred.predict(frames, BOXES, stream='s') for _ in range(2)]
    for out in outs:
        assert [len(f) for f in out] == [len(b) for b in BOXES]
    spans = P.spans()
    roots, under = _check_tree(spans)
    assert [r.name for r in roots] == ['predict', 'predict']
    for r in roots:
        assert r.counts == {'frames': len(frames), 'persons': PERSONS}
        assert all(s.parent == r.id for s in under[r.id]
                   if s.name.startswith('predict/'))
    names = {s.name for s in spans}
    want = PREDICT_SPANS - {'predict/detect'} | GRAPH_SPANS | {'predict'}
    if every == 1:
        want -= {'predict/keyframes'}
    assert names == want

    for r in roots:
        kids = under[r.id]
        s2 = [(s.counts['rows'], s.counts['valid']) for s in kids
               if s.name == 'predict/stage2_inputs']
        assert s2 == [(pred._padded(BATCH), BATCH),
                      (pred._padded(PERSONS - BATCH), PERSONS - BATCH)]
        assert [s.counts['rows'] for s in kids
                if s.name == 'graph/stage2/eager'] == [r for r, _ in s2]
        assert [s.counts for s in kids if s.name == 'predict/work_list'] \
            == [{'persons': PERSONS}]
        assert sum(s.counts['persons'] for s in kids
                   if s.name == 'predict/results') == PERSONS
        s1 = [(s.counts['rows'], s.counts['valid']) for s in kids
              if s.name == 'predict/stage1_inputs' and s.counts]
        upload = [s for s in kids if s.name == 'predict/upload']
        assert [s.counts['bytes'] for s in upload] == [
            sum(f.nbytes for f in frames)]
        if every == 1:                      # buckets of 3 and 1 frames
            assert sorted(s1) == sorted([
                (pred._padded(3, pred._min_pad_s1), 3),
                (pred._padded(1, pred._min_pad_s1), 1)])
        else:
            keys = [s for s in kids if s.name == 'predict/keyframes']
            assert [s.counts for s in keys] == [{'frames': len(frames)}]
    if every > 1:                   # the first call's frame 0 only
        first = [s for s in under[roots[0].id]
                 if s.name == 'predict/stage1_inputs' and s.counts]
        assert [(s.counts['rows'], s.counts['valid']) for s in first] \
            == [(1, 1)]
        assert not any(s.name.startswith('graph/stage1')
                       for s in under[roots[1].id])

    # each span is a host range in the profiler's trace, of function
    # scope: a user-scope range (torch.profiler.record_function) would be
    # mirrored onto the device's timeline as an annotation over the
    # kernels launched inside it, which a trace's reader takes for
    # device work
    events = [e for e in prof.events() if e.name in names]
    for name in names:
        assert sum(e.name == name for e in events) >= sum(
            s.name == name for s in spans), name
    assert {e.scope for e in events} == {0}
    assert {str(e.device_type) for e in events} == {'DeviceType.CPU'}


def test_estimate_cameras_root(pred, no_spans):
    with profile(activities=[ProfilerActivity.CPU]):
        cams = pred.estimate_cameras(_frames()[:2])
    assert len(cams) == 2
    roots, under = _check_tree(P.spans())
    assert [(r.name, r.counts) for r in roots] == [
        ('estimate_cameras', {'frames': 2})]
    assert {s.name for s in under[roots[0].id]} == {
        'predict/upload', 'predict/stage1_inputs', 'graph/stage1/eager',
        'predict/stage1_fetch'}


def test_no_profiler_no_spans(pred, no_spans, monkeypatch):
    """With no profiler running, predict records nothing and enters no
    profiler range; its results equal those of a profiled call."""
    pred.camcalib_every = 1
    frames = _frames()
    with profile(activities=[ProfilerActivity.CPU]):
        want = pred.predict(frames, BOXES)
    P.clear_spans()

    def boom(*args, **kwargs):
        raise AssertionError('a profiler range entered with no profiler')

    monkeypatch.setattr(torch.profiler, 'record_function', boom)
    monkeypatch.setattr(torch._C._profiler, '_RecordFunctionFast', boom)
    got = pred.predict(frames, BOXES)
    with P.annotate('x', rows=1) as span:
        span.count(valid=1)
        assert not span
    assert P.spans() == []
    for fw, fg in zip(want, got):
        assert len(fw) == len(fg)
        for pw, pg in zip(fw, fg):
            for k, v in pw.items():
                if k != 'camera':
                    np.testing.assert_array_equal(pg[k], v)


def test_span_list_is_bounded(no_spans, monkeypatch):
    assert P.MAX_SPANS == 100_000 and P._SPANS.maxlen == P.MAX_SPANS
    import collections

    monkeypatch.setattr(P, '_SPANS', collections.deque(maxlen=5))
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(8):
            with P.annotate('s', k=k):
                pass
    assert [s.counts['k'] for s in P.spans()] == [3, 4, 5, 6, 7]


def test_stage_graph_eager_span(no_spans):
    stage = StageGraph('toy', lambda a, b: {'s': a + b})
    with profile(activities=[ProfilerActivity.CPU]):
        with P.annotate('outer'):
            out = stage(torch.ones(5, 2), torch.ones(5, 2))
    assert torch.equal(out['s'], torch.full((5, 2), 2.0))
    inner, outer = P.spans()
    assert (inner.name, inner.counts, inner.parent, inner.call) == (
        'graph/toy/eager', {'rows': 5}, outer.id, outer.id)


def test_step_timer_spans(no_spans):
    timer = P.StepTimer(prefix='train/')
    with profile(activities=[ProfilerActivity.CPU]):
        with timer('load'):
            pass
    with timer('step'):                     # no profiler: no span
        pass
    assert [s.name for s in P.spans()] == ['train/load']
    assert set(timer.as_dict()) == {'load', 'step'}
    assert timer.report().startswith('load ')
