"""The one traffic generator: calls repeat per seed, differ across seeds,
deal the same work to every seed, and the warm-up covers every person
total of the mix."""

import itertools
from collections import Counter

import numpy as np
import pytest

from benchmark import traffic
from benchmark.tests import tiny

SEEDS = (0, 2 ** 31 + 11)


def _take(t, n):
    return list(itertools.islice(t.calls(), n))


def _key(call):
    return ([f.shape for f in call.frames],
            [np.round(b, 3).tolist() for b in call.boxes])


@pytest.mark.parametrize('mix', ['crowd_video', 'photo_batch'])
def test_calls_repeat_per_seed_and_differ_across_seeds(mix):
    a = _take(traffic.Traffic(tiny.mix(mix), SEEDS[1]), 6)
    b = _take(traffic.Traffic(tiny.mix(mix), SEEDS[1]), 6)
    c = _take(traffic.Traffic(tiny.mix(mix), SEEDS[0]), 6)
    assert [_key(x) for x in a] == [_key(x) for x in b]
    assert all(np.array_equal(f, g) for x, y in zip(a, b)
               for f, g in zip(x.frames, y.frames))
    assert [_key(x) for x in a] != [_key(x) for x in c]


@pytest.mark.parametrize('mix', ['crowd_video', 'photo_batch'])
def test_every_seed_gets_the_same_work_in_another_order(mix):
    m = tiny.mix(mix)
    deck = len(m['sizes']) * (m['persons'][1] - m['persons'][0] + 1)
    totals = []
    for seed in SEEDS:
        calls = _take(traffic.Traffic(m, seed), deck)
        totals.append(Counter(c.persons for c in calls) if
                      m['persons_per'] == 'call' else
                      Counter(len(b) for c in calls for b in c.boxes))
    assert totals[0] == totals[1]


@pytest.mark.parametrize('mix', ['crowd_video', 'photo_batch'])
def test_boxes_lie_inside_their_frames(mix):
    for call in _take(traffic.Traffic(tiny.mix(mix), 5), 20):
        for f, b in zip(call.frames, call.boxes):
            h, w = f.shape[:2]
            assert f.dtype == np.uint8 and b.dtype == np.float32
            assert np.all(b[:, 0] - b[:, 2] / 2 >= 0)
            assert np.all(b[:, 0] + b[:, 2] / 2 <= w)
            assert np.all(b[:, 1] - b[:, 3] / 2 >= 0)
            assert np.all(b[:, 1] + b[:, 3] / 2 <= h)


def test_full_size_mixes_match_their_description():
    video = traffic.Traffic(traffic.load('crowd_video'), 3)
    call = next(video.calls())
    assert len(call.frames) == 8 and call.frames[0].shape == (720, 1280, 3)
    assert 32 <= call.persons <= 128 and call.persons % 8 == 0
    photos = traffic.Traffic(traffic.load('photo_batch'), 3)
    sizes = {f.shape[:2] for f in next(photos.calls()).frames}
    assert len(sizes) == 6


@pytest.mark.parametrize('mix', ['crowd_video', 'photo_batch'])
def test_warmup_covers_every_person_total(mix):
    m = tiny.mix(mix)
    t = traffic.Traffic(m, 1)
    lo, hi = m['persons']
    per = 1 if m['persons_per'] == 'call' else m['frames_per_call']
    want = set(range(lo * per, hi * per + 1))
    if m['persons_per'] == 'call':
        want = {n * m['frames_per_call'] for n in range(lo, hi + 1)}
    got = {c.persons for c in t.warmup_calls()}
    assert got == want
