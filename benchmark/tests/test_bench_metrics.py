"""The end-to-end metrics are taken over every call of the window, the
per-layer readers over the profiled slice, and K1's work is the frozen
count."""

import statistics

import pytest

from benchmark import run, work
from benchmark.traffic import Call


class _Driver:
    def flops(self, call):
        return 1e12 * call.persons

    def k1_bound_s(self, call):
        return work.k1_bound_s(call.persons, 6890)


def _calls(persons):
    return [Call(k, [], [[0] * p], 0) for k, p in enumerate(persons)]


def _rec(latencies, persons, **kw):
    calls = _calls(persons)
    return run.Window(_Driver(), setup_s=12.5, window_s=sum(latencies),
                      latencies_s=list(latencies), units=sum(persons),
                      calls=calls, **kw)


def _read(name, rec):
    return run.read_metrics([{'name': name, 'unit': 'u'}], rec).get(
        name, {}).get('value')


def test_rate_is_all_units_over_the_whole_window():
    # one stalled call among fast ones: a median of chunk rates would hide
    # it, the rate over the window does not
    lat = [0.05] * 99 + [5.0]
    rec = _rec(lat, [100] * 100)
    assert _read('persons_per_s', rec) == pytest.approx(10000 / 9.95)
    assert _read('setup_s', rec) == 12.5


def test_p95_is_over_every_call():
    lat = [0.01 * (k + 1) for k in range(200)]
    rec = _rec(lat, [1] * 200)
    want = statistics.quantiles(lat, n=100, method='inclusive')[94] * 1e3
    assert _read('call_ms_p95', rec) == pytest.approx(want)
    assert want == pytest.approx(1900.5, rel=1e-6)


def test_k1_work_by_hand():
    flops, nbytes = work.k1_work(2, 3)
    assert flops == 2 * 2 * 3 * (3 * 218 + 24 * 12 + 12) == 11448
    assert nbytes == 4 * (3 * 218 * 3 + 24 * 3 + 2 * 218 + 2 * 288
                          + 2 * 3 * 3) == 12256
    # 128 persons of SMPL: bound by operations at the fp32 peak
    f, b = work.k1_work(128, 6890)
    assert work.k1_bound_s(128, 6890) == pytest.approx(f / 67e12)
    assert f / 67e12 > b / 3.35e12
    # one person: bound by the bytes of the shared directions
    f, b = work.k1_work(1, 6890)
    assert work.k1_bound_s(1, 6890) == pytest.approx(b / 3.35e12)


def test_model_flops_are_counted_on_the_reference():
    # ResNet-50 at 224^2 is 4.1 G multiply-adds; SMPL adds a little
    assert work.person_flops('resnet50', 224, 6890) == pytest.approx(
        8.21e9, rel=0.01)
    assert work.camcalib_flops('resnet50', 224, 224) == pytest.approx(
        8.18e9, rel=0.01)


def _profiled(persons, busy_s, slice_s, k1_events, k1_s, launches=0):
    rec = _rec([0.1] * len(persons), persons)
    rec.slice_calls = rec.calls[:2]
    rec.slice_s = slice_s
    rec.slice_k1_launches = launches
    rec.profile = {'busy_s': busy_s, 'host_launches': 40,
                   'by_name': {'lbs_kernel<8>': k1_s, 'conv': 0.01},
                   'count_by_name': {'lbs_kernel<8>': k1_events,
                                     'conv': 3}}
    return rec


def test_slice_readers():
    rec = _profiled([10, 20, 30], busy_s=0.15, slice_s=0.2, k1_events=4,
                    k1_s=0.0004)
    assert _read('device_idle_share.predict', rec) == pytest.approx(25.0)
    assert _read('device_busy_ms_per_call', rec) == pytest.approx(75.0)
    assert _read('host_launches_per_call', rec) == pytest.approx(20.0)
    # the window outside the slice: one call of 30 persons in 0.1 s
    assert _read('mfu.predict', rec) == pytest.approx(
        100 * 30e12 / 0.1 / 67e12)
    bound = work.k1_bound_s(10, 6890) + work.k1_bound_s(20, 6890)
    assert _read('k1_roofline.predict', rec) == pytest.approx(
        100 * bound / 0.0004)


def test_k1_roofline_counts_a_dropped_event():
    # five launches counted by the program, four events seen: the mean
    # event time stands for the fifth
    rec = _profiled([10, 20, 30], 0.15, 0.2, 4, 0.0004, launches=5)
    bound = work.k1_bound_s(10, 6890) + work.k1_bound_s(20, 6890)
    assert _read('k1_roofline.predict', rec) == pytest.approx(
        100 * bound / 0.0005)


def test_readers_without_a_profile_read_nothing():
    rec = _rec([0.1, 0.1], [1, 1])
    for name in ('device_idle_share.predict', 'device_busy_ms_per_call',
                 'host_launches_per_call', 'mfu.predict',
                 'k1_roofline.predict'):
        assert _read(name, rec) is None
    rec = _profiled([10, 20, 30], 0.15, 0.2, 0, 0.0)
    rec.profile['count_by_name'] = {'conv': 3}
    assert _read('k1_roofline.predict', rec) is None
