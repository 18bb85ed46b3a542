"""HMR 2.0's cell (``drivers/predict_hmr2.py``) at the CPU's size: a tiny
run is correct, each fault the calibration plants in the reference turns
it not correct, the attention's work is the flop counter's, and the
attention roofline reads the replays' launch counts."""

import copy
import json

import pytest
import torch

from benchmark import run, work, work_hmr2
from benchmark import spans as B
from benchmark.drivers import predict_hmr2 as D
from benchmark.reference import hmr2
from benchmark.run import HERE
from benchmark.tests import tiny
from spec_tpu_torch.utils.profiling import Span

SEED = 2 ** 31 + 91
# Its sound runs read 1e-6 at most (one BLAS on both sides).
LIMITS = {'camera_rad': 1e-3, 'focal_rel': 1e-3, 'pose6d': 1e-3,
          'shape': 1e-3, 'cam': 1e-3, 'verts_m': 1e-3, 'joints3d_m': 1e-3,
          'joints2d_px': 1e-2, 'missing': 0.0}
TINY_VIT = dict(img_size=(64, 48), patch_size=16, embed_dim=64, depth=2,
                num_heads=4, mlp_ratio=4)
TINY_DECODER = dict(dim=32, depth=2, heads=2, dim_head=16, mlp_dim=32)


@pytest.fixture(autouse=True, scope='module')
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def config() -> dict:
    """spec-hmr2-vith at 64² crops: trunk 64 wide, 2 deep, 4 heads (4 x 3
    tokens), decoder 32 wide, 2 deep; CamCalib ResNet-18 at 64 px."""
    cfg = json.loads((HERE / 'configs' / 'spec-hmr2-vith.json').read_text())
    cfg['camcalib'].update(backbone='resnet18', min_size=64)
    hmr = cfg['hmr']
    hmr['img_res'] = 64
    hmr['vit'].update(img_size=[64, 48], embed_dim=64, depth=2, num_heads=4,
                      mlp_dim=256)
    hmr['decoder'].update(context_dim=64, **TINY_DECODER)
    cfg['batch_size'] = 4
    return cfg


@pytest.fixture
def tiny_program(monkeypatch):
    """The program's ``vit_h`` and decoder at the tiny sizes."""
    from spec_tpu_torch.models.backbones import vit
    from spec_tpu_torch.models.heads import transformer_head as th

    monkeypatch.setitem(vit.VIT_SIZES, 'vit_h', TINY_VIT)
    monkeypatch.setattr(th, 'DECODER_SIZES', TINY_DECODER)


def _cell() -> run.Cell:
    bench = json.loads((HERE.parent / 'BENCHMARK.json').read_text())
    mix = tiny.mix('crowd_video')
    mix['entry'] = 'predict_hmr2'
    return run.Cell('tiny-hmr2', config(), mix,
                    copy.deepcopy(bench['end_to_end']),
                    copy.deepcopy(bench['per_layer']), dict(LIMITS))


def test_a_sound_run_is_correct(tiny_program):
    res = run.run(_cell(), SEED, 1.5, False, 'cpu')
    assert res['correct'], json.dumps(res['checks'])
    assert res['failed'] == 0 and res['attempted'] > 2


@pytest.mark.parametrize('fault', sorted(D.FAULTS))
def test_a_fault_in_the_reference_is_not_correct(tiny_program, fault):
    with D.planted(fault):
        res = run.run(_cell(), SEED, 1.0, False, 'cpu')
    assert not res['correct']
    assert res['failed'] == 0


def _attention_calls(hmr: dict) -> list:
    """(q, k, v) shapes of every attention of one person through the
    reference at ``hmr``'s sizes (on meta tensors)."""
    seen = []

    def attend(q, k, v, scale):
        seen.append((q.shape, k.shape, v.shape))
        return D._attend(q, k, v, scale)

    with torch.device('meta'):
        model = hmr2.HMR2.from_config(hmr)
    old = hmr2.attend
    hmr2.attend = attend
    try:
        res = hmr['img_res']
        model(torch.empty(1, 3, res, res, device='meta'))
    finally:
        hmr2.attend = old
    return seen


@pytest.mark.parametrize('size', ['tiny', 'published'])
def test_attention_work_is_the_flop_counters(size):
    hmr = (config() if size == 'tiny' else json.loads(
        (HERE / 'configs' / 'spec-hmr2-vith.json').read_text()))['hmr']
    calls = _attention_calls(hmr)
    vit, dec = hmr['vit'], hmr['decoder']
    assert len(calls) == vit['depth'] + 2 * dec['depth']
    counted = nbytes = 0.0
    for q, k, v in calls:
        if k[-2] == 1:              # the decoder's one-token self-attention
            continue
        with torch.device('meta'):
            counted += work.count_flops(D._attend, torch.empty(q),
                                        torch.empty(k), torch.empty(v), 1.0)
        nbytes += 4 * (2 * q.numel() + k.numel() + v.numel())
    assert work_hmr2.attention_work(hmr) == (counted, nbytes)
    if size == 'published':
        # 32 layers x 2 x 2 x 192² x 1280 and 6 x 2 x 2 x 192 x 512
        assert counted == 32 * 4 * 192 ** 2 * 1280 + 6 * 4 * 192 * 512
        # ~251 GFLOP a person: the trunk's linear layers 241.6, its
        # attention 6.0, the decoder's keys and values 3.0, the patches
        # 0.4, then SMPL
        f = work_hmr2.person_flops(hmr, 6890)
        assert 251.0e9 < f < 252.5e9


def test_attention_roofline_reads_the_replays_launches(monkeypatch):
    spans = [Span('graph/stage2/replay', 2, 1, 1, 0, 10,
                  {'rows': 32, 'launches_attention': 44}),
             Span('graph/stage2/replay', 3, 1, 1, 10, 20,
                  {'rows': 16, 'launches_attention': 44}),
             Span('predict', 1, None, 1, 0, 30, {})]
    monkeypatch.setattr(B, 'recorded', lambda: list(spans))

    class Driver:
        def attention_bound_s(self, call):
            return 1e-3 * call

    prof = {'by_name': {'fmha_cutlassF_f32_aligned_64x64_rf_sm80': 0.02,
                        'other': 1.0},
            'count_by_name': {'fmha_cutlassF_f32_aligned_64x64_rf_sm80': 40,
                              'other': 3}}
    rec = run.Window(Driver(), profile=prof, slice_calls=[10, 30])
    got = run.read_metrics([{'name': 'attention_roofline.predict',
                             'unit': '%'}], rec)
    # 88 launches of 0.5 ms each against 40 ms of bound
    assert got['attention_roofline.predict']['value'] == pytest.approx(
        100 * 0.040 / (0.02 / 40 * 88))
    prof['count_by_name'].pop('fmha_cutlassF_f32_aligned_64x64_rf_sm80')
    prof['by_name'].pop('fmha_cutlassF_f32_aligned_64x64_rf_sm80')
    assert run.read_metrics([{'name': 'attention_roofline.predict',
                              'unit': '%'}], rec) == {}
