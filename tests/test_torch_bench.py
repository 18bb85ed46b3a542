"""spec_tpu_torch.bench on the CPU: its arguments against bench.py's, a
tiny run of each mode, and the refusal to run without a card unless the
CPU is asked for.

bench.py is read with ``ast``, not imported: importing it configures a
JAX compile cache at a fixed path.
"""

import ast
import json
import math
import pathlib

import pytest
import torch

from spec_tpu_torch import bench as TB

REPO = pathlib.Path(__file__).resolve().parents[1]


def _reference_arguments():
    """{name: (default, choices)} of bench.py's add_argument calls; a
    store_true flag defaults to False."""
    tree = ast.parse((REPO / 'bench.py').read_text())
    out = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, 'attr', '') == 'add_argument'):
            continue
        name = node.args[0].value.lstrip('-')
        kw = {k.arg: k.value for k in node.keywords}
        if 'action' in kw and ast.literal_eval(kw['action']) == 'store_true':
            default = False
        else:
            default = ast.literal_eval(kw['default']) if 'default' in kw \
                else None
        choices = ast.literal_eval(kw['choices']) if 'choices' in kw else None
        out[name] = (default, choices)
    return out


def test_arguments_and_defaults_follow_bench_py():
    ref = _reference_arguments()
    args = TB.parse_args([])
    for name in ('iters', 'frames', 'persons', 'min_size', 'camcalib_every',
                 'compute_only'):
        assert getattr(args, name) == ref[name][0], name
    # bench.py's pipeline bucket, and its batch (None -> 128 there).
    assert (args.frame_h, args.frame_w) == (ref['frame_h'][0],
                                            ref['frame_w'][0])
    assert args.batch == 128 and ref['batch'][0] is None
    assert args.mode == ref['mode'][0] == 'pipeline'
    assert set(TB.FRAME_HW) <= set(ref['mode'][1])
    # stage1: the JAX 'flax' trunk is the port's 'module'.
    assert ref['stage1'] == ('flax', ['flax', 'fused'])
    assert args.stage1 == 'module'
    assert args.dtype == 'bf16' and args.device == 'cuda'
    # Serving and latency frames are bench.py's 480x640.
    serving = TB.parse_args(['--mode', 'serving'])
    assert (serving.frame_h, serving.frame_w) == (480, 640)
    assert 'rng.rand(480, 640, 3)' in (REPO / 'bench.py').read_text()


@pytest.mark.parametrize('bad', [['--iters', '0'],
                                 ['--mode', 'input', '--input_step', 'pano'],
                                 ['--stage1', 'flax']])
def test_bad_arguments_exit(bad):
    with pytest.raises(SystemExit):
        TB.parse_args(bad)


TINY = {
    'pipeline module': ['--batch', '2', '--frame_h', '64', '--frame_w',
                        '96'],
    'pipeline fused fp32': ['--batch', '2', '--frame_h', '64', '--frame_w',
                            '96', '--stage1', 'fused', '--dtype', 'fp32'],
    'serving': ['--mode', 'serving', '--frames', '2', '--persons', '2',
                '--frame_h', '64', '--frame_w', '96', '--min_size', '64'],
    'serving compute_only': ['--mode', 'serving', '--compute_only',
                             '--frames', '2', '--persons', '2', '--frame_h',
                             '64', '--frame_w', '96', '--min_size', '64',
                             '--camcalib_every', '2'],
    'latency': ['--mode', 'latency', '--frame_h', '64', '--frame_w', '96',
                '--min_size', '64'],
    'eval': ['--mode', 'eval', '--batch', '2', '--frame_h', '64',
             '--backbone', 'resnet18'],
    'eval fp32': ['--mode', 'eval', '--batch', '2', '--frame_h', '64',
                  '--backbone', 'resnet18', '--dtype', 'fp32'],
    'train': ['--mode', 'train', '--batch', '2', '--frame_h', '64',
              '--backbone', 'resnet18'],
    'train eager fp32': ['--mode', 'train', '--batch', '2', '--frame_h',
                         '64', '--backbone', 'resnet18', '--dtype', 'fp32',
                         '--eager'],
    'train remat': ['--mode', 'train', '--batch', '2', '--frame_h', '64',
                    '--backbone', 'resnet18', '--remat'],
}


@pytest.mark.parametrize('case', sorted(TINY))
def test_tiny_cpu_run_prints_one_result_line(case, capsys):
    assert TB.main(TINY[case] + ['--device', 'cpu', '--iters', '1']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    for key in ('metric', 'value', 'unit', 'spread', 'device'):
        assert key in result, key
    assert result['device'] == 'cpu' and result['card'] is None
    assert 'vs_baseline' not in result
    spread = result['spread']
    assert spread['windows'] >= 10 and spread['iters'] == 1
    assert math.isfinite(result['value']) and result['value'] > 0
    assert spread['min'] <= result['value'] <= spread['max']
    unit = {'pipeline': 'img/s/gpu', 'serving': 'persons/s/gpu',
            'latency': 'ms/frame e2e', 'eval': 'img/s/gpu',
            'train': 'img/s/gpu'}[case.split()[0]]
    assert result['unit'] == unit
    if case == 'latency':
        assert result['compute_ms'] == pytest.approx(
            result['stage1_ms'] + result['stage2_ms'])


def test_eval_mode_takes_bench_py_eval_inputs():
    """--mode eval: bench.py's eval_bench batch (None -> 128 there), its
    --backbone default, 224^2 crops, bf16 unless --dtype fp32."""
    ref = _reference_arguments()
    args = TB.parse_args(['--mode', 'eval'])
    assert 'eval' in ref['mode'][1]
    assert args.batch == 128 and ref['batch'][0] is None
    assert "{'train': 64, 'detect': 32}.get(args.mode, 128)" in (
        REPO / 'bench.py').read_text()
    assert args.backbone == ref['backbone'][0] == 'resnet50'
    assert (args.frame_h, args.frame_w) == (224, 224)
    assert args.dtype == 'bf16'
    text = (REPO / 'bench.py').read_text()
    body = text[text.index('def eval_bench'):text.index('def latency_bench')]
    for phrase in ('B, res = args.batch, 224', 'use_cam_feats=True',
                   'S.create_test_assets(seed=i)',
                   "('neutral', 'male', 'female')", 'use_gender=True'):
        assert phrase in body, phrase


def test_train_mode_takes_bench_py_train_setup():
    """--mode train: bench.py's train_bench setup (B = 64, ResNet-50
    with camera features, bf16, synthetic SMPL, zeroed decoders, Adam
    1e-4) and its batch, array for array."""
    import numpy as np

    import __graft_entry__ as ge

    args = TB.parse_args(['--mode', 'train'])
    assert args.batch == 64 and (args.frame_h, args.frame_w) == (224, 224)
    assert args.backbone == 'resnet50' and args.dtype == 'bf16'
    assert not args.eager
    text = (REPO / 'bench.py').read_text()
    setup = text[text.index('def _train_setup'):text.index('def train_bench')]
    for phrase in ('S.create_test_assets()', 'use_cam_feats=True',
                   'dtype=jnp.bfloat16', '_zero_head_decoders(variables)',
                   'adam(1e-4)', 'S.with_packed_lbs(assets)'):
        assert phrase in setup, phrase
    rng = np.random.RandomState(0)
    want = ge._example_batch(3, rng, ge._example_inputs(3, 32, rng))
    got = TB.train_inputs(3, 32)
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    state, step, batch = TB.train_setup(2, 'resnet18', torch.float32,
                                        torch.device('cpu'), res=32)
    head = state.model.head
    assert not any(bool(t.any()) for t in (head.decpose.weight,
                                           head.deccam.bias))
    assert head.init_cam.requires_grad      # Adam trains the init buffers


def test_without_a_card_it_exits_nonzero_and_names_the_card(monkeypatch,
                                                            capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert TB.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ''
    assert 'no CUDA card' in out.err and '--device cpu' in out.err


def test_input_arguments_follow_bench_py():
    """--mode input's flags and defaults are bench.py's; camcalib_input
    is input with --input_step camcalib."""
    ref = _reference_arguments()
    args = TB.parse_args(['--mode', 'input'])
    assert 'input' in ref['mode'][1]
    for name in ('workers', 'fast_decode', 'decode_cache', 'group_by_frame',
                 'no_native_decode', 'region_cache', 'region_cache_format',
                 'input_step', 'camcalib_jitter', 'camcalib_split',
                 'camcalib_secs', 'camcalib_e2e'):
        assert getattr(args, name) == ref[name][0], name
    for name, value in (('region_cache_format', 'raw'),
                        ('camcalib_jitter', 'pil'),
                        ('camcalib_split', 'val')):
        assert value in ref[name][1]
        assert getattr(TB.parse_args(['--mode', 'input', f'--{name}',
                                      value]), name) == value
    assert (args.frame_h, args.frame_w, args.batch) == (1080, 1920, 128)
    cc = TB.parse_args(['--mode', 'camcalib_input'])
    assert (cc.mode, cc.input_step) == ('input', 'camcalib')


INPUT_TINY = {
    'train native': ['--input_step', 'train'],
    'eval cv2 fast_decode': ['--input_step', 'eval', '--no_native_decode',
                             '--fast_decode', '--decode_cache', '4',
                             '--group_by_frame'],
    'train region_cache': ['--input_step', 'train', '--region_cache',
                           '--region_cache_format', 'raw'],
    'camcalib device e2e': ['--mode', 'camcalib_input', '--camcalib_jitter',
                            'device', '--camcalib_e2e'],
    'camcalib pil': ['--mode', 'camcalib_input', '--camcalib_jitter', 'pil'],
}


@pytest.mark.parametrize('case', sorted(INPUT_TINY))
def test_input_modes_tiny_cpu_run(case, capsys, tmp_path, monkeypatch):
    # bench.py's sets, cut to six frames or images a tenth of the size
    monkeypatch.setattr(TB, 'INPUT_FRAMES', 6)
    monkeypatch.setattr(TB, 'CAMCALIB_IMAGES', 6)
    monkeypatch.setattr(TB, 'CAMCALIB_SIZES', tuple(
        (round(w / 10), round(h / 10)) for w, h in TB.CAMCALIB_SIZES))
    monkeypatch.setattr(TB, 'CAMCALIB_MIN_MAX', (60, 100))
    argv = ['--mode', 'input', '--frame_h', '96', '--frame_w', '128',
            '--batch', '2', '--workers', '2',
            '--backbone', 'resnet18', '--camcalib_secs', '0.2',
            '--iters', '1', '--device', 'cpu',
            '--bench_data', str(tmp_path)] + INPUT_TINY[case]
    assert TB.main(argv) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result['device'] == 'cpu' and result['card'] is None
    spread = result['spread']
    assert spread['min'] <= result['value'] <= spread['max']
    assert math.isfinite(result['value']) and result['value'] > 0
    if case.startswith('camcalib'):
        assert result['unit'] == 'img/s/core' and result['n_images'] == 5
        if 'e2e' in case:
            assert result['train_e2e_img_s'] > 0
        return
    step = case.split()[0]
    assert result['unit'] == 'img/s'
    assert result[f'{step}_e2e_img_s'] > 0
    assert result['device_step_ceiling_img_s'] > 0
    assert result['native_decode'] == ('cv2' not in case)
    if 'region_cache' in case:
        assert result['region_cache_hits'] > 0
