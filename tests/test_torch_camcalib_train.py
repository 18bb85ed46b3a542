"""spec_tpu_torch.cli.camcalib_train against spec_tpu's CLI, on the CPU.

The reference's own scenario (``tests/test_cli.py``,
``test_camcalib_train_cli_fdr``): twelve 64x80 JPEG crops with JSON
annotations, nine for training and three for validation, ResNet-18 with
one FC layer, MIN_RES 64, MAX_RES 96, batches of 8 (one padded), the
fast dev run (two steps, one validation batch). Both CLIs start from
the same weights: the JAX PRNGKey(0) init, bridged and saved as a torch
file, given to both as TRAINING.PRETRAINED (the fine-tune init path).
Each step's printed loss within 1e-4 relative (LOSS_RTOL; read: 6e-6
at the second step, after one Adam step at the recipe's lr 1e-3), the
validation MAE of each angle within 1e-3 degrees (MAE_ATOL).

Also: the batches of ``_bucketed_batches`` against the reference's, the
mid-epoch resume (a preempted run, and its resume skipping the trained
batches), the fine-tune init from a torch file with a mismatched head
and from a checkpoint directory, ``train`` with an injected in-memory
DEVICE_JITTER dataset of two buckets, every shipped preset against the
reference's tree, the flags, and the card rule.
"""

import ast
import contextlib
import glob
import io
import json
import os
import re
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from spec_tpu.cli import camcalib_train as JC
from spec_tpu.data.pano_dataset import CameraRegressorDataset as JDataset
from spec_tpu.models import CameraRegressorNetwork as JaxCamCalib
from spec_tpu.utils import config as JConfig
from spec_tpu_torch.cli import camcalib_train as TC
from spec_tpu_torch.data.pano_dataset import CameraRegressorDataset
from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
from spec_tpu_torch.utils import config as TConfig
from spec_tpu_torch.utils.checkpoints import (
    latest_step,
    load_checkpoint_variables,
    state_dict_from_flax,
)

LOSS_RTOL, MAE_ATOL = 1e-4, 1e-3
REPO = Path(__file__).resolve().parent.parent
OPTS = ['MODEL.BACKBONE', 'resnet18', 'DATASET.TRAIN_DS', 'pano_scalenet',
        'DATASET.MIN_RES', '64', 'DATASET.MAX_RES', '96',
        'DATASET.BATCH_SIZE', '8', 'DATASET.NUM_WORKERS', '1',
        'TRAINING.MAX_EPOCHS', '1']


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
def pano_root(tmp_path_factory):
    """The reference test's pano set, and the JAX init as a torch file."""
    root = tmp_path_factory.mktemp('data')
    pano = root / 'dataset_folders' / 'pano360'
    img_dir = pano / 'images'
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    names = []
    for i in range(12):
        nm = f'crop{i}.jpg'
        cv2.imwrite(str(img_dir / nm),
                    (rng.rand(64, 80, 3) * 255).astype('u1'))
        with open(img_dir / f'crop{i}.json', 'w') as f:
            json.dump({'vfov': 1.0 + 0.1 * i, 'pitch': 0.05 * i - 0.1,
                       'roll': 0.02 * i - 0.05}, f)
        names.append(nm)
    joblib.dump(names[:9], pano / 'train_images.pkl')
    joblib.dump(names[9:], pano / 'val_images.pkl')
    variables = JaxCamCalib(backbone='resnet18', num_fc_layers=1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    init = root / 'init.pt'
    torch.save(dict(state_dict_from_flax(jax.device_get(variables),
                                         'camcalib', 'resnet18')), init)
    return root, init


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return buf.getvalue(), out


def _losses(text):
    return [float(x) for x in re.findall(
        r'\[camcalib-train\] epoch \d+ step \d+ loss ([-\d.e+]+)', text)]


def _mae(text):
    m = re.search(r'\[camcalib-val\] epoch \d+ MAE\(deg\): (\{.*\})', text)
    return ast.literal_eval(m.group(1))


def test_fdr_matches_the_jax_cli(pano_root, tmp_path, monkeypatch):
    root, init = pano_root
    monkeypatch.setenv('SPEC_DATA_ROOT', str(root))
    opts = OPTS + ['TRAINING.PRETRAINED', str(init)]
    want, _ = _run(JC.main, ['--fdr', '--log_root', str(tmp_path / 'jax'),
                             '--opts'] + opts)
    got, state = _run(TC.main, ['--fdr', '--device', 'cpu', '--log_root',
                                str(tmp_path / 'port'), '--opts'] + opts)
    assert 'fine-tune init' in got
    assert len(_losses(got)) == len(_losses(want)) == 2
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=LOSS_RTOL)
    got_mae, want_mae = _mae(got), _mae(want)
    assert set(got_mae) == set(want_mae) == {'vfov', 'pitch', 'roll'}
    for k in want_mae:
        assert abs(got_mae[k] - want_mae[k]) <= MAE_ATOL, k
    assert state.step == 2
    ckpts = list((tmp_path / 'port').glob('**/checkpoints'))
    assert len(ckpts) == 1 and latest_step(str(ckpts[0])) == 2
    vis = list((tmp_path / 'port').glob('**/val_images/*.png'))
    names = {p.name for p in vis}
    assert {'cdf_vfov_epoch0.png', 'horizon_e000_0.png'} <= names


@pytest.mark.parametrize('shuffle,skip', [(True, 0), (True, 1),
                                          (False, 0)])
def test_bucketed_batches_match(pano_root, monkeypatch, shuffle, skip):
    """The nine training crops (DEVICE_JITTER items) in batches of 4,
    the last padded: the same index order, items, padding and
    ``valid_count`` as the reference's."""
    root, _ = pano_root
    folder = str(root / 'dataset_folders' / 'pano360')
    kw = dict(dataset='pano_scalenet', min_size=64, max_size=80,
              loss_type='kl', device_jitter=True)
    got = list(TC._bucketed_batches(CameraRegressorDataset(folder, **kw), 4,
                                    shuffle, seed=2, num_workers=1,
                                    skip=skip))
    want = list(JC._bucketed_batches(JDataset(folder, **kw), 4, shuffle,
                                     seed=2, num_workers=1, max_res=80,
                                     skip=skip))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == 'valid_count':
                assert g[k] == w[k]
            elif isinstance(w[k], list):
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


class _StopAfter:
    """GracefulShutdown stand-in whose flag rises at the n-th check."""

    def __init__(self, n):
        self.n = n
        self.checks = 0

    @property
    def requested(self):
        self.checks += 1
        return self.checks > self.n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_preempted_run_resumes_sample_exact(pano_root, tmp_path,
                                            monkeypatch):
    """Batches of 4 over nine crops: three steps an epoch. A run stopped
    before its second batch saves step 1; a sibling run with --resume
    skips that batch and trains the other two, then a second epoch."""
    from spec_tpu_torch.utils import preemption

    root, _ = pano_root
    monkeypatch.setenv('SPEC_DATA_ROOT', str(root))
    opts = ['MODEL.BACKBONE', 'resnet18', 'DATASET.TRAIN_DS',
            'pano_scalenet', 'DATASET.MIN_RES', '64', 'DATASET.MAX_RES',
            '96', 'DATASET.BATCH_SIZE', '4', 'DATASET.NUM_WORKERS', '1',
            'TRAINING.LOG_SAVE_INTERVAL', '1', 'OPTIMIZER.LR', '1e-4']
    logs = str(tmp_path / 'logs')
    monkeypatch.setattr(preemption, 'GracefulShutdown',
                        lambda: _StopAfter(1))
    first, state = _run(TC.main, ['--device', 'cpu', '--log_root', logs,
                                  '--opts'] + opts
                        + ['TRAINING.MAX_EPOCHS', '1'])
    assert 'preempted at step 1' in first and state.step == 1
    monkeypatch.setattr(preemption, 'GracefulShutdown',
                        lambda: _StopAfter(10 ** 6))
    second, state = _run(TC.main, ['--device', 'cpu', '--log_root', logs,
                                   '--resume', '--opts'] + opts
                         + ['TRAINING.MAX_EPOCHS', '2'])
    assert 'resumed from' in second
    assert 'skipping 0 completed epoch(s) + 1 batch(es) (3 steps/epoch)' \
        in second
    steps = [int(s) for s in re.findall(r'epoch \d+ step (\d+) loss',
                                        second)]
    assert steps == [2, 3, 4, 5, 6] and state.step == 6
    assert second.count('[camcalib-val] epoch') == 2


def test_finetune_init_from_file_and_checkpoint(pano_root, tmp_path,
                                                monkeypatch, capsys):
    """TRAINING.PRETRAINED: a torch file whose vfov head has another
    width keeps the model's init for that tensor and loads the rest; a
    checkpoint directory of the trainer loads its weights."""
    root, init = pano_root
    sd = torch.load(init)
    sd['fc_vfov.weight'] = torch.zeros(128, 512)
    bad = tmp_path / 'mismatch.pt'
    torch.save(sd, bad)
    missing = tmp_path / 'missing.pt'
    torch.save({k: v for k, v in sd.items() if k != 'fc_roll.bias'},
               missing)
    cfg = TConfig.camcalib_default_config()
    cfg.MODEL.BACKBONE = 'resnet18'
    cfg.TRAINING.PRETRAINED = str(missing)
    model = TC.build_model(cfg, torch.device('cpu'))
    out = capsys.readouterr().out
    assert 'shape mismatch at fc_vfov.weight' in out
    assert 'missing in checkpoint: fc_roll.bias' in out
    fresh = CameraRegressorNetwork(backbone='resnet18')
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert torch.equal(got['fc_vfov.weight'], fresh.state_dict()[
        'fc_vfov.weight'])
    assert torch.equal(got['fc_pitch.weight'], sd['fc_pitch.weight'])
    assert torch.equal(got['backbone.conv1.weight'],
                       sd['backbone.conv1.weight'])
    # the JAX loader (which refuses a missing tensor) keeps the same ones
    cfg.TRAINING.PRETRAINED = str(bad)
    got = TC.build_model(cfg, torch.device('cpu')).state_dict()
    from spec_tpu.utils.checkpoints import load_camcalib_variables
    jv = load_camcalib_variables(str(bad), backbone='resnet18',
                                 template=JaxCamCalib(
                                     backbone='resnet18').init(
                                     jax.random.PRNGKey(1),
                                     jnp.zeros((1, 64, 64, 3))))
    want = state_dict_from_flax(jax.device_get(jv), 'camcalib', 'resnet18')
    for k, v in want.items():
        if k == 'fc_vfov.weight':      # each side keeps its own init
            assert torch.equal(got[k], fresh.state_dict()[k])
        elif not k.endswith('num_batches_tracked'):
            assert torch.equal(got[k], v), k

    # without a template every tensor must be in the file, as it fits
    from spec_tpu_torch.utils.checkpoints import load_camcalib_variables
    plain = load_camcalib_variables(str(init), backbone='resnet18')
    want_init = torch.load(init)
    assert all(torch.equal(v, want_init[k]) for k, v in plain.items())
    with pytest.raises(KeyError, match='lacks 1 parameter'):
        load_camcalib_variables(str(missing), backbone='resnet18')

    monkeypatch.setenv('SPEC_DATA_ROOT', str(root))
    _, state = _run(TC.main, ['--fdr', '--device', 'cpu', '--log_root',
                              str(tmp_path / 'a'), '--opts'] + OPTS)
    ckpt = next((tmp_path / 'a').glob('**/checkpoints'))
    cfg.TRAINING.PRETRAINED = str(ckpt)
    model = TC.build_model(cfg, torch.device('cpu'))
    want = load_checkpoint_variables(str(ckpt))
    assert all(torch.equal(v, want[k]) for k, v in
               model.state_dict().items())


class _InMemory:
    """DEVICE_JITTER items in memory: uint8 frames of two sizes and
    their jitter affines (what CameraRegressorDataset yields)."""

    def __init__(self, n, seed):
        from spec_tpu_torch.data.pano_dataset import bucket_of, make_item

        rng = np.random.RandomState(seed)
        self.hw = [(64, 80) if i % 2 else (100, 60) for i in range(n)]
        self.items = [make_item(
            (rng.rand(h, w, 3) * 255).astype(np.uint8),
            np.array((w, h), np.int32), 1.0 + 0.05 * i, 0.01 * i, -0.01 * i,
            f'mem{i}', 'softargmax_biased_l2', True, True, rng)
            for i, (h, w) in enumerate(self.hw)]
        self.buckets = {}
        for i, (h, w) in enumerate(self.hw):
            self.buckets.setdefault(bucket_of((h, w)), []).append(i)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def shape_buckets(self):
        return self.buckets


def test_train_takes_an_injected_dataset(tmp_path):
    """``train`` over any dataset with ``__getitem__``, ``__len__`` and
    ``shape_buckets()``: DEVICE_JITTER uint8 batches in two buckets, one
    epoch, validation, a checkpoint."""
    cfg = TConfig.camcalib_default_config()
    cfg.LOGDIR = str(tmp_path)
    cfg.MODEL.BACKBONE = 'resnet18'
    cfg.MODEL.LOSS_TYPE = 'softargmax_biased_l2'
    cfg.DATASET.BATCH_SIZE = 2
    cfg.DATASET.NUM_WORKERS = 1
    cfg.TRAINING.MAX_EPOCHS = 1
    cfg.TRAINING.LOG_SAVE_INTERVAL = 1
    train_ds = _InMemory(6, seed=0)
    val_ds = _InMemory(3, seed=1)
    for it in val_ds.items:      # validation takes normalized fp32
        it['img'] = it.pop('img').astype(np.float32) / 255.0
        it.pop('jitter_A')
        it.pop('jitter_b')
    text, state = _run(lambda _: TC.train(cfg, train_ds, val_ds,
                                          torch.device('cpu')), None)
    assert state.step == TC.steps_per_epoch(train_ds, 2) == 4
    assert len(_losses(text)) == 4 and np.isfinite(_losses(text)).all()
    mae = _mae(text)
    assert all(np.isfinite(v) for v in mae.values())
    assert latest_step(os.path.join(str(tmp_path), 'checkpoints')) == 4


@pytest.mark.parametrize('preset', sorted(
    os.path.basename(p) for p in glob.glob(
        str(REPO / 'configs' / 'camcalib' / '*.yaml'))))
def test_presets_load_as_the_reference(preset):
    path = str(REPO / 'configs' / 'camcalib' / preset)
    got = TConfig.update_hparams(path, dialect='camcalib')
    want = JConfig.update_hparams(path, dialect='camcalib')
    assert got.to_dict() == want.to_dict()
    assert TConfig.resolve_camcalib_loss(got) == \
        JConfig.resolve_camcalib_loss(want)
    assert TConfig.camcalib_default_config().to_dict() == \
        JConfig.camcalib_default_config().to_dict()


def test_flags_match_the_reference():
    from tests.test_torch_cli_eval import _port_flags, _reference_flags

    want = _reference_flags('spec_tpu/cli/camcalib_train.py',
                            'spec_tpu/cli/_compat.py')
    got = _port_flags(TC.build_parser())
    assert set(got) - set(want) == {'--help', '--device', '--dist_backend'}
    for flag, (default, store_true) in want.items():
        assert got[flag] == (default, store_true), flag
    assert got['--device'][0] == 'cuda'


def test_needs_a_card_unless_asked_and_multihost_raises(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        TC.main(['--log_root', str(tmp_path)])
    assert 'device cpu' in str(e.value)
    assert not (tmp_path / 'camcalib_train').exists()
    # the multi-process flags are ported: a coordinator needs its world
    with pytest.raises(ValueError, match='--num_processes'):
        TC.main(['--coordinator_address', 'localhost:1234', '--device',
                 'cpu'])


def test_smoke_recipe_is_the_released_preset():
    """chip_smoke.py's CamCalib phase carries the released recipe as a
    dict (the card machine reads no YAML): it must load to the same tree
    as configs/camcalib/config_sa_bias_l2.yaml."""
    import chip_smoke

    cfg = TConfig.camcalib_default_config()
    cfg.merge_from_dict(chip_smoke.CAMCALIB_RECIPE)
    want = TConfig.update_hparams(
        str(REPO / 'configs' / 'camcalib' / 'config_sa_bias_l2.yaml'),
        dialect='camcalib')
    assert cfg.to_dict() == want.to_dict()
    assert tuple(chip_smoke.CAMCALIB_MIN_MAX) == (want.DATASET.MIN_RES,
                                                  want.DATASET.MAX_RES)
    from spec_tpu_torch.data.pano_dataset import resized_bucket
    for (h, w), bucket in chip_smoke.CAMCALIB_FRAMES.items():
        assert resized_bucket(w, h, *chip_smoke.CAMCALIB_MIN_MAX) == bucket
