"""spec_tpu_torch.cli.camcalib_demo against spec_tpu.cli.camcalib_demo, on
the CPU.

The JAX package's PRNGKey(0) init of a ResNet-18 CamCalib (the golden's
model, tests/test_goldens.py:39-59) is carried to the port through
``state_dict_from_flax`` and saved as a torch checkpoint, which both
demos load. Limits: the golden at tests/test_goldens.py's
``RTOL, ATOL = 2e-3, 1e-5``; angles between the two demos within 1e-4
rad and f_pix within 0.05 px (tests/test_torch_serving.py's camera
limits).
"""

import json
import os

import cv2
import joblib
import numpy as np
import pytest
import torch

from spec_tpu_torch.cli import camcalib_demo as TDemo

MIN_SIZE = 64


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
def ckpt(tmp_path_factory):
    """The golden's CamCalib weights as a torch state_dict file."""
    import jax
    import jax.numpy as jnp

    from spec_tpu.models import CameraRegressorNetwork
    from spec_tpu_torch.utils.checkpoints import state_dict_from_flax

    variables = CameraRegressorNetwork(backbone='resnet18',
                                       num_fc_layers=1).init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, MIN_SIZE, MIN_SIZE, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp('ckpt') / 'camcalib_r18.pt')
    torch.save(dict(state_dict_from_flax(variables, 'camcalib', 'resnet18')),
               path)
    return path


def _fields(results):
    return {os.path.basename(name): {k: float(v) for k, v in f.items()}
            for name, f in sorted(results.items())}


def test_camcalib_demo_golden(ckpt, tmp_path):
    """tests/goldens.json's camcalib_demo entry, computed with the port:
    the golden's images and flags, its weights through the bridge."""
    from tests.test_goldens import ATOL, GOLDENS_PATH, RTOL, _assert_close

    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    rng = np.random.RandomState(42)
    for i in range(2):
        cv2.imwrite(str(img_dir / f'g{i}.png'),
                    (rng.rand(96, 128, 3) * 255).astype('u1'))
    out = TDemo.run_camcalib_on_folder(
        str(img_dir), str(tmp_path / 'out'), ckpt=ckpt, backbone='resnet18',
        min_size=MIN_SIZE, batch_size=2, save_images=False, device='cpu')
    with open(GOLDENS_PATH) as f:
        golden = json.load(f)['camcalib_demo']
    _assert_close(golden, _fields(out), 'camcalib_demo', rtol=RTOL,
                  atol=ATOL)


def test_folder_mode_matches_reference(ckpt, tmp_path, rng):
    """Five images of three sizes (two resized buckets, a padded tail
    batch): the same pickles as the reference demo, and a horizon overlay
    per image."""
    from spec_tpu.cli.camcalib_demo import run_camcalib_on_folder as ref_run

    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    for i, (h, w) in enumerate([(96, 128), (64, 80), (96, 128), (80, 64),
                                (96, 128)]):
        cv2.imwrite(str(img_dir / f'im{i}.jpg'),
                    (rng.rand(h, w, 3) * 255).astype('u1'))
    kw = dict(ckpt=ckpt, backbone='resnet18', min_size=MIN_SIZE,
              batch_size=2, loss_type='softargmax_biased_l2')
    port = TDemo.run_camcalib_on_folder(str(img_dir), str(tmp_path / 'p'),
                                        device='cpu', **kw)
    ref = ref_run(str(img_dir), str(tmp_path / 'r'), save_images=False, **kw)
    assert sorted(port) == sorted(ref) and len(port) == 5
    for name in ref:
        base = os.path.basename(name)
        got = joblib.load(tmp_path / 'p' / f'{base}.pkl')
        assert set(got) == {'vfov', 'f_pix', 'pitch', 'roll'}
        for k in ('vfov', 'pitch', 'roll'):
            assert abs(got[k] - ref[name][k]) < 1e-4, (base, k)
        assert abs(got['f_pix'] - ref[name]['f_pix']) < 0.05, base
        overlay = cv2.imread(str(tmp_path / 'p' / base))
        assert overlay.shape == cv2.imread(name).shape


def test_dataset_mode(ckpt, tmp_path, rng, monkeypatch):
    """--dataset NAME: the image list from a registered npz's imgname
    column (duplicates once), the same list as the reference's."""
    from spec_tpu.cli.camcalib_demo import _dataset_image_list as ref_list

    root = tmp_path / 'data'
    (root / 'dataset_extras').mkdir(parents=True)
    img_dir = root / 'dataset_folders' / '3dpw'
    img_dir.mkdir(parents=True)
    names = [f'f{i}.jpg' for i in range(3)]
    for nm in names:
        cv2.imwrite(str(img_dir / nm),
                    (rng.rand(60, 80, 3) * 255).astype('u1'))
    np.savez(root / 'dataset_extras' / '3dpw_test_cam_camcalib.npz',
             imgname=np.array(names + names[:1]))
    monkeypatch.setenv('SPEC_DATA_ROOT', str(root))
    assert TDemo._dataset_image_list('3dpw-test-cam') == ref_list(
        '3dpw-test-cam')
    out = tmp_path / 'cc_out'
    TDemo.main(['--dataset', '3dpw-test-cam', '--out_folder', str(out),
                '--backbone', 'resnet18', '--batch_size', '2',
                '--min_size', str(MIN_SIZE), '--no_save', '--ckpt', ckpt,
                '--device', 'cpu'])
    pkls = sorted(out.glob('*.pkl'))
    assert [p.name for p in pkls] == [f'{n}.pkl' for n in names]
    assert not list(out.glob('*.jpg'))
    res = joblib.load(pkls[0])
    assert set(res) == {'vfov', 'f_pix', 'pitch', 'roll'}
    assert np.isfinite(res['f_pix'])


def test_pano_val_gt_mode(ckpt, tmp_path, rng, monkeypatch):
    """--img_folder - : the pano val split with GT fields in the pickles
    and GT-vs-predicted horizons; the split and GT the reference reads."""
    from spec_tpu.cli.camcalib_demo import _pano_val_inputs as ref_inputs

    root = tmp_path / 'data'
    pano = root / 'dataset_folders' / 'pano360'
    img_dir = pano / 'images'
    img_dir.mkdir(parents=True)
    names = []
    for i in range(4):
        nm = f'crop{i}.jpg'
        cv2.imwrite(str(img_dir / nm),
                    (rng.rand(64, 80, 3) * 255).astype('u1'))
        with open(img_dir / f'crop{i}.json', 'w') as f:
            json.dump({'vfov': 1.0 + 0.1 * i, 'pitch': 0.05 * i - 0.1,
                       'roll': 0.02 * i - 0.05}, f)
        names.append(nm)
    joblib.dump(names[:2], pano / 'train_images.pkl')
    joblib.dump(names[2:], pano / 'val_images.pkl')
    monkeypatch.setenv('SPEC_DATA_ROOT', str(root))
    assert TDemo._pano_val_inputs() == ref_inputs()

    out = tmp_path / 'cc_out'
    TDemo.main(['--img_folder', '-', '--out_folder', str(out),
                '--backbone', 'resnet18', '--batch_size', '2',
                '--min_size', str(MIN_SIZE), '--ckpt', ckpt,
                '--device', 'cpu'])
    pkls = sorted(out.glob('*.pkl'))
    assert len(pkls) == 2     # the val split only
    res = joblib.load(pkls[0])
    assert {'vfov', 'f_pix', 'pitch', 'roll', 'gt_vfov', 'gt_f_pix',
            'gt_pitch', 'gt_roll'} <= set(res)
    assert np.isclose(res['gt_vfov'], 1.2, atol=1e-6)      # crop2.json
    assert np.isclose(res['gt_f_pix'], 32 / np.tan(0.6), rtol=1e-6)
    assert len(sorted(out.glob('*.jpg'))) == 2


def test_show_distributions_and_model_cache(ckpt, tmp_path, rng):
    """--show writes a distribution plot per image; repeated runs reuse
    the cached model and stage graph."""
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    cv2.imwrite(str(img_dir / 'a.png'),
                (rng.rand(64, 64, 3) * 255).astype('u1'))
    first = TDemo._get_model(ckpt, 'resnet18', 'softargmax_l2', 'cpu')
    TDemo.main(['--img_folder', str(img_dir), '--out_folder',
                str(tmp_path / 'o'), '--backbone', 'resnet18',
                '--min_size', str(MIN_SIZE), '--ckpt', ckpt, '--show',
                '--device', 'cpu'])
    assert (tmp_path / 'o' / 'a.png_dist.png').exists()
    assert (tmp_path / 'o' / 'a.png').exists()
    again = TDemo._get_model(ckpt, 'resnet18', 'softargmax_l2',
                             torch.device('cpu'))
    assert again[1] is first[1]


def test_main_needs_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        TDemo.main(['--img_folder', str(tmp_path), '--out_folder',
                    str(tmp_path / 'o')])
    assert 'device cpu' in str(e.value)
    assert not (tmp_path / 'o').exists()
