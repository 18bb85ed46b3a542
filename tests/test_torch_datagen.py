"""spec_tpu_torch.datagen and cli/prepare_data on the CPU, held to
spec_tpu.datagen and spec_tpu.cli.prepare_data on the same inputs: the
projection and the camera draws identical, the Pano360 generators'
splits, JSONs and crops identical (crops within one uint8 level), the
AGORA merge's npz identical, and the synthetic SPEC set at n = 3, 96x128
within stated limits (its SMPL through the port's K1 op, the plain
version here). The Flickr downloader runs with the network mocked.
"""

import json
import os
import types

import cv2
import joblib
import numpy as np
import pytest
import torch

from spec_tpu import datagen as JD
from spec_tpu_torch import datagen as TD

# spec_synth: the port's SMPL is K1's plain version (fp32 einsums), the
# JAX package's its plain jnp LBS; both fp32.
SYNTH_M = 1e-5       # 3D joints, m
SYNTH_PX = 1e-3      # 2D joints, bbox centers, px
SYNTH_SCALE = 1e-5   # bbox scale (max side / 200)
# frames: a vertex moved by ~1e-6 m can flip a pixel on a mesh edge
SYNTH_PIXEL_SHARE = 5e-3


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: under a parallel test run (several workers
    sharing the cores) every parallel region's barrier waits on
    descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def pano_dir(tmp_path_factory):
    """Three small structured panoramas (jpg)."""
    d = tmp_path_factory.mktemp('panos')
    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[:96, :192].astype(np.float32)
    for i in range(3):
        img = np.stack([xx * 255 / 192, yy * 255 / 96,
                        127 + 100 * np.sin(xx / (9 + i))], -1)
        img = img + rng.randn(96, 192, 3) * 10
        cv2.imwrite(str(d / f'p{i}.jpg'),
                    np.clip(img, 0, 255).astype(np.uint8))
    return sorted(str(p) for p in d.glob('*.jpg'))


def test_projection_and_horizon_batch_identical(rng):
    pano = (rng.rand(64, 128, 3) * 255).astype(np.uint8)
    for vfov, pitch, roll, yaw in ((1.0, 0.2, -0.1, 0.5),
                                   (0.4, -0.3, 0.05, 3.0)):
        np.testing.assert_array_equal(
            TD.camera_rays(20, 30, vfov), JD.camera_rays(20, 30, vfov))
        np.testing.assert_array_equal(
            TD.rotation_from_angles(pitch, roll, yaw),
            JD.rotation_from_angles(pitch, roll, yaw))
        np.testing.assert_array_equal(
            TD.equirect_to_perspective(pano, vfov, pitch, roll, yaw,
                                       (24, 40)),
            JD.equirect_to_perspective(pano, vfov, pitch, roll, yaw,
                                       (24, 40)))
    from spec_tpu.datagen import synthetic as JS
    from spec_tpu_torch.datagen import synthetic as TS

    for a, b in zip(TS.render_horizon_batch(np.random.RandomState(1), 3,
                                            (16, 24)),
                    JS.render_horizon_batch(np.random.RandomState(1), 3,
                                            (16, 24))):
        np.testing.assert_array_equal(a, b)


def test_camera_draws_identical():
    """The same RandomState draws in the same order: 200 cameras of each
    recipe equal the JAX package's, key for key."""
    for sample_t, sample_j in ((TD.sample_cam_params, JD.sample_cam_params),
                               (TD.sample_scalenet_cam,
                                JD.sample_scalenet_cam)):
        rt, rj = np.random.RandomState(3), np.random.RandomState(3)
        for _ in range(200):
            assert sample_t(rt) == sample_j(rj)


def _read_tree(root):
    """{relative path: json object, decoded image or joblib list}."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            if f.endswith('.json'):
                out[rel] = json.load(open(p))
            elif f.endswith('.jpg'):
                out[rel] = cv2.imread(p)
            elif f.endswith('.pkl'):
                out[rel] = joblib.load(p)
            else:
                out[rel] = open(p, 'rb').read()
    return out


def _assert_trees_match(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape, k
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16)).max()
            assert diff <= 1, (k, diff)
        else:
            assert g == w, k


def test_pano_preprocessing_matches_jax(pano_dir, tmp_path):
    """Recipe v2 over three panoramas: the same splits and annotations,
    crops within one uint8 level; then the AGORA merge of that output
    writes the same npz files."""
    from spec_tpu.datagen import pano_preprocessing as JP
    from spec_tpu_torch.datagen import pano_preprocessing as TP

    crops = {}

    def writer(tag):
        def write(img, path):
            crops[tag, os.path.basename(path)] = img
        return write

    outs = {}
    for tag, mod in (('port', TP), ('jax', JP)):
        outs[tag] = str(tmp_path / tag)
        splits = mod.preprocess_calib_data(
            pano_dir, outs[tag], crops_per_pano=3, seed=5, val_ratio=0.34,
            writer=writer(tag), workers=2)
        assert len(splits['train_images']) == 6
        assert len(splits['val_images']) == 3
    _assert_trees_match(_read_tree(outs['port']), _read_tree(outs['jax']))
    names = sorted(n for t, n in crops if t == 'jax')
    assert names == sorted(n for t, n in crops if t == 'port')
    for n in names:
        a = crops['port', n].astype(np.int16)
        b = crops['jax', n].astype(np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, n

    from spec_tpu.datagen import pano_agora as JA
    from spec_tpu_torch.datagen import pano_agora as TA

    agora = {f'agora/img_{i}.png': {'pitch': 0.1 * i, 'roll': -0.02 * i,
                                    'focal': 1000.0 + 50 * i}
             for i in range(5)}
    for tag, mod in (('port', TA), ('jax', JA)):
        assert mod.merge_pano_agora(outs[tag], agora,
                                    str(tmp_path / f'merged_{tag}'),
                                    val_ratio=0.2, seed=2) == 14
    for split in ('train', 'val'):
        a = np.load(tmp_path / 'merged_port'
                    / f'pano_agora_dataset_{split}.npz')
        b = np.load(tmp_path / 'merged_jax'
                    / f'pano_agora_dataset_{split}.npz')
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_scalenet_cli_matches_jax(pano_dir, tmp_path):
    """The ScaleNet recipe's CLI (two crops a panorama, debug overlays
    through the port's draw_horizon_line): the same files, JSONs and
    splits, images within one uint8 level."""
    from spec_tpu.datagen import scalenet as JN
    from spec_tpu_torch.datagen import scalenet as TN

    src = os.path.dirname(pano_dir[0])
    for tag, mod in (('port', TN), ('jax', JN)):
        mod.main([src, str(tmp_path / tag), '--crops_per_pano', '2',
                  '--seed', '3', '--debug', '--workers', '2'])
    got = _read_tree(str(tmp_path / 'port'))
    assert any(k.startswith('debug') for k in got)
    _assert_trees_match(got, _read_tree(str(tmp_path / 'jax')))


def test_spec_synth_matches_jax(tmp_path):
    """The synthetic SPEC set at n = 3, 96x128, f_pix 160: the installed
    SMPL files byte for byte, the parameter columns identical, the
    label columns within SYNTH_M / SYNTH_PX / SYNTH_SCALE, the frames
    differing in at most SYNTH_PIXEL_SHARE of their pixels (by more than
    one uint8 level); K1's op ran (no kernel launch on the CPU), and
    the in-memory writer received the frames that were written."""
    from spec_tpu.datagen import spec_synth as JY
    from spec_tpu_torch.datagen import spec_synth as TY
    from spec_tpu_torch.ops import lbs as L

    kw = dict(dataset='spec-mtp', n=3, seed=4, hw=(96, 128), f_pix=160.0)
    roots = {tag: str(tmp_path / tag) for tag in ('port', 'jax', 'mem')}
    before = L.LAUNCHES
    timings = {}
    npz_t = TY.render_spec_synth_dataset(roots['port'], device='cpu',
                                         timings=timings, **kw)
    assert L.LAUNCHES == before and set(timings) == {'smpl_s', 'render_s'}
    npz_j = JY.render_spec_synth_dataset(roots['jax'], **kw)
    assert os.path.basename(npz_t) == os.path.basename(npz_j)

    for rel in ('body_models/smpl/SMPL_NEUTRAL.pkl',
                'J_regressor_extra.npy', 'J_regressor_h36m.npy'):
        with open(os.path.join(roots['port'], rel), 'rb') as a, \
                open(os.path.join(roots['jax'], rel), 'rb') as b:
            assert a.read() == b.read(), rel

    t, j = np.load(npz_t), np.load(npz_j)
    assert sorted(t) == sorted(j)
    limits = {'S': SYNTH_M, 'part': SYNTH_PX, 'openpose': SYNTH_PX,
              'center': SYNTH_PX, 'scale': SYNTH_SCALE}
    for k in j:
        if k in limits:
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=limits[k],
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)

    frames = {}
    TY.render_spec_synth_dataset(
        roots['mem'], device='cpu',
        writer=lambda img, path, q: frames.update({path: img}), **kw)
    folder = os.path.join('dataset_folders', 'spec-mtp')
    for name in j['imgname']:
        a = cv2.imread(os.path.join(roots['port'], folder, str(name)))
        b = cv2.imread(os.path.join(roots['jax'], folder, str(name)))
        assert a.shape == b.shape == (96, 128, 3)
        share = (np.abs(a.astype(np.int16) - b).max(-1) > 1).mean()
        assert share <= SYNTH_PIXEL_SHARE, (name, share)
        mem = frames[os.path.join(roots['mem'], folder, str(name))]
        assert mem.dtype == np.uint8 and mem.shape == (96, 128, 3)
        enc = cv2.imdecode(cv2.imencode(
            '.jpg', cv2.cvtColor(mem, cv2.COLOR_RGB2BGR),
            [cv2.IMWRITE_JPEG_QUALITY, 95])[1], cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(enc, a)


def test_spec_synth_cli_needs_a_card_unless_asked(tmp_path, monkeypatch):
    from spec_tpu_torch.datagen import spec_synth as TY

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        TY.main([str(tmp_path / 'r'), '--n', '1'])
    assert e.value.code not in (0, None) and 'device cpu' in str(e.value)
    assert not (tmp_path / 'r').exists()


def test_flickr_downloader_with_the_network_mocked(tmp_path, monkeypatch):
    """A missing API key fails fast; the CLI's three download modes run
    against a mocked REST API and a mocked requests module."""
    from spec_tpu_torch.datagen import flickr as fl

    monkeypatch.delenv('FLICKR_API_KEY', raising=False)
    with pytest.raises(RuntimeError, match='FLICKR_API_KEY'):
        fl.FlickrDownloader(out_folder=str(tmp_path / 'o'))

    monkeypatch.setenv('FLICKR_API_KEY', 'test-key')
    calls = []

    def fake_call(self, method, **params):
        calls.append((method, params))
        if method in ('flickr.photos.search',
                      'flickr.groups.pools.getPhotos'):
            prefix = 'tag' if method == 'flickr.photos.search' else 'grp'
            page = params['page']
            return {'photos': {'photo': [{'id': f'{prefix}{page}'}]
                               if page == 1 else []}}
        if method == 'flickr.photos.getSizes':
            return {'sizes': {'size': [
                {'label': 'Large', 'source': 'http://x/l.jpg'},
                {'label': 'Original', 'source': 'http://x/o.jpg'}]}}
        if method == 'flickr.photos.getExif':
            return {'photo': {'camera': 'testcam'}}
        raise AssertionError(method)

    class FakeResp:
        content = b'JPEGDATA'

        def raise_for_status(self):
            pass

    monkeypatch.setattr(fl.FlickrDownloader, '_call', fake_call)
    monkeypatch.setitem(__import__('sys').modules, 'requests',
                        types.SimpleNamespace(get=lambda url, **kw:
                                              FakeResp()))
    out = tmp_path / 'imgs'
    fl.main(['--download_type', 'tag', '--tag', 'people',
             '--out_folder', str(out), '--max_pages', '3'])
    assert (out / 'tag1.jpg').read_bytes() == b'JPEGDATA'
    assert json.load(open(out / 'tag1_exif.json')) == {'camera': 'testcam'}
    fl.main(['--download_type', 'group', '--group_id', 'g1',
             '--out_folder', str(out)])
    assert (out / 'grp1.jpg').exists()
    ids = tmp_path / 'ids.npy'
    np.save(ids, np.array(['42']))
    fl.main(['--download_type', 'ids', '--id_file', str(ids),
             '--out_folder', str(out)])
    assert (out / '42.jpg').exists()
    assert [p['page'] for m, p in calls
            if m == 'flickr.photos.search'] == [1, 2]
    with pytest.raises(SystemExit):
        fl.main(['--download_type', 'group', '--out_folder', str(out)])


def test_prepare_data_verify_matches_jax(tmp_path, monkeypatch, capsys):
    """verify() reports the same assets present and missing, at the same
    paths, as the JAX package's, and prints one line per asset."""
    from spec_tpu.cli.prepare_data import verify as jax_verify
    from spec_tpu_torch.cli.prepare_data import verify

    root = tmp_path / 'data'
    (root / 'dataset_extras').mkdir(parents=True)
    (root / 'dataset_extras' / '3dpw_test_cam_camcalib.npz').write_bytes(
        b'x')
    (root / 'smpl_mean_params.npz').write_bytes(b'x')
    monkeypatch.setenv('SPEC_DATA_ROOT', str(root))
    status = verify()
    printed = capsys.readouterr().out
    assert status == jax_verify()
    assert status['3dpw-test-cam annots'][0] is True
    assert status['SMPL mean params'][0] is True
    assert status['SPEC checkpoint'][0] is False
    assert '2/9 assets present' in printed
