"""The port's eval CLIs against the JAX package's, on the CPU:
``spec_eval`` end to end on tests/test_goldens.py's eval fixture (placed
under a data root as the registry expects it), ``compute_error`` on the
results pickle that run dumps, ``annotate_camcalib``'s npz columns, each
parser's flags (read from the reference's source with ``ast``, the
no-op cluster flags of ``_compat`` included), the no-card exit and the
options that are not ported yet.

Weights: the JAX package's PRNGKey(0) inits (what its CLIs use without a
checkpoint), carried to the port as torch checkpoint files by the
weight bridge. Limits: metrics within 0.05 mm; CamCalib angles within
1e-4 rad and f_pix within 0.05 px (tests/test_torch_serving.py's camera
limits).
"""

import ast
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from spec_tpu_torch.cli import annotate_camcalib as TAnnotate
from spec_tpu_torch.cli import compute_error as TCompute
from spec_tpu_torch.cli import spec_eval as TEval
from tests.test_goldens import _write_eval_fixture

REPO = pathlib.Path(__file__).resolve().parents[1]
METRIC_MM = 0.05


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
def data_root(tmp_path_factory):
    """A data root holding the eval fixture as the registry's
    3dpw-test-cam (annotations and images), with gender and GT camera
    rotations added, and a torch checkpoint of the JAX spec_eval's
    random-init HMR."""
    from tests.test_torch_eval_golden import golden_weights

    root = tmp_path_factory.mktemp('data')
    annot, img_dir = _write_eval_fixture(str(root / 'fixture'))
    extras = root / 'dataset_extras'
    extras.mkdir()
    data = dict(np.load(annot))
    data['gender'] = np.array(['m', 'f', 'f', 'm'])
    rng = np.random.RandomState(9)
    data['cam_rotmat'] = np.stack([np.linalg.qr(rng.randn(3, 3))[0]
                                   for _ in range(4)]).astype('f4')
    np.savez(extras / '3dpw_test_cam_camcalib.npz', **data)
    shutil.copytree(img_dir, root / 'dataset_folders' / '3dpw')
    torch.save(dict(golden_weights()), root / 'hmr_r18.pt')
    return root


def _cfg(tmp_path, batch_size=2):
    path = tmp_path / 'eval.yaml'
    path.write_text(
        'HMR:\n  BACKBONE: resnet18\n'
        f'DATASET:\n  BATCH_SIZE: {batch_size}\n  NUM_WORKERS: 1\n'
        '  VAL_DS: 3dpw-test-cam\n')
    return str(path)


def _logdir(log_root):
    (path,) = pathlib.Path(log_root).glob('spec_eval/spec/*')
    return path


@pytest.fixture(scope='module')
def eval_runs(data_root, tmp_path_factory):
    """spec_eval of both packages on the same data, flags and weights."""
    from spec_tpu.cli.spec_eval import main as ref_main

    old = os.environ.get('SPEC_DATA_ROOT')
    os.environ['SPEC_DATA_ROOT'] = str(data_root)
    try:
        out = {}
        for name, main, extra in (
                ('ref', ref_main, []),
                ('port', TEval.main, ['--ckpt', str(data_root / 'hmr_r18.pt'),
                                      '--device', 'cpu'])):
            tmp = tmp_path_factory.mktemp(name)
            res = main(['--cfg', _cfg(tmp), '--log_root', str(tmp / 'logs'),
                        '--opts', 'DATASET.USE_GENDER', 'True'] + extra)
            out[name] = (res, _logdir(tmp / 'logs'))
        return out
    finally:
        if old is None:
            os.environ.pop('SPEC_DATA_ROOT')
        else:
            os.environ['SPEC_DATA_ROOT'] = old


def _assert_metrics_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_MM, (k, got[k], want[k])


def test_spec_eval_matches_reference(eval_runs):
    (want, ref_dir), (got, port_dir) = eval_runs['ref'], eval_runs['port']
    assert set(got) == set(want) == {'3dpw-test-cam'}
    _assert_metrics_close(got['3dpw-test-cam'], want['3dpw-test-cam'])
    assert 'headline_PA-MPJPE' in got['3dpw-test-cam']
    for name in ('evaluation_results_3dpw-test-cam.pkl',
                 'val_accuracy_results_3dpw-test-cam.json',
                 'config_to_run.yaml'):
        assert (port_dir / name).exists(), name
    history = json.loads(
        (port_dir / 'val_accuracy_results_3dpw-test-cam.json').read_text())
    assert history == [got['3dpw-test-cam']]


def test_compute_error_cli_matches_reference(eval_runs, data_root,
                                             monkeypatch):
    from spec_tpu.cli.compute_error import main as ref_main

    monkeypatch.setenv('SPEC_DATA_ROOT', str(data_root))
    pkl = str(eval_runs['port'][1] / 'evaluation_results_3dpw-test-cam.pkl')
    want = ref_main(['--results_file', pkl])
    got = TCompute.main(['--results_file', pkl, '--device', 'cpu'])
    assert got.pop('protocol') == want.pop('protocol') == 'j14'
    _assert_metrics_close(got, want)
    log = pkl.replace('.pkl', '_analysis.log')
    assert len(pathlib.Path(log).read_text().splitlines()) == 2


def test_annotate_camcalib_matches_reference(data_root, tmp_path):
    import jax
    import jax.numpy as jnp

    from spec_tpu.cli.annotate_camcalib import annotate_npz as ref_annotate
    from spec_tpu.models import CameraRegressorNetwork
    from spec_tpu_torch.utils.checkpoints import state_dict_from_flax

    variables = CameraRegressorNetwork(backbone='resnet18',
                                       num_fc_layers=1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    ckpt = str(tmp_path / 'camcalib_r18.pt')
    torch.save(dict(state_dict_from_flax(variables, 'camcalib', 'resnet18')),
               ckpt)
    npz = str(data_root / 'dataset_extras' / '3dpw_test_cam_camcalib.npz')
    img_dir = str(data_root / 'dataset_folders' / '3dpw')
    kw = dict(ckpt=ckpt, backbone='resnet18', min_size=64, batch_size=2)
    want = ref_annotate(npz, img_dir, str(tmp_path / 'ref.npz'), **kw)
    TAnnotate.main(['--npz', npz, '--img_dir', img_dir, '--out',
                    str(tmp_path / 'port.npz'), '--ckpt', ckpt,
                    '--backbone', 'resnet18', '--min_size', '64',
                    '--batch_size', '2', '--device', 'cpu'])
    got = dict(np.load(tmp_path / 'port.npz'))
    assert set(got) == set(want)
    for k in want:
        if not k.startswith('camcalib_'):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, limit in (('camcalib_vfov', 1e-4), ('camcalib_pitch', 1e-4),
                     ('camcalib_roll', 1e-4), ('camcalib_f_pix', 0.05)):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=limit,
                                   err_msg=k)


def _reference_flags(*modules, calls=('add_argument',)):
    """{flag: (default, store_true)} of the add_argument calls in the
    given reference modules' source."""
    out = {}
    for mod in modules:
        tree = ast.parse((REPO / mod).read_text())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, 'attr', '') in calls):
                continue
            name = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            store_true = ('action' in kw and ast.literal_eval(kw['action'])
                          == 'store_true')
            default = (False if store_true else
                       ast.literal_eval(kw['default']) if 'default' in kw
                       else None)
            out[name] = (default, store_true)
    return out


def _port_flags(parser):
    out = {}
    for a in parser._actions:
        for opt in a.option_strings:
            if opt.startswith('--'):
                out[opt] = (a.default, a.nargs == 0 and a.const is True)
    return out


@pytest.mark.parametrize('cli', ['spec_eval', 'compute_error',
                                 'annotate_camcalib'])
def test_flags_match_reference(cli):
    modules = [f'spec_tpu/cli/{cli}.py']
    if cli == 'spec_eval':
        modules.append('spec_tpu/cli/_compat.py')
    want = _reference_flags(*modules)
    if cli == 'spec_eval':
        # the reference adds --num_gpus only for add_cluster_flags(parser,
        # num_gpus=True), which its trainer passes and spec_eval does not
        assert 'add_cluster_flags(parser)' in (
            REPO / 'spec_tpu/cli/spec_eval.py').read_text()
        want.pop('--num_gpus')
    got = _port_flags({'spec_eval': TEval, 'compute_error': TCompute,
                       'annotate_camcalib': TAnnotate}[cli].build_parser())
    # spec_eval also takes --dist_backend, the process group's backend
    extra = {'--dist_backend'} if cli == 'spec_eval' else set()
    assert set(got) - set(want) == {'--help', '--device'} | extra
    for flag, (default, store_true) in want.items():
        assert got[flag] == (default, store_true), flag
    assert got['--device'][0] == 'cuda'


@pytest.mark.parametrize('cli', ['spec_eval', 'compute_error',
                                 'annotate_camcalib'])
def test_needs_a_card_unless_asked(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    main = {'spec_eval': TEval, 'compute_error': TCompute,
            'annotate_camcalib': TAnnotate}[cli].main
    argv = {'spec_eval': ['--log_root', str(tmp_path)],
            'compute_error': ['--results_file', 'x.pkl'],
            'annotate_camcalib': ['--npz', 'x.npz', '--img_dir', '.']}[cli]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code not in (0, None) and 'device cpu' in str(e.value)
    assert not (tmp_path / 'spec_eval').exists()


def test_unported_flags_and_checkpoints_raise(data_root, tmp_path,
                                              monkeypatch):
    # --data_parallel and the multi-process flags are ported: a
    # coordinator needs its world, and the batch must divide the mesh
    with pytest.raises(ValueError, match='--num_processes'):
        TEval.main(['--coordinator_address', 'localhost:1234',
                    '--device', 'cpu'])
    monkeypatch.setenv('SPEC_DATA_ROOT', str(data_root))
    from spec_tpu_torch import parallel as par
    with monkeypatch.context() as m:
        m.setattr(par, 'create_mesh',
                  lambda devices=None, device=None: [torch.device('cpu')] * 3)
        with pytest.raises(SystemExit, match='multiple of the 3-device'):
            TEval.main(['--cfg', _cfg(tmp_path), '--log_root',
                        str(tmp_path / 'logs'), '--data_parallel',
                        '--device', 'cpu'])
    orbax_dir = tmp_path / 'checkpoints'
    (orbax_dir / 'step_00000010').mkdir(parents=True)
    with pytest.raises(ValueError, match='orbax'):
        TEval.main(['--cfg', _cfg(tmp_path), '--log_root',
                    str(tmp_path / 'logs'), '--ckpt', str(orbax_dir),
                    '--device', 'cpu'])


def test_help_runs_and_names_the_unported_items(capsys, monkeypatch):
    monkeypatch.setenv('COLUMNS', '200')
    with pytest.raises(SystemExit) as e:
        TEval.main(['--help'])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for phrase in ('--device', '--data_parallel', '--coordinator_address',
                   '--dist_backend', '--cluster'):
        assert phrase in text, phrase


def test_pred_rotmats_match_reference(data_root):
    from spec_tpu.cli.spec_eval import _pred_rotmats as ref
    from spec_tpu.data.cam_dataset import CamDataset as JaxCamDataset
    from spec_tpu_torch.data.cam_dataset import CamDataset

    npz = str(data_root / 'dataset_extras' / '3dpw_test_cam_camcalib.npz')
    img_dir = str(data_root / 'dataset_folders' / '3dpw')
    np.testing.assert_array_equal(
        TEval._pred_rotmats(CamDataset(npz, img_dir, '3dpw-test-cam')),
        ref(JaxCamDataset(npz, img_dir, '3dpw-test-cam',
                          native_decode=False)))
