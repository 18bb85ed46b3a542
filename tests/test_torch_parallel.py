"""spec_tpu_torch's data-parallel layer (``parallel/``) in one process on
the CPU, against spec_tpu's and against the port's plain path.

* The loader's process slices (``check_process_divisibility``,
  ``shard_index_chunk``, ``DataLoader(process_id=...)``) equal
  ``spec_tpu.data.loader``'s on the inputs of
  ``tests/test_multiprocess.py::test_loader_process_sharding_partitions_
  batches``.
* ``SpecPredictor``'s ``_min_pad``, ``_min_pad_s1`` and ``_padded`` equal
  the JAX predictor's on meshes of 1, 2 and 8 devices.
* With the device-list seam (``parallel.create_mesh``) standing for 8
  CPU devices, ``data_parallel`` predict, the eval step and
  ``evaluate_dataset``, and the detector equal the port's plain path
  within 1e-5 (fp32; each replica gets one row, the plain path all of
  them, so only the convolutions' batch-dependent rounding differs).
* The layouts' ``ValueError``s (an indivisible batch, both layouts at
  once; ``tests/test_parallel_infer.py``), the FSDP/HSDP meshes and leaf
  rule (item 12c), and the collectives' no-ops in one process; ``SpecPredictor``'s pads under ``spatial_parallel`` too (the
  layout itself is tests/test_torch_spatial.py's).
* ``fsdp_shardings`` on every leaf of a ResNet-18 CamCalib and HMR
  state shards the leaves ``spec_tpu.parallel.fsdp_shardings`` shards,
  along an axis of the same size, over 2 and 8 ranks and a (4, 2)
  hybrid mesh (leaves matched by name through ``state_dict_from_flax``).
* The test seam ``force_global_reductions``: with a one-rank gloo group
  the SPEC step takes the multi-rank branches and still computes the
  plain step.

The multi-process half is ``tests/test_torch_multiprocess.py``.
"""

import jax
import numpy as np
import pytest
import torch

from spec_tpu_torch import parallel as par
from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.data import loader as TLoader

TOL = 1e-5
N_DEV = 8
CPU8 = [torch.device('cpu')] * N_DEV


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: whole models under a parallel test run (see
    tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def eight_devices(monkeypatch):
    """The seam: ``create_mesh`` gives 8 CPU devices."""
    monkeypatch.setattr(par, 'create_mesh',
                        lambda devices=None, device=None: list(CPU8))


class _Idx:
    def __len__(self):
        return 22

    def __getitem__(self, i):
        return {'i': np.int64(i)}


@pytest.mark.parametrize('shuffle', [True, False])
def test_loader_slices_match_jax(shuffle):
    from spec_tpu.data import loader as JLoader

    for count in (1, 2, 4):
        for pid in range(count):
            kw = dict(batch_size=8, shuffle=shuffle, seed=3, num_workers=1,
                      process_id=pid, process_count=count)
            got = [(b['i'], b['_valid_count'])
                   for b in TLoader.DataLoader(_Idx(), **kw)]
            want = [(b['i'], b['_valid_count'])
                    for b in JLoader.DataLoader(_Idx(), **kw)]
            assert len(got) == len(want) == 3
            for (gi, gv), (wi, wv) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                assert gv == wv
    for chunk in ([3, 1, 4], list(range(8)), [5]):
        for count in (1, 2, 4, 8):
            for pid in range(count):
                g = TLoader.shard_index_chunk(chunk, 8, pid, count)
                w = JLoader.shard_index_chunk(chunk, 8, pid, count)
                np.testing.assert_array_equal(g[0], w[0])
                assert g[1] == w[1]
    for bs, count in ((6, 4), (8, 3), (8, 8)):
        try:
            want = JLoader.check_process_divisibility(bs, count)
        except ValueError:
            with pytest.raises(ValueError, match='divide evenly'):
                TLoader.check_process_divisibility(bs, count)
            with pytest.raises(ValueError, match='divide evenly'):
                TLoader.DataLoader(_Idx(), batch_size=bs,
                                   process_count=count)
        else:
            assert TLoader.check_process_divisibility(bs, count) == want


@pytest.mark.parametrize('n_dev', [1, 2, 8])
def test_padding_matches_jax_predictor(n_dev, monkeypatch, tmp_path):
    _hold_padding(n_dev, monkeypatch, tmp_path, data_parallel=True)


def _hold_padding(n_dev, monkeypatch, tmp_path, **layout):
    """The port's pads equal the JAX predictor's under ``layout`` on a
    mesh of ``n_dev`` devices."""
    import spec_tpu.parallel as jpar
    from spec_tpu.serving import SpecPredictor as JaxPredictor
    from spec_tpu_torch.serving import SpecPredictor

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path))
    kw = dict(backbone='resnet18', camcalib_backbone='resnet18',
              batch_size=8, min_size=64, **layout)
    jmesh = jpar.create_mesh
    monkeypatch.setattr(jpar, 'create_mesh',
                        lambda devices=None, axis_name='data':
                        jmesh(jax.devices()[:n_dev]))
    monkeypatch.setattr(par, 'create_mesh',
                        lambda devices=None, device=None: CPU8[:n_dev])
    jp = JaxPredictor(use_fused_lbs=False, **kw)
    tp = SpecPredictor(device='cpu', **kw)
    s1 = 1 if layout.get('spatial_parallel') else n_dev
    assert (tp._min_pad, tp._min_pad_s1) == (jp._min_pad, jp._min_pad_s1) \
        == (n_dev, s1)
    for n in range(1, 20):
        for mult in (None, 1, n_dev):
            assert tp._padded(n, mult) == jp._padded(n, mult), (n, mult)
    if layout.get('spatial_parallel'):
        assert tp._stage1.mesh == CPU8[:n_dev]
    else:
        assert len(tp._stage1.stages if n_dev > 1 else [tp._stage1]) == \
            n_dev


@pytest.mark.parametrize('n_dev', [1, 2, 8])
def test_spatial_padding_matches_jax_predictor(n_dev, monkeypatch,
                                               tmp_path):
    """test_padding_matches_jax_predictor under spatial_parallel: stage 1
    pads for no mesh (it splits rows), stage 2 for the device count."""
    _hold_padding(n_dev, monkeypatch, tmp_path, spatial_parallel=True)


def _frames_and_boxes(seed):
    rng = np.random.RandomState(seed)
    frames = [(rng.rand(64, 96, 3) * 255).astype(np.uint8) for _ in range(3)]
    frames.append((rng.rand(80, 96, 3) * 255).astype(np.uint8))
    boxes = [np.array([[40., 30., 40., 40.]], 'f4'),
             np.zeros((0, 4), 'f4'),
             np.array([[30., 30., 30., 50.], [60., 40., 30., 30.]], 'f4'),
             np.array([[50., 40., 60., 60.]], 'f4')]
    return frames, boxes


def _hold(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _hold(got[k], want[k], f'{what} {k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _hold(g, w, f'{what}[{i}]')
    elif isinstance(want, (torch.Tensor, np.ndarray)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=what)


def test_data_parallel_predict_matches_plain(eight_devices, tmp_path,
                                             monkeypatch):
    from spec_tpu_torch.serving import SpecPredictor

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path))
    kw = dict(backbone='resnet18', camcalib_backbone='resnet18',
              batch_size=8, min_size=64, device='cpu')
    plain = SpecPredictor(**kw)
    dp = SpecPredictor(data_parallel=True, **kw)
    assert len(dp._stage1.stages) == len(dp._stage2.stages) == N_DEV
    # every replica holds the plain predictor's weights
    for stage in dp._stage2.stages[1:]:
        for k, v in stage.fn.spec.state_dict().items():
            torch.testing.assert_close(v, plain.spec.state_dict()[k],
                                       rtol=0, atol=0)
    frames, boxes = _frames_and_boxes(0)
    want, want_cams = plain.predict(frames, boxes, return_cameras=True)
    got, got_cams = dp.predict(frames, boxes, return_cameras=True)
    _hold(got_cams, want_cams, 'cameras')
    assert [len(r) for r in got] == [1, 0, 2, 1]
    for fi, (g, w) in enumerate(zip(got, want)):
        for pi, (gp, wp) in enumerate(zip(g, w)):
            gp, wp = dict(gp), dict(wp)
            _hold(gp.pop('camera'), wp.pop('camera'), 'camera')
            _hold(gp, wp, f'frame {fi} person {pi}')


def _eval_batch(seed, B):
    rng = np.random.RandomState(seed)
    K = np.tile(np.array([[300., 0., 80.], [0., 300., 60.], [0., 0., 1.]],
                         'f4'), (B, 1, 1))
    return {
        'img': rng.rand(B, 64, 64, 3).astype('f4'),
        'pose': (rng.randn(B, 72) * 0.2).astype('f4'),
        'betas': (rng.randn(B, 10) * 0.5).astype('f4'),
        'gender': (rng.rand(B) > 0.5).astype(np.int32),
        'scale': (rng.rand(B) * 0.3 + 0.5).astype('f4'),
        'center': (rng.rand(B, 2) * 40 + 60).astype('f4'),
        'orig_shape': np.tile(np.array([[120., 160.]], 'f4'), (B, 1)),
        'cam_rotmat': np.tile(np.eye(3, dtype='f4'), (B, 1, 1)),
        'cam_intrinsics': K,
    }


class _Loader:
    """Two in-memory eval batches of ``batch_size`` rows (the last with
    5 real ones), as ``evaluate_dataset`` reads them."""

    batch_size = N_DEV

    def __iter__(self):
        for i, valid in enumerate((N_DEV, 5)):
            b = _eval_batch(10 + i, N_DEV)
            b['cam_int'] = b.pop('cam_intrinsics')
            b['imgname'] = [f'{i}_{j}.jpg' for j in range(N_DEV)]
            b['dataset_name'] = ['x'] * N_DEV
            b['_valid_count'] = valid
            yield b


def test_data_parallel_eval_matches_plain():
    from spec_tpu_torch.eval import eval_loop as TL
    from spec_tpu_torch.models.hmr import HMR

    assets = {g: S.create_test_assets(num_vertices=128, seed=i)
              for i, g in enumerate(('neutral', 'male', 'female'))}
    jreg = np.asarray(assets['neutral'].j_regressor_h36m)
    model = HMR(backbone='resnet18', use_cam_feats=True, img_res=64)
    model.reset_parameters(torch.Generator().manual_seed(0))
    plain = TL.make_eval_step(model.eval(), assets, jreg, use_gender=True)
    dp = TL.make_eval_step(model, assets, jreg, use_gender=True, mesh=CPU8)
    assert len(dp.replicas) == N_DEV and dp.replicas[0] is model
    batch = {k: torch.from_numpy(v) for k, v in _eval_batch(3, N_DEV).items()}
    _hold(dp(batch), plain(batch), 'eval step')
    # evaluate_dataset: the replicas take the model's current weights
    with torch.no_grad():
        model.head.fc1.bias.add_(0.01)
    want, _ = TL.evaluate_dataset(model, None, _Loader(), assets, jreg,
                                  use_gt_cam=True, use_gender=True,
                                  save_results=False)
    got, acc = TL.evaluate_dataset(model, None, _Loader(), assets, jreg,
                                   use_gt_cam=True, use_gender=True,
                                   save_results=False, mesh=CPU8)
    assert len(acc.results_dict()['imgname']) == N_DEV + 5
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=1e-3,
                                   err_msg=k)     # mm


def test_data_parallel_detector_matches_plain():
    from spec_tpu_torch.models.detector import YoloDetector

    # 64^2 gives 252 candidates, all kept (topk 256): the outputs are the
    # same set of rows, compared in a fixed order
    kw = dict(img_size=64, batch_size=N_DEV, dtype=torch.float32,
              device='cpu', seed=0)
    plain = YoloDetector(**kw)
    dp = YoloDetector(mesh=CPU8, **kw)
    assert len(dp._fwd.stages) == N_DEV
    x = torch.rand(N_DEV, 64, 64, 3, generator=torch.Generator()
                   .manual_seed(1))
    with torch.inference_mode():
        want, got = plain._fwd(x), dp._fwd(x)
    assert got.shape == want.shape == (N_DEV, 252, 5)

    def ordered(t):
        t = t.numpy()
        return np.stack([r[np.lexsort(r[:, :2].T)] for r in t])

    np.testing.assert_allclose(ordered(got), ordered(want), rtol=TOL,
                               atol=TOL)
    # a tail batch pads to a multiple of the mesh
    frames = [np.zeros((48, 64, 3), np.uint8)] * 3
    (params, dets), = dp.detect_dispatch(frames)
    assert len(params) == 3 and dets.shape[0] == N_DEV


def test_layout_errors_match_jax(eight_devices):
    from spec_tpu_torch.models.detector import YoloDetector
    from spec_tpu_torch.serving import SpecPredictor

    with pytest.raises(ValueError, match='mutually exclusive'):
        SpecPredictor(device='cpu', batch_size=N_DEV, data_parallel=True,
                      spatial_parallel=True)
    with pytest.raises(ValueError, match='multiple'):
        SpecPredictor(device='cpu', batch_size=N_DEV + 1,
                      data_parallel=True)
    with pytest.raises(ValueError, match='multiple'):
        YoloDetector(batch_size=12, mesh=CPU8, device='cpu')
    with pytest.raises(ValueError, match='does not split'):
        par.shard_batch(torch.zeros(12, 2), CPU8)


def test_unported_layouts_name_their_item(eight_devices):
    """FSDP/HSDP (item 12c) and spatial_parallel (item 12b) are ported:
    the FSDP meshes describe ranks as the reference's describe devices
    (and refuse an indivisible group as it does), the leaf rule needs no
    process group; spatial_parallel's sharding names the devices and the
    split dimension, and the predictor splits stage 1 into bands over
    the seam's 8 devices."""
    from spec_tpu_torch.serving import SpecPredictor

    mesh = par.create_hybrid_mesh(range(N_DEV), fsdp=2)
    assert mesh.shape == {'data': 4, 'fsdp': 2}
    assert mesh.ranks.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.shard_axis == 'fsdp' and mesh.shard_group is None
    assert par.create_process_mesh(range(N_DEV)).shape == {'data': N_DEV}
    with pytest.raises(ValueError, match='not divisible by fsdp=3'):
        par.create_hybrid_mesh(range(N_DEV), fsdp=3)
    flat = par.create_process_mesh(range(N_DEV))
    assert par.fsdp_leaf_sharding(flat, (4, 4)) is None        # small
    assert par.fsdp_leaf_sharding(flat, (3, 2 ** 14 + 1)) is None
    sh = par.fsdp_leaf_sharding(mesh, (64, 512, 3, 3))
    assert (sh.dim, sh.count, sh.axis_name) == (1, 2, 'fsdp')
    assert par.fsdp_leaf_sharding(flat, (256, 256)).dim == 0   # first tie
    assert par.fsdp_shardings({}, flat) == {}
    sh = par.spatial_sharding(CPU8)
    assert sh.devices == CPU8 and sh.dim == 1
    pred = SpecPredictor(device='cpu', spatial_parallel=True,
                         backbone='resnet18', camcalib_backbone='resnet18')
    assert isinstance(pred._stage1, par.SpatialStage)
    assert pred._stage1.mesh == CPU8


def _flax_ids(variables):
    """``variables`` with leaf i (in tree order) an array of its shape
    filled with i + 1: after ``state_dict_from_flax``, which only
    transposes and reshapes, each tensor holds the id of its leaf."""
    leaves, tree = jax.tree_util.tree_flatten(variables)
    ids = [np.full(np.shape(x), i + 1, np.float32)
           for i, x in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(tree, ids), leaves


@pytest.mark.parametrize('kind', ['camcalib', 'hmr'])
def test_fsdp_layout_matches_jax(kind):
    """Every leaf of a ResNet-18 CamCalib and HMR state, matched by name
    through ``state_dict_from_flax``: the port's ``fsdp_shardings``
    shards the same leaves as ``spec_tpu.parallel.fsdp_shardings``,
    along an axis of the same size, over 2 and 8 ranks and on a hybrid
    (4, 2) mesh, where nothing shards over the data axis."""
    import spec_tpu.parallel as jpar
    from spec_tpu.models import HMR as JaxHMR
    from spec_tpu.models import CameraRegressorNetwork as JaxCamCalib
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.utils.checkpoints import state_dict_from_flax

    key = jax.random.PRNGKey(0)
    if kind == 'camcalib':
        shapes = jax.eval_shape(
            JaxCamCalib(backbone='resnet18', num_fc_layers=1).init, key,
            jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
        port = CameraRegressorNetwork(backbone='resnet18', num_fc_layers=1)
    else:
        import __graft_entry__ as ge
        from spec_tpu.core import smpl as JS

        jassets = JS.create_test_assets(num_vertices=128)
        args = ge._example_inputs(1, 64, np.random.RandomState(0))
        jmodel = JaxHMR(backbone='resnet18', use_cam=True,
                        use_cam_feats=True)
        shapes = jax.eval_shape(lambda k: jmodel.init(k, jassets, *args),
                                key)
        port = HMR(backbone='resnet18', use_cam_feats=True)
    ids, leaves = _flax_ids(shapes)
    sd = state_dict_from_flax(ids, kind, 'resnet18')
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in port.state_dict().items()}
    owner = {}
    for k, v in sd.items():
        if k.endswith('num_batches_tracked'):
            continue
        leaf = torch.unique(v).tolist()
        assert len(leaf) == 1, k              # one JAX leaf per tensor
        owner[k] = int(leaf[0]) - 1
    assert sorted(set(owner.values())) == list(range(len(leaves)))
    layouts = {'2': (jpar.create_mesh(jax.devices()[:2]),
                     par.create_process_mesh(range(2))),
               '8': (jpar.create_mesh(jax.devices()[:8]),
                     par.create_process_mesh(range(8))),
               '(4, 2)': (jpar.create_hybrid_mesh(jax.devices()[:8], fsdp=2),
                          par.create_hybrid_mesh(range(8), fsdp=2))}
    for name, (jmesh, mesh) in layouts.items():
        jsh = jax.tree_util.tree_leaves(
            jpar.fsdp_shardings(shapes, jmesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        got = par.fsdp_shardings(sd, mesh)
        n_sharded = 0
        for k, i in owner.items():
            spec = tuple(jsh[i].spec) + (None,) * len(leaves[i].shape)
            axes = [d for d in range(len(leaves[i].shape))
                    if spec[d] is not None]
            if not axes:
                assert got[k] is None, (name, k)
                continue
            ax, = axes
            n_sharded += 1
            assert got[k] is not None, (name, k)
            assert sd[k].shape[got[k].dim] == leaves[i].shape[ax], (name, k)
            assert got[k].axis_name == spec[ax] == mesh.shard_axis
            assert got[k].count == jmesh.shape[spec[ax]]
        assert n_sharded > 0, name
        if name == '(4, 2)':
            assert all(s is None or s.axis_name == 'fsdp'
                       for s in got.values())


def test_single_process_helpers(monkeypatch):
    for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    par.initialize_multihost(device='cpu')       # no launcher: one process
    assert not par.is_initialized()
    assert (par.process_index(), par.process_count()) == (0, 1)
    assert par.backend() is None and par.capturable()
    assert par.broadcast_string('logs/run_1') == 'logs/run_1'
    assert par.all_processes_any(True) and not par.all_processes_any(False)
    par.barrier()
    assert par.pad_to_multiple(5, 4) == 8 and par.pad_to_multiple(8, 4) == 8
    assert par.local_device('cpu') == torch.device('cpu')
    assert par.create_mesh(device='cpu') == [torch.device('cpu')]
    with pytest.raises(ValueError, match='--coordinator_address'):
        par.initialize_multihost(num_processes=2, device='cpu')
    # split in order, one part per device; outside a sharded batch the
    # reductions are the local ones
    x = torch.arange(16.).reshape(8, 2)
    parts = par.shard_batch({'x': x}, CPU8[:4])
    assert [p['x'][:, 0].tolist() for p in parts] == [
        [0., 2.], [4., 6.], [8., 10.], [12., 14.]]
    assert par.batch_world() == 1
    with par.sharded_batch():
        assert par.batch_world() == 1           # no process group
        assert par.batch_mean(x) == x.mean()
        assert par.all_reduce_data(x) is x
    assert not par.global_batch()
    with par.force_global_reductions(), pytest.raises(RuntimeError,
                                                      match='process group'):
        with par.sharded_batch():
            pass


def test_forced_global_step_matches_plain():
    """The seam ``force_global_reductions`` with a one-rank gloo group:
    the SPEC step (chip_smoke.py's phase 23 setup at a small size) takes
    the multi-rank branches (BatchNorm's global statistics and the
    losses' global counts, each an all-reduce) and still computes the
    plain step: its losses and model update within phase 23's limits
    (PAR_LOSS_RTOL, PAR_UPDATE_RTOL; bf16 autocast), and each BatchNorm
    running statistic's change within PAR_UPDATE_RTOL of the plain
    step's."""
    import chip_smoke as cs

    dev = torch.device('cpu')
    sizes = dict(B=8, device=dev, backbone='resnet18', res=64, vertices=128)
    plain = cs._par_setup(**sizes)
    batch = {k: torch.from_numpy(v) for k, v in plain[2].items()}
    start = {k: v.clone() for k, v in plain[0].model.state_dict().items()}
    want, _ = cs._par_steps(plain[0], plain[1], batch, cs.PAR_STEPS, dev)
    want_sd = plain[0].model.state_dict()
    par.initialize_multihost(f'127.0.0.1:{cs._free_port()}', 1, 0,
                             backend='gloo', device='cpu')
    calls = []
    all_reduce = torch.distributed.all_reduce
    try:
        state, step, _ = cs._par_setup(**sizes)
        torch.distributed.all_reduce = (
            lambda *a, **k: calls.append(1) or all_reduce(*a, **k))
        with par.force_global_reductions():
            got, _ = cs._par_steps(state, step, batch, cs.PAR_STEPS, dev)
    finally:
        torch.distributed.all_reduce = all_reduce
        torch.distributed.destroy_process_group()
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d)
               for m in state.model.modules())
    # a forward and a backward all-reduce per BatchNorm layer, the losses'
    # counts, the gradients and the metrics, in every step
    assert len(calls) >= cs.PAR_STEPS * (2 * n_bn + 2), (len(calls), n_bn)
    for g, w in zip(got, want):
        for k, v in w.items():
            assert abs(g[k] - v) <= cs.PAR_LOSS_RTOL * max(abs(v), 1e-6), k
    got_sd = state.model.state_dict()
    upd, worst, biggest = cs._update_errors(got_sd, want_sd, start)
    assert upd <= cs.PAR_UPDATE_RTOL, upd
    assert worst <= cs.PAR_UPDATE_RTOL * biggest, (worst, biggest)
    stats = [k for k in want_sd if k.endswith(('running_mean', 'running_var',
                                               'num_batches_tracked'))]
    assert len(stats) == 3 * n_bn
    for k in stats:
        if k.endswith('num_batches_tracked'):
            assert torch.equal(got_sd[k], want_sd[k]), k
            continue
        diff = float((got_sd[k] - want_sd[k]).abs().max())
        moved = float((want_sd[k] - start[k]).abs().max())
        assert diff <= cs.PAR_UPDATE_RTOL * moved, (k, diff, moved)


@pytest.mark.parametrize('layout', ['fsdp', 'hsdp'])
def test_fsdp_step_matches_plain_and_is_capturable(layout):
    """chip_smoke.py's phase 25 (a) and (b) at a small size with a
    one-rank gloo group: the SPEC step with its state laid out over the
    one rank (full-axis, or a (1, 1) hybrid mesh) runs the reduce-scatter,
    the all-gather and, under HSDP, the data group's all-reduce, and
    still computes the plain step (SGD with momentum and the clip: the
    losses within 1e-6 relative, every parameter and slot within 1e-6 of
    the largest update entry: a world of one only reorders the clip's
    sums). After a warm-up its body builds no tensor from host data and
    reads no device value on the host, as a CUDA graph capture needs
    (tests/test_torch_graphs.py)."""
    import chip_smoke as cs
    from tests.test_torch_graphs import _Refuse

    dev = torch.device('cpu')
    sizes = dict(B=8, device=dev, backbone='resnet18', res=64, vertices=128,
                 momentum=cs.FSDP_MOMENTUM)
    plain = cs._par_setup(**sizes)
    batch = {k: torch.from_numpy(v) for k, v in plain[2].items()}
    start = {k: v.clone() for k, v in plain[0].model.state_dict().items()}
    want, _ = cs._par_steps(plain[0], plain[1], batch, cs.PAR_STEPS, dev)
    want_sd = plain[0].model.state_dict()
    par.initialize_multihost(f'127.0.0.1:{cs._free_port()}', 1, 0,
                             backend='gloo', device='cpu')
    try:
        state, step, _ = cs._par_setup(**sizes)
        mesh = cs._fsdp_bind(state, layout)
        with cs._counted_collectives(False) as calls:
            got, _ = cs._par_steps(state, step, batch, cs.PAR_STEPS, dev)
        got_sd = {k: v.clone() for k, v in state.model.state_dict().items()}
        slots = [t.clone() for t in state.optimizer.slots['trace']]
        with _Refuse() as mode:                    # a fourth step
            step.eager(state, batch)
        assert mode.seen == []
    finally:
        torch.distributed.destroy_process_group()
    names = [c[0] for c in calls]
    assert names.count('reduce_scatter_tensor') == cs.PAR_STEPS
    assert names.count('all_gather_into_tensor') == cs.PAR_STEPS
    if layout == 'hsdp':
        assert mesh.shape == {'data': 1, 'fsdp': 1}
        assert sum(c[1] is mesh.replica_group for c in calls) == \
            cs.PAR_STEPS
    opt = state.optimizer
    assert opt.layout.sharded and len(opt.slots['trace']) == len(opt.params)
    # the slices carry no autograd history (a CUDA graph capture of the
    # backward fails on a view that keeps a gradient accumulator alive)
    assert all(t.grad_fn is None for t in opt.layout.local)
    for g, w in zip(got, want):
        for k, v in w.items():
            assert abs(g[k] - v) <= 1e-6 * max(abs(v), 1e-6), k
    upd, worst, biggest = cs._update_errors(got_sd, want_sd, start)
    assert worst <= 1e-6 * biggest, (worst, biggest)
    for a, b in zip(slots, plain[0].optimizer.slots['trace']):
        assert float((a - b).abs().max()) <= 1e-6 * biggest
