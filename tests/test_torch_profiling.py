"""spec_tpu_torch.utils.profiling against spec_tpu.utils.profiling on the
CPU: ``check_batch_gradient`` on tests/test_config_utils.py's cases (and
a BatchNorm in train mode), ``nan_guard`` raising on a NaN from a stage,
the train step and a backward, ``trace``/``annotate`` writing a trace
that holds the region names, and the package's ``utils`` exports.
"""

import glob
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.utils import profiling as JP
from spec_tpu_torch.utils import profiling as TP
from spec_tpu_torch.utils.graphs import StageGraph


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('case', ['independent', 'mean_coupled',
                                  'per_row_norm', 'batch_max'])
def test_check_batch_gradient_matches_reference(case):
    fns = {
        'independent': (lambda x: x * 2 + 1, lambda x: x * 2 + 1),
        'mean_coupled': (lambda x: x - x.mean(0, keepdim=True),
                         lambda x: x - x.mean(axis=0, keepdims=True)),
        'per_row_norm': (lambda x: x / (x.norm(dim=1, keepdim=True) + 1),
                         lambda x: x / (jnp.linalg.norm(x, axis=1,
                                                        keepdims=True) + 1)),
        'batch_max': (lambda x: x * x.max(),
                      lambda x: x * x.max()),
    }
    tfn, jfn = fns[case]
    x = np.random.RandomState(0).rand(4, 8).astype(np.float32)
    got = TP.check_batch_gradient(tfn, torch.from_numpy(x))
    want = JP.check_batch_gradient(jfn, jnp.asarray(x))
    assert got == want
    assert got == (case in ('independent', 'per_row_norm'))


def test_check_batch_gradient_catches_train_mode_batchnorm():
    bn = torch.nn.BatchNorm1d(8)
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    assert not TP.check_batch_gradient(bn.train(), x)
    assert TP.check_batch_gradient(bn.eval(), x)


@pytest.fixture
def guard():
    TP.nan_guard(True)
    yield
    TP.nan_guard(False)


def test_nan_guard_raises_on_stage_output(guard):
    stage = StageGraph('divide', lambda a, b: {'q': a / b, 'n': a.sum()})
    ok = stage(torch.ones(3), torch.full((3,), 2.0))
    assert torch.equal(ok['q'], torch.full((3,), 0.5))
    with pytest.raises(FloatingPointError, match="stage 'divide'"):
        stage(torch.zeros(3), torch.zeros(3))
    assert torch.is_anomaly_enabled()
    TP.nan_guard(False)
    assert not torch.is_anomaly_enabled()
    out = stage(torch.zeros(3), torch.zeros(3))      # off: no check
    assert torch.isnan(out['q']).all()


def test_nan_guard_checks_backward_and_eager_train_step(guard):
    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match='nan'), \
            pytest.warns(UserWarning, match='Error detected in Sqrt'):
        torch.sqrt(w * 0 - 1).sum().backward()

    from spec_tpu_torch.train.steps import TrainStep

    class _Opt:
        host_mini = 0

        def will_update(self):
            return True

    class _State:
        model = torch.nn.Linear(2, 2)
        optimizer = _Opt()
        step = 0

    def loss_fn(x, *, update, generator, names):
        return {'loss': x.sum() * float('nan')}

    step = TrainStep('toy', lambda batch: ('x',), loss_fn)
    step._body = lambda *t, **k: loss_fn(*t, **k)
    with pytest.raises(FloatingPointError, match="train step 'toy'"):
        step.eager(_State(), {'x': torch.ones(2)})


def test_trace_and_annotate_write_region_names(tmp_path):
    with TP.trace(str(tmp_path)) as prof:
        with TP.annotate('spec_outer_region'):
            with TP.annotate('spec_inner_region'):
                y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(y[0, 0]) == 64.0
    assert prof is not None
    files = glob.glob(str(tmp_path / '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'spec_outer_region', 'spec_inner_region'} <= names
    assert any('mm' in str(n) for n in names)


def test_utils_exports_match_reference():
    import spec_tpu.utils as JU
    import spec_tpu_torch.utils as TU

    for name in ('StepTimer', 'annotate', 'nan_guard', 'set_seed', 'trace',
                 'CfgNode', 'camcalib_default_config', 'spec_default_config',
                 'get_grid_search_configs', 'run_grid_search_experiments',
                 'paths'):
        assert hasattr(JU, name) and hasattr(TU, name), name
    assert TU.trace is TP.trace and TU.nan_guard is TP.nan_guard
