"""spec_tpu_torch.utils.graphs on the CPU: stage graphs run their function
directly there, device constants are built once, and every stage the
port captures on a card (the predictor's two stages and both pipelines)
is capturable: after a warm-up call it builds no tensor from host data,
reads no device value back on the host and takes no data-dependent
shape. Each of those would fail a CUDA graph capture; here they are
caught as the aten operations that carry them. The replays themselves
are held to the eager stages on the card (tests/test_torch_cuda_graphs.py).
"""

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from spec_tpu_torch.utils import graphs
from spec_tpu_torch.utils.precision import compute_dtype

# aten operations that a CUDA graph capture refuses or cannot replay:
# a tensor built from host data (an upload), a read of a device value on
# the host (a sync), and shapes that depend on the data.
UNCAPTURABLE = ('aten.lift_fresh', 'aten._local_scalar_dense',
                'aten.nonzero', 'aten.masked_select', 'aten._unique2',
                'aten.unique_dim', 'aten.unique_consecutive')


class _Refuse(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in UNCAPTURABLE:
            self.seen.append(name)
        if name in ('aten.index', 'aten.index_put') and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            self.seen.append(f'{name} with a boolean mask')
        return func(*args, **(kwargs or {}))


def _uncapturable_ops(fn, *args):
    fn(*args)                                  # warm-up, as before capture
    with _Refuse() as mode:
        fn(*args)
    return mode.seen


@pytest.fixture(scope='module')
def small_predictors():
    from spec_tpu_torch.serving import SpecPredictor

    kw = dict(backbone='resnet18', camcalib_backbone='resnet18',
              use_cam_feats=True, min_size=64, img_res=64, batch_size=4,
              device='cpu')
    return {'fp32': SpecPredictor(dtype=torch.float32, **kw),
            'bf16': SpecPredictor(dtype=torch.bfloat16, **kw)}


def _frames_boxes():
    rng = np.random.RandomState(3)
    frames = [(rng.rand(64, 80, 3) * 255).astype(np.uint8) for _ in range(2)]
    boxes = [np.array([[30.0, 30.0, 30.0, 40.0]], np.float32),
             np.array([[40.0, 35.0, 25.0, 40.0], [20.0, 30.0, 30.0, 50.0]],
                      np.float32)]
    return frames, boxes


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('stage', ['stage1', 'stage2'])
def test_predictor_stages_are_capturable(small_predictors, stage, dtype):
    pred = small_predictors[dtype]
    frames, boxes = _frames_boxes()
    with torch.inference_mode():
        frames_dev = [pred._upload(f) for f in frames]
        if stage == 'stage1':
            (_, batch), = pred._stage1_batches(frames_dev)
            seen = _uncapturable_ops(pred._stage1.fn, batch)
        else:
            cams = pred.estimate_cameras(frames)
            (*_, inputs), = pred._stage2_batches(frames_dev, boxes, cams)
            seen = _uncapturable_ops(pred._stage2.fn, *inputs)
    assert seen == []


def test_frames_of_two_sizes_in_one_call_match_each_frame_alone(
        small_predictors):
    """The glue around the stages batches per frame size (one resize per
    size, one crop call per size in a chunk): a call with frames of two
    sizes gives each frame what a call of that frame alone gives."""
    pred = small_predictors['fp32']
    rng = np.random.RandomState(4)
    frames = [(rng.rand(64, 80, 3) * 255).astype(np.uint8),
              (rng.rand(56, 96, 3) * 255).astype(np.uint8),
              (rng.rand(64, 80, 3) * 255).astype(np.uint8)]
    boxes = [np.array([[30.0, 30.0, 30.0, 40.0]], np.float32),
             np.array([[40.0, 28.0, 25.0, 40.0], [60.0, 30.0, 30.0, 44.0]],
                      np.float32),
             np.array([[45.0, 35.0, 28.0, 36.0]], np.float32)]
    together, cams = pred.predict(frames, boxes, return_cameras=True)
    for f, b, got, cam in zip(frames, boxes, together, cams):
        (alone,), (cam_alone,) = pred.predict([f], [b], return_cameras=True)
        assert cam == pytest.approx(cam_alone, rel=1e-5, abs=1e-6)
        for p_got, p_alone in zip(got, alone, strict=True):
            for k in ('smpl_vertices', 'pred_cam_t', 'smpl_joints2d'):
                np.testing.assert_allclose(p_got[k], p_alone[k], atol=1e-4)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('stage1', ['module', 'fused'])
def test_pipeline_is_capturable(stage1, dtype):
    from spec_tpu_torch.ops.preprocess import spin_crop_corners
    from spec_tpu_torch.pipeline import build_pipeline

    rng = np.random.RandomState(0)
    raw = torch.from_numpy((rng.rand(2, 64, 96, 3) * 255).astype('f4'))
    center = torch.tensor([[48.0, 32.0], [40.0, 30.0]])
    scale = torch.tensor([0.3, 0.25])
    corners = torch.from_numpy(spin_crop_corners(center.numpy(),
                                                 scale.numpy()))
    *_, pipeline = build_pipeline(compute_dtype=dtype, img_res=64,
                                  stage1=stage1, device='cpu')
    assert isinstance(pipeline, graphs.StageGraph)
    assert _uncapturable_ops(pipeline.fn, raw, corners, center, scale) == []


def test_refusal_check_sees_uploads_and_syncs():
    """The check above is not vacuous: an upload, a list index and a host
    read each show."""
    x = torch.ones(3, 4)
    assert _uncapturable_ops(lambda t: t + torch.tensor([1.0] * 4), x)
    assert _uncapturable_ops(lambda t: t[:, [0, 2]], x)
    assert _uncapturable_ops(lambda t: t * float(t.sum()), x)
    assert _uncapturable_ops(lambda t: t[t > 0], x)


def test_stage_graph_runs_the_function_directly_on_the_cpu():
    calls = []

    def fn(a, b):
        calls.append(1)
        return {'sum': a + b}

    stage = graphs.StageGraph('add', fn)
    a, b = torch.ones(3), torch.arange(3.0)
    out = stage(a, b)
    assert torch.equal(out['sum'], a + b)
    stage(a, b)
    assert len(calls) == 2 and stage.signatures() == []
    assert stage.fn is fn


def test_stage_graph_refuses_arguments_other_than_tensors():
    with pytest.raises(TypeError, match='tensors only'):
        graphs.StageGraph('s', lambda x, k: x)(torch.ones(2), 3)


def test_stage_graph_passes_fixed_arguments():
    """Keyword arguments reach the function as they are (on the card a
    generator is registered with the graph and the rest join the
    signature, which a failed capture names)."""
    seen = []

    def fn(x, *, scale, generator):
        seen.append((scale, generator))
        return x * scale

    gen = torch.Generator()
    out = graphs.StageGraph('s', fn)(torch.ones(2), scale=3.0,
                                     generator=gen)
    assert torch.equal(out, torch.full((2,), 3.0))
    assert seen == [(3.0, gen)]
    key = ((((2, 3), torch.float32, 'cuda:0'),)
           + (('names', ('img',)), ('update', True)))
    assert graphs._describe(key) == \
        "(2, 3) float32 cuda:0, names=('img',), update=True"


@pytest.mark.parametrize('out', [
    torch.ones(2),
    (torch.ones(2), torch.zeros(3)),
    [torch.ones(2)],
    {'a': torch.ones(2), 'b': torch.zeros(1)},
    ({'a': torch.ones(2)}, {'b': torch.zeros(1), 'c': torch.ones(3)},
     torch.zeros(2)),
])
def test_flatten_rebuilds_the_structure(out):
    flat, rebuild = graphs._flatten(out)
    back = rebuild([t.clone() for t in flat])
    assert type(back) is type(out)
    if isinstance(out, dict):
        assert list(back) == list(out)
        assert all(torch.equal(back[k], out[k]) for k in out)
    elif isinstance(out, torch.Tensor):
        assert torch.equal(back, out)
    else:
        assert all(torch.equal(x, y) for x, y in zip(
            pytree.tree_leaves(back), pytree.tree_leaves(out)))
        assert pytree.tree_structure(back) == pytree.tree_structure(out)


def test_flatten_refuses_other_outputs():
    with pytest.raises(TypeError, match='a stage returns tensors'):
        graphs._flatten(3.0)


def test_device_constant_is_built_once_per_values_dtype_and_device():
    a = graphs.device_constant([0.5, 1.5], 'cpu')
    assert graphs.device_constant(np.array([0.5, 1.5]), 'cpu') is a
    assert a.dtype == torch.float32 and a.tolist() == [0.5, 1.5]
    idx = graphs.device_constant((2, 0), 'cpu', torch.long)
    assert idx.dtype == torch.long and idx.tolist() == [2, 0]
    assert graphs.device_constant([0.5, 2.5], 'cpu') is not a


def test_device_constant_first_built_in_inference_mode_trains():
    """A constant an inference-mode caller built first (an eval step,
    the predictor) is a normal tensor: a train step can save it for
    backward."""
    with torch.inference_mode():
        idx = graphs.device_constant((0, 0, 1, 7), 'cpu', torch.long)
    assert not idx.is_inference()
    x = torch.ones(3, 2, requires_grad=True)
    x[idx[:3]].sum().backward()
    assert x.grad.tolist() == [[2.0, 2.0], [1.0, 1.0], [0.0, 0.0]]


def test_bf16_autocast_keeps_no_cache_of_cast_weights():
    with compute_dtype(torch.bfloat16, 'cpu'):
        assert torch.is_autocast_enabled('cpu')
        assert not torch.is_autocast_cache_enabled()
