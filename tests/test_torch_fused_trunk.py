"""The predictor's folded trunk on the CPU: a ResNet-50 ``SpecPredictor``
runs both stages' trunks as ``FusedResNet`` (BatchNorm folded into every
conv, identity blocks as convolutions, no K3) and matches the module
path within fp32 tolerances; weights loaded with ``load_state_dict``
after construction, as ``benchmark/drivers/predict.py`` loads them,
reach the folded trunk, a second load too; HRNet, ViT and BasicBlock
trunks, bfloat16 models and models made under inference mode keep the
module path; the folded stage bodies are capturable; and a ``.specx``
exported from the folded predictor stores the folded weights alone and
serves as the live predictor does. Frames are small (64-px short side,
64-px crops) so the file stays a few seconds of tier-1."""

import copy
import io
import zipfile

import numpy as np
import pytest
import torch

from spec_tpu_torch.models.backbones import fused_resnet as FR
from spec_tpu_torch.models.backbones.fused_resnet import (
    FusedResNet,
    inference_trunk,
)
FIELDS = ('pred_pose_6d', 'pred_shape', 'pred_cam', 'smpl_vertices',
          'smpl_joints3d', 'smpl_joints2d')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames_boxes():
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
              for _ in range(2)]
    boxes = [np.array([[40.0, 50.0, 30.0, 60.0], [80.0, 40.0, 24.0, 50.0],
                       [64.0, 48.0, 40.0, 80.0]], np.float32),
             np.array([[50.0, 45.0, 24.0, 60.0], [90.0, 60.0, 30.0, 70.0]],
                      np.float32)]
    return frames, boxes


def _predictor(backbone='resnet50', camcalib_backbone='resnet50'):
    from spec_tpu_torch.serving import SpecPredictor

    return SpecPredictor(device='cpu', backbone=backbone,
                         camcalib_backbone=camcalib_backbone, min_size=64,
                         img_res=64, batch_size=4)


def _state(model, seed):
    """A state_dict for ``model``'s architecture: torchvision init from
    ``seed``, BatchNorm scales 0.35 and statistics drawn around 0 and 1
    (so activations stay live through 16 blocks)."""
    m = copy.deepcopy(model)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.fill_(0.35)
                mod.running_mean.normal_(0.0, 0.1, generator=g)
                mod.running_var.uniform_(0.75, 1.25, generator=g)
    return m.state_dict()


def _load(pred, seed):
    pred.camcalib.load_state_dict(_state(pred.camcalib, seed))
    pred.spec.load_state_dict(_state(pred.spec, seed + 10))


def _module_path(pred, frames, boxes):
    """``predict`` with both stages on their backbones (the folded
    trunks set aside)."""
    trunks = pred._stage1.fn.trunk, pred._stage2.fn.trunk
    pred._stage1.fn.trunk = pred._stage2.fn.trunk = None
    try:
        return pred.predict(frames, boxes, return_cameras=True)
    finally:
        pred._stage1.fn.trunk, pred._stage2.fn.trunk = trunks


def _assert_close(got, want, rtol=1e-4, atol=1e-5):
    (out, cams), (ref, ref_cams) = got, want
    for a, b in zip(cams, ref_cams, strict=True):
        for k in ('vfov', 'pitch', 'roll', 'f_pix'):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-6), k
    assert [len(f) for f in out] == [len(f) for f in ref]
    for frame, rframe in zip(out, ref):
        for p, q in zip(frame, rframe):
            for k in FIELDS:
                tol = 1e-3 if k == 'smpl_joints2d' else atol
                np.testing.assert_allclose(p[k], q[k], rtol=rtol, atol=tol,
                                           err_msg=k)


@pytest.fixture(scope='module')
def r50():
    pred = _predictor()
    _load(pred, 20)
    return pred


def _count_k3(monkeypatch):
    calls = []
    chain = FR.fused_bottleneck_chain

    def counted(x, weights):
        calls.append(x.shape)
        return chain(x, weights)

    monkeypatch.setattr(FR, 'fused_bottleneck_chain', counted)
    return calls


def _count_trunk_calls(monkeypatch, trunk):
    calls = []
    forward = trunk.forward

    def counted(x):
        calls.append(x.shape)
        return forward(x)

    monkeypatch.setattr(trunk, 'forward', counted)
    return calls


def test_resnet50_predictor_matches_the_module_path(r50, monkeypatch):
    """Both stages fold, with every identity block a convolution (no K3
    call: one stage-1 bucket of 2 frames, stage-2 chunks of 4 and 1);
    the models' state_dicts are the modules' own."""
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork

    for stage in (r50._stage1.fn, r50._stage2.fn):
        assert isinstance(stage.trunk, FusedResNet) and not stage.trunk.k3
    assert (r50.camcalib.state_dict().keys()
            == CameraRegressorNetwork('resnet50').state_dict().keys())
    frames, boxes = _frames_boxes()
    calls = _count_k3(monkeypatch)
    trunk_calls = _count_trunk_calls(monkeypatch, r50._stage2.fn.trunk)
    got = r50.predict(frames, boxes, return_cameras=True)
    assert calls == [] and len(trunk_calls) == 2
    _assert_close(got, _module_path(r50, frames, boxes))


def test_weights_loaded_after_construction_reach_the_trunk(monkeypatch):
    """``benchmark/drivers/predict.py``'s order: build, then
    load_state_dict. The first call refolds; a second load refolds
    again, into the same storage; with nothing changed, nothing is
    folded."""
    pred = _predictor()
    frames, boxes = _frames_boxes()
    trunk = pred._stage2.fn.trunk
    ptr = trunk.l2_id3_c2_w.data_ptr()
    first = pred.predict(frames, boxes)
    _load(pred, 30)
    got = pred.predict(frames, boxes, return_cameras=True)
    _assert_close(got, _module_path(pred, frames, boxes))
    assert not np.allclose(got[0][0][0]['smpl_vertices'],
                           first[0][0]['smpl_vertices'])
    _load(pred, 40)
    got = pred.predict(frames, boxes, return_cameras=True)
    _assert_close(got, _module_path(pred, frames, boxes))
    assert trunk.l2_id3_c2_w.data_ptr() == ptr
    assert not trunk.refresh() and not pred._stage1.fn.trunk.refresh()
    # an in-place change of one BatchNorm statistic is seen too
    with torch.no_grad():
        pred.spec.backbone.layer3[2].bn2.running_var.mul_(2.0)
    assert trunk.refresh() and not trunk.refresh()


@pytest.mark.parametrize('backbone,dtype,inference', [
    ('hrnet_w32-conv', torch.float32, False),
    ('vit_h', torch.float32, False), ('resnet18', torch.float32, False),
    ('resnet50', torch.bfloat16, False), ('resnet50', torch.float32, True)])
def test_other_trunks_keep_the_module_path(backbone, dtype, inference):
    """Only float32 Bottleneck ResNets whose tensors keep version
    counters fold (a model made under inference mode keeps none, so a
    later load could not reach its fold): built on the meta device, so
    ViT-H's 632 M parameters take no memory."""
    from spec_tpu_torch.models.hmr import HMR

    kw = dict(head='transformer_decoder', img_res=256) if backbone == \
        'vit_h' else {}
    with torch.device('meta'), torch.inference_mode(inference):
        assert inference_trunk(HMR(backbone=backbone, dtype=dtype,
                                   **kw)) is None
    with torch.device('meta'):
        trunk = inference_trunk(HMR(backbone='resnet101'))
        assert trunk.dtype == torch.float32 and not trunk.k3


def test_hrnet_predictor_calls_no_k3(monkeypatch):
    pred = _predictor('hrnet_w32-conv', camcalib_backbone='resnet18')
    assert pred._stage1.fn.trunk is None and pred._stage2.fn.trunk is None
    calls = _count_k3(monkeypatch)
    frames, boxes = _frames_boxes()
    out = pred.predict(frames, boxes)
    assert [len(f) for f in out] == [3, 2] and calls == []


def test_train_mode_and_gradients_take_the_backbone(r50, monkeypatch):
    """The stage runs the folded trunk for inference only."""
    batch = torch.zeros((1, 64, 80, 3), dtype=torch.uint8)
    stage = r50._stage1.fn
    calls = _count_trunk_calls(monkeypatch, stage.trunk)
    with torch.no_grad():
        stage(batch)
    assert len(calls) == 1
    stage(batch)                       # autograd on
    r50.camcalib.train()
    try:
        with torch.no_grad():
            stage(batch)
    finally:
        r50.camcalib.eval()
    assert len(calls) == 1


@pytest.mark.parametrize('stage', ['stage1', 'stage2'])
def test_folded_stage_bodies_are_capturable(r50, stage):
    from tests.test_torch_graphs import _uncapturable_ops

    frames, boxes = _frames_boxes()
    with torch.inference_mode():
        frames_dev = [r50._upload(f) for f in frames]
        if stage == 'stage1':
            (_, batch), = r50._stage1_batches(frames_dev)
            seen = _uncapturable_ops(r50._stage1.fn, batch)
        else:
            cams = r50.estimate_cameras(frames)
            (*_, inputs), *_ = r50._stage2_batches(frames_dev, boxes, cams)
            seen = _uncapturable_ops(r50._stage2.fn, *inputs)
    assert seen == []


def test_specx_round_trip_with_the_folded_trunk(r50, tmp_path):
    """Exported on the CPU right after a load (no call has refolded yet):
    each stage's program has no K3 node and stores the folded weights of
    the loaded state and none of the source trunk's, and the loaded
    artifact serves what the live folded predictor serves."""
    from spec_tpu_torch import export as EX

    _load(r50, 60)
    path = EX.export_predictor(r50, str(tmp_path / 'r50.specx'))
    with zipfile.ZipFile(path) as z:
        for name in ('cam.pt2', 'spec.pt2'):
            ep = torch.export.load(io.BytesIO(z.read(name)))
            nodes = [n for n in ep.graph.nodes if n.op == 'call_function'
                     and 'fused_bottleneck' in str(n.target)]
            assert nodes == [], name
            keys = list(ep.state_dict)
            assert any(k.startswith('trunk.') for k in keys), name
            assert not any('backbone.' in k for k in keys), name
    loaded = EX.load_predictor(path, device='cpu')
    frames, boxes = _frames_boxes()
    # the traced frame's size (64x85 after the resize) and another
    frames = [frames[0], frames[1][:, :110]]
    _assert_close(loaded.predict(frames, boxes, return_cameras=True),
                  r50.predict(frames, boxes, return_cameras=True),
                  rtol=1e-5, atol=1e-6)
