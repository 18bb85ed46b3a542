"""HMR 2.0 as stage 2 of the port (``models/backbones/vit.py``,
``models/heads/transformer_head.py``, ``ops/attention.py``), held on the
CPU to the benchmark's plain reference (``benchmark/reference/hmr2.py``)
under one seeded state dict: the trunk, the head, the whole model with
SMPL and a whole ``SpecPredictor.predict`` call, at a tiny size (trunk 64
wide, 2 deep, 4 heads, on 64² crops: 4 x 3 tokens; decoder 32 wide, 2
deep). At the published widths, on meta tensors: the 16 x 12 patch grid
and the parameter counts. HMR 2.0 has no JAX counterpart: the reference
is the plain one.

Tolerances: both sides compute in float32 on one BLAS, in another order
(the program's attention is ``scaled_dot_product_attention``, the
reference's an explicit softmax; the program's decoder self-attention is
its value projection), so they agree to float32 rounding through a few
layers: 1e-5 on the networks' outputs; through SMPL and the camera
1e-4 relative and 1e-3 px on 2D joints of a 1000-px frame, as
``benchmark/tests/test_bench_reference.py`` holds the ResNet model.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import weights as W
from benchmark.reference import geometry as G
from benchmark.reference import hmr2
from benchmark.reference.smpl import cam_head

TINY_VIT = dict(img_size=(64, 48), patch_size=16, embed_dim=64, depth=2,
                num_heads=4, mlp_ratio=4)
TINY_DECODER = dict(dim=32, depth=2, heads=2, dim_head=16, mlp_dim=32)
INIT = {'batchnorm_gamma': 1.0,
        'linear_gains': {'decpose': 0.05, 'decshape': 0.5, 'deccam': 0.05}}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread (tests/test_torch_detector.py): whole models
    under a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    """The program's ``vit_h`` and decoder at the tiny sizes."""
    from spec_tpu_torch.models.backbones import vit
    from spec_tpu_torch.models.heads import transformer_head as th

    monkeypatch.setitem(vit.VIT_SIZES, 'vit_h', TINY_VIT)
    monkeypatch.setattr(th, 'DECODER_SIZES', TINY_DECODER)


def _reference(seed=7):
    """The tiny reference with seeded weights and SPIN's mean
    parameters."""
    ref = hmr2.HMR2(64, 16, 64, 2, 4, 256, 32, 2, 2, 16, 32)
    ref.load_state_dict(W.network_state(ref, seed, 5, INIT, 'cpu'),
                        strict=False)
    ref.head.init_body_pose.copy_(
        torch.tensor([1.0, 0, 0, 0, 1.0, 0]).repeat(24)[None])
    ref.head.init_cam.copy_(torch.tensor([[0.9, 0.0, 0.0]]))
    return ref.eval()


def _program(ref):
    from spec_tpu_torch.models.hmr import HMR

    port = HMR(backbone='vit_h', head='transformer_decoder', img_res=64)
    port.load_state_dict(ref.state_dict())
    return port.eval()


def _port_assets(a):
    from spec_tpu_torch.core import constants as C
    from spec_tpu_torch.core import smpl as S

    return S.with_packed_lbs(S.SMPLAssets(
        v_template=a['v_template'], shapedirs=a['shapedirs'],
        posedirs=a['posedirs'], j_regressor=a['j_regressor'],
        lbs_weights=a['lbs_weights'],
        parents=tuple(int(p) for p in C.SMPL_PARENTS),
        extra_vertex_ids=tuple(int(i) for i in C.EXTRA_VERTEX_JOINT_IDS),
        j_regressor_extra=a['j_regressor_extra']))


def test_trunk_and_head_match_the_reference(tiny):
    ref = _reference()
    port = _program(ref)
    x = torch.randn(3, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want_map = ref.backbone(x[..., 8:-8])
        got_map = port.backbone(x[..., 8:-8])
        assert got_map.shape == (3, 64, 4, 3)
        torch.testing.assert_close(got_map, want_map, **TOL)
        want, got = ref.head(want_map), port.head(want_map)
    for k in ('pred_pose', 'pred_pose_6d', 'pred_shape', 'pred_cam'):
        torch.testing.assert_close(got[k], want[k], **TOL)
    # the random network is not degenerate: it moves pose and shape
    assert (want['pred_pose'] - torch.eye(3)).abs().max() > 0.05
    assert want['pred_shape'].abs().max() > 0.1


def test_the_model_with_smpl_matches_the_reference(tiny):
    ref = _reference()
    port = _program(ref)
    x = torch.randn(3, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    assets = W.smpl_assets(3, 6890, 'cpu')
    R = G.euler_to_rotmat(torch.tensor([0.1, -0.2, 0.3]),
                          torch.tensor([0.0, 0.1, -0.1]))
    f = torch.tensor([900.0, 1100.0, 1000.0])
    w, h = torch.tensor([640.0, 1280.0, 800.0]), torch.tensor([480.0, 720.0,
                                                               600.0])
    K = torch.zeros(3, 3, 3)
    K[:, 0, 0] = K[:, 1, 1] = f
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w / 2, h / 2, 1.0
    center = torch.tensor([[300.0, 200.0], [700.0, 400.0], [400.0, 300.0]])
    scale = torch.tensor([1.5, 2.0, 1.0])
    with torch.no_grad():
        r = ref(x)
        r.update(cam_head(assets, r, R, f, center, scale, w, h, 64))
        p = port(_port_assets(assets), x.permute(0, 2, 3, 1), R, K, scale,
                 center, w, h)
    for k in ('pred_pose', 'pred_pose_6d', 'pred_shape', 'pred_cam',
              'pred_cam_t', 'smpl_vertices', 'smpl_joints3d'):
        torch.testing.assert_close(p[k], r[k], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(p['smpl_joints2d'], r['smpl_joints2d'],
                               rtol=1e-4, atol=1e-3)


def test_predict_matches_the_reference(tiny, tmp_path, monkeypatch):
    from benchmark import traffic as T
    from benchmark.reference import predict as RP
    from spec_tpu_torch.serving import SpecPredictor

    ref = _reference(11)
    assets = W.smpl_assets(5, 6890, 'cpu')
    (tmp_path / 'smpl').mkdir()
    W.write_smpl_npz(assets, tmp_path / 'smpl' / 'SMPL_NEUTRAL.npz')
    np.save(tmp_path / 'J_regressor_extra.npy',
            assets['j_regressor_extra'].numpy())
    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path))
    pred = SpecPredictor(smpl_model_dir=str(tmp_path / 'smpl'),
                         backbone='vit_h', head='transformer_decoder',
                         camcalib_backbone='resnet18', min_size=64,
                         batch_size=4, device='cpu')
    assert pred.img_res == 64
    pred.spec.load_state_dict(ref.state_dict())
    frames = T.scene(np.random.default_rng(3), 96, 128, 2)
    boxes = [np.array([[40.0, 50.0, 30.0, 60.0], [90.0, 40.0, 20.0, 50.0],
                       [64.0, 48.0, 40.0, 80.0]], np.float32),
             np.array([[50.0, 45.0, 24.0, 60.0], [80.0, 60.0, 30.0, 70.0]],
                      np.float32)]
    out, cams = pred.predict(frames, boxes, return_cameras=True)
    want = RP.persons(ref, assets, frames, boxes, cams, 64, 'cpu')
    assert [len(f) for f in out] == [3, 2] == [len(f) for f in want]
    for frame, rframe in zip(out, want):
        for p, q in zip(frame, rframe):
            for k in ('pred_pose_6d', 'pred_shape', 'pred_cam',
                      'smpl_vertices', 'smpl_joints3d'):
                np.testing.assert_allclose(p[k], q[k], rtol=1e-4,
                                           atol=1e-5)
            np.testing.assert_allclose(p['smpl_joints2d'],
                                       q['smpl_joints2d'], rtol=1e-4,
                                       atol=1e-3)


def test_stage2_is_capturable(tiny):
    from spec_tpu_torch.serving import SpecPredictor
    from tests.test_torch_graphs import _frames_boxes, _uncapturable_ops

    pred = SpecPredictor(backbone='vit_h', head='transformer_decoder',
                         camcalib_backbone='resnet18', min_size=64,
                         batch_size=4, device='cpu')
    frames, boxes = _frames_boxes()
    with torch.inference_mode():
        frames_dev = [pred._upload(f) for f in frames]
        cams = pred.estimate_cameras(frames)
        (*_, inputs), = pred._stage2_batches(frames_dev, boxes, cams)
        assert _uncapturable_ops(pred._stage2.fn, *inputs) == []


def test_published_widths_on_meta_tensors():
    from spec_tpu_torch.models.hmr import HMR

    with torch.device('meta'):
        port = HMR(backbone='vit_h', head='transformer_decoder', img_res=256)
        ref = hmr2.HMR2()
        fmap = port.backbone(torch.empty(2, 3, 256, 192))
    assert fmap.shape == (2, 1280, 16, 12)
    assert port.backbone.pos_embed.shape == (1, 193, 1280)

    def count(m):
        return sum(p.numel() for p in m.parameters())

    # ViT-H/16 and the decoder head (MOTIVATION of the configuration)
    assert count(port.backbone) == count(ref.backbone) == 630_912_000
    assert count(port.head) == count(ref.head) == 39_547_037
    assert ({k: tuple(v.shape) for k, v in port.state_dict().items()}
            == {k: tuple(v.shape) for k, v in ref.state_dict().items()})


def test_rot6d_layout_is_hmr2s():
    """HMR 2.0 reads 6D as ``reshape(-1, 2, 3).permute(0, 2, 1)``: the
    first three numbers are the first column, as the port's
    ``rot6d_to_rotmat`` reads them."""
    from spec_tpu_torch.core.geometry import rot6d_to_rotmat

    x = torch.randn(50, 6, generator=torch.Generator().manual_seed(4))
    a = x.reshape(-1, 2, 3).permute(0, 2, 1)
    b1 = F.normalize(a[:, :, 0])
    b2 = F.normalize(a[:, :, 1] - (b1 * a[:, :, 1]).sum(-1, keepdim=True)
                     * b1)
    published = torch.stack([b1, b2, torch.linalg.cross(b1, b2)], dim=-1)
    torch.testing.assert_close(rot6d_to_rotmat(x), published, rtol=1e-6,
                               atol=1e-6)


def test_attention_launches_are_counted(tiny):
    from spec_tpu_torch.ops import attention as A

    port = _program(_reference())
    before = A.LAUNCHES
    with torch.no_grad():
        port.head(port.backbone(torch.zeros(2, 3, 64, 48)))
    # one a trunk block and one a decoder cross-attention; the decoder's
    # one-token self-attention is its value projection and launches none
    assert A.LAUNCHES - before == 2 + 2


class _Graph:
    """A stand-in for a captured CUDA graph: a replay runs nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_spans_count_the_launches_they_add_back(tiny):
    """The launches a capture made are taken back and added again, per
    module, on every replay, and each replay span counts them."""
    from torch.profiler import ProfilerActivity, profile

    from spec_tpu_torch.ops import attention as A
    from spec_tpu_torch.ops import lbs as L
    from spec_tpu_torch.utils import graphs, profiling

    port = _program(_reference())
    x = torch.zeros(2, 3, 64, 48)
    stage = graphs.StageGraph('stage2', lambda t: port.head(port.backbone(t)))
    before = (A.LAUNCHES, L.LAUNCHES)
    with torch.no_grad():
        out, launches = graphs._counted(stage.fn, x)
    assert (A.LAUNCHES, L.LAUNCHES) == before       # taken back
    assert launches == [(A, 4)]
    leaves, rebuild = graphs._flatten(out)
    entry = graphs._Captured(_Graph(), [x.clone()], leaves, rebuild,
                             launches, [])
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            got = stage._replay(entry, [x])
    replays = [s for s in profiling.spans()
               if s.name == 'graph/stage2/replay']
    profiling.clear_spans()
    assert entry.graph.replays == 3
    assert A.LAUNCHES - before[0] == 12 and L.LAUNCHES == before[1]
    assert [s.counts for s in replays] == [
        {'rows': 2, 'launches_attention': 4}] * 3
    torch.testing.assert_close(got['pred_pose'], out['pred_pose'])


def test_resnet50_keeps_its_path_with_the_hmr_head():
    """``head='hmr'`` (the default) is the ResNet model of before: the
    trunk on the NCHW crop, SPIN's regressor, the same bits."""
    from spec_tpu_torch.models.heads.hmr_head import HMRHead
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.utils.precision import compute_dtype

    torch.manual_seed(0)
    model = HMR(backbone='resnet50', head='hmr', img_res=64).eval()
    assert isinstance(model.head, HMRHead) and model.cols == 0
    x = torch.randn(2, 64, 64, 3)
    assets = _port_assets(W.smpl_assets(3, 6890, 'cpu'))
    R = torch.eye(3).expand(2, 3, 3)
    K = torch.tensor([[1000.0, 0, 320], [0, 1000.0, 240], [0, 0, 1]]
                     ).expand(2, 3, 3)
    args = (R, K, torch.tensor([1.0, 1.5]),
            torch.tensor([[300.0, 200.0], [100.0, 120.0]]),
            torch.tensor([640.0, 640.0]), torch.tensor([480.0, 480.0]))
    with torch.no_grad():
        out = model(assets, x, *args)
        with compute_dtype(torch.float32, 'cpu'):
            feats = model.backbone(x.permute(0, 3, 1, 2))
        head = model.head(feats)
    for k, v in head.items():
        assert torch.equal(out[k], v), k


def test_refusals():
    from spec_tpu_torch.models.hmr import HMR

    with torch.device('meta'):
        with pytest.raises(ValueError, match='centre of 224'):
            HMR(backbone='vit_h', head='transformer_decoder', img_res=224)
        with pytest.raises(ValueError, match='camera features'):
            HMR(backbone='vit_h', head='transformer_decoder', img_res=256,
                use_cam_feats=True)
        with pytest.raises(ValueError, match='unknown head'):
            HMR(backbone='resnet18', head='decoder')


def test_a_spec_yaml_names_the_head(tiny, tmp_path):
    from spec_tpu_torch.models.heads.transformer_head import (
        TransformerDecoderHead,
    )
    from spec_tpu_torch.serving import build_hmr
    from spec_tpu_torch.utils.config import (
        hmr_hparams_from_cfg,
        spec_default_config,
    )

    assert spec_default_config().HMR.HEAD == 'hmr'
    cfg = tmp_path / 'hmr2.yaml'
    cfg.write_text('HMR:\n  BACKBONE: vit_h\n  HEAD: transformer_decoder\n')
    assert hmr_hparams_from_cfg(str(cfg)) == ('vit_h', False,
                                              'transformer_decoder')
    model = build_hmr(str(tmp_path / 'missing.pt'), 'cpu', str(cfg))
    assert isinstance(model.head, TransformerDecoderHead)
    assert model.img_res == 64          # the tiny trunk's own crop side
    plain = tmp_path / 'r18.yaml'
    plain.write_text('HMR:\n  BACKBONE: resnet18\n')
    assert hmr_hparams_from_cfg(str(plain)) == ('resnet18', False, 'hmr')
    assert build_hmr(str(tmp_path / 'missing.pt'), 'cpu',
                     str(plain)).img_res == 224
