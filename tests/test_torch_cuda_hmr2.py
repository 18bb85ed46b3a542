"""HMR 2.0's stage 2 on a card: the replays of its CUDA graph against the
eager stage, the attention launches a capture takes back and each replay
adds again (and counts on its span), and the kernel
``scaled_dot_product_attention`` runs for fp32 at the published head
sizes (first: a profiler session with CPU activities may leave a later
CUDA-only one in the same process empty).

Marked ``cuda``; skips without a GPU. It imports no JAX:

    python -m pytest tests/test_torch_cuda_hmr2.py -m cuda --noconftest

A small trunk (64 wide, 2 deep, 4 heads of 16 on 64² crops) and decoder
(32 wide, 2 deep): what is checked is the capture and the counters.
"""

import numpy as np
import pytest
import torch

from spec_tpu_torch.ops import attention as A

TINY_VIT = dict(img_size=(64, 48), patch_size=16, embed_dim=64, depth=2,
                num_heads=4, mlp_ratio=4)
TINY_DECODER = dict(dim=32, depth=2, heads=2, dim_head=16, mlp_dim=32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


@pytest.fixture
def tiny(monkeypatch):
    from spec_tpu_torch.models.backbones import vit
    from spec_tpu_torch.models.heads import transformer_head as th

    monkeypatch.setitem(vit.VIT_SIZES, 'vit_h', TINY_VIT)
    monkeypatch.setattr(th, 'DECODER_SIZES', TINY_DECODER)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [((4, 16, 192, 80), (4, 16, 192, 80)),
                                   ((4, 8, 1, 64), (4, 8, 192, 64))])
def test_fp32_attention_takes_the_memory_efficient_kernel(cuda_device,
                                                          shape):
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(shape[0], device=cuda_device, generator=g)
    k, v = (torch.randn(shape[1], device=cuda_device, generator=g)
            for _ in range(2))
    scale = q.shape[-1] ** -0.5
    with torch.inference_mode():
        A.attention(q, k, v, scale)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = A.attention(q, k, v, scale)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    assert any('fmha_cutlassF_f32' in n for n in names), names
    want = torch.softmax(
        torch.matmul(q, k.transpose(-2, -1)) * scale, dim=-1) @ v
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_replays_match_the_eager_stage_and_count_attention(cuda_device,
                                                           tiny):
    from torch.profiler import ProfilerActivity, profile

    from spec_tpu_torch.serving import SpecPredictor
    from spec_tpu_torch.utils import profiling

    pred = SpecPredictor(backbone='vit_h', head='transformer_decoder',
                         camcalib_backbone='resnet18', min_size=64,
                         batch_size=4, device=cuda_device)
    rng = np.random.RandomState(3)
    frames = [(rng.rand(64, 80, 3) * 255).astype(np.uint8)
              for _ in range(2)]
    boxes = [np.array([[30.0, 30.0, 30.0, 40.0]], np.float32),
             np.array([[40.0, 35.0, 25.0, 40.0], [20.0, 30.0, 30.0, 50.0]],
                      np.float32)]
    with torch.inference_mode():
        frames_dev = [pred._upload(f) for f in frames]
        cams = pred.estimate_cameras(frames)
        (*_, inputs), = pred._stage2_batches(frames_dev, boxes, cams)
        before = A.LAUNCHES
        eager = pred._stage2.fn(*inputs)
        per_call = A.LAUNCHES - before
        assert per_call == 2 + 2        # trunk blocks + cross-attentions
        pred._stage2(*inputs)           # eager run, then the capture
        assert A.LAUNCHES - before == 2 * per_call
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            outs = [pred._stage2(*inputs) for _ in range(3)]
            torch.cuda.synchronize()
        spans = [s for s in profiling.spans()
                 if s.name == 'graph/stage2/replay']
        profiling.clear_spans()
    assert A.LAUNCHES - before == 5 * per_call
    assert [s.counts.get('launches_attention') for s in spans] == [
        per_call] * 3
    for out in outs:
        for k, v in eager.items():
            torch.testing.assert_close(out[k], v, rtol=1e-5, atol=1e-5)
