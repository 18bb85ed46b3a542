"""spec_tpu_torch.ops.preprocess vs the JAX package's preprocessing: the
on-device SPIN crop against the JAX op and the native host crop, and the
stage-1 min-side resize against PIL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spec_tpu import native
from spec_tpu.data.image_folder import resize_min_side as pil_resize_min_side
from spec_tpu.ops import preprocess as JP
from spec_tpu_torch.ops import preprocess as TP

# /255-unit budget of tests/test_preprocess_op.py.
MAX_ERR, MEAN_ERR = 2e-3, 1e-3


def _boxes(rng, B, H, W):
    """Boxes inside the frame plus ones over every edge."""
    centers = np.stack([rng.rand(B) * W, rng.rand(B) * H], 1)
    centers[0] = [5.0, 8.0]             # over the top-left corner
    centers[1] = [W - 3.0, H - 6.0]     # over the bottom-right corner
    scales = rng.rand(B) * 0.6 + 0.3
    return centers.astype(np.float32), scales.astype(np.float32)


def test_spin_crop_corners_match_jax(rng):
    centers, scales = _boxes(rng, 16, 240, 320)
    np.testing.assert_array_equal(
        TP.spin_crop_corners(centers, scales, res=224),
        JP.spin_crop_corners(centers, scales, res=224))


@pytest.mark.parametrize('res', [224, 64])
def test_crop_matches_jax_and_native(rng, res):
    B, H, W = 5, 180, 260
    frame = (rng.rand(H, W, 3) * 255).astype(np.float32)
    centers, scales = _boxes(rng, B, H, W)
    corners = TP.spin_crop_corners(centers, scales, res=res)
    port = TP.crop_resize_normalize(
        torch.from_numpy(frame)[None].expand(B, H, W, 3),
        torch.from_numpy(corners), res=res, normalize=False).numpy()
    refs = [np.asarray(JP.crop_resize_normalize(
        jnp.asarray(np.broadcast_to(frame, (B, H, W, 3))),
        jnp.asarray(corners), res=res, normalize=False))]
    if native.available():
        refs.append(native.spin_crop_batch(frame, centers, scales, res=res,
                                           normalize=False))
    for ref in refs:
        diff = np.abs(port - ref)
        assert diff.max() < MAX_ERR, diff.max()
        assert diff.mean() < MEAN_ERR, diff.mean()
    # Every box here reaches over an edge somewhere or lies inside;
    # outside-frame taps must read zero.
    assert port.shape == (B, res, res, 3)


def test_crop_normalize_matches_native_normalized(rng):
    H, W = 120, 150
    frame = (rng.rand(H, W, 3) * 255).astype(np.float32)
    centers, scales = _boxes(rng, 4, H, W)
    corners = TP.spin_crop_corners(centers, scales, res=64)
    port = TP.crop_resize_normalize(
        torch.from_numpy(frame)[None].expand(4, H, W, 3),
        torch.from_numpy(corners), res=64).numpy()
    ref = np.asarray(JP.crop_resize_normalize(
        jnp.asarray(np.broadcast_to(frame, (4, H, W, 3))),
        jnp.asarray(corners), res=64))
    # normalized units: the /255 budget divided by the smallest std
    assert np.abs(port - ref).max() < MAX_ERR / 0.224


def test_zero_padding_outside_frame(rng):
    frame = torch.from_numpy((rng.rand(1, 50, 50, 3) * 255 + 1)
                             .astype(np.float32))
    out = TP.crop_resize_normalize(
        frame, torch.tensor([[-50, -50, 50, 50]]), res=64,
        normalize=False).numpy()
    assert out[0, :30, :30].max() == 0.0
    assert out[0, 40:, 40:].min() > 0.0


@pytest.mark.parametrize('hw,min_size', [
    ((300, 400), 96),     # downscale
    ((97, 211), 96),      # slight downscale, odd sizes
    ((60, 80), 96),       # upscale
    ((96, 128), 96),      # identity
])
def test_resize_min_side_matches_pil(rng, hw, min_size):
    img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    # smooth content plus noise, like a photo
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    img[..., 0] = (127 + 120 * np.sin(xx / 7.0)).astype(np.uint8)
    ref = np.asarray(pil_resize_min_side(Image.fromarray(img), min_size))
    port = TP.resize_min_side(torch.from_numpy(img), min_size).numpy()
    assert port.shape == ref.shape
    assert port.dtype == np.uint8
    assert np.abs(port.astype(int) - ref.astype(int)).max() <= 1


def test_crop_with_frame_index_equals_one_frame_at_a_time(rng):
    """One call over the boxes of several frames of one size crops as a
    call per frame (an expanded view of that frame) does, bit for bit."""
    H, W, res = 90, 120, 48
    frames = torch.from_numpy((rng.rand(3, H, W, 3) * 255).astype(np.float32))
    centers, scales = _boxes(rng, 6, H, W)
    corners = torch.from_numpy(TP.spin_crop_corners(centers, scales, res=res))
    index = torch.tensor([2, 0, 0, 1, 2, 2])
    batched = TP.crop_resize_normalize(frames, corners, res=res,
                                       frame_index=index)
    for b, f in enumerate(index.tolist()):
        alone = TP.crop_resize_normalize(frames[f][None], corners[b:b + 1],
                                         res=res)
        assert torch.equal(batched[b], alone[0])


@pytest.mark.parametrize('hw,min_size', [((300, 400), 96), ((60, 80), 96),
                                         ((96, 128), 96)])
def test_batched_resize_equals_one_image_at_a_time(rng, hw, min_size):
    imgs = torch.from_numpy((rng.rand(3, *hw, 3) * 255).astype(np.uint8))
    batch = TP.resize_min_side(imgs, min_size)
    for k in range(3):
        assert torch.equal(batch[k], TP.resize_min_side(imgs[k], min_size))
