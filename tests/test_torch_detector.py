"""spec_tpu_torch.models.detector against spec_tpu.models.detector on the
CPU.

The JAX detector is built once (``YoloDetector(img_size=64, seed=0)``:
flax's init does not depend on the input size, so its variables are
also those of the ``detector`` golden's 160² detector) and its
variables reach the port through ``state_dict_from_flax(kind='yolo')``.

* fp32: the port's ``YoloV3`` against ``YoloV3(compute_dtype=float32)``
  at 64² and 96² (grids 2/4/8 and 3/6/12: even and odd), raw decode
  within relative 2e-5 (the reference's budget against an independent
  torch YOLO, ``tests/test_detector.py``); measured 1.2e-6 at 64².
* bf16: the ``detector`` golden (``tests/goldens.json``, fixed decode
  indices, its rtol 2e-2), with the port's own letterbox.
* The darknet loaders on one synthetic buffer (both header versions):
  the same weights, the same ``ValueError``s.
* Host NMS and square boxes on the reference's cases, the letterbox
  within one uint8 level with the same (scale, pad_x, pad_y), device
  top-K against full NMS, ``detect`` against the JAX detector as sets
  of boxes, and the detector's stage body capturable as a CUDA graph.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.models import detector as JD
from spec_tpu_torch.models import detector as TD
from spec_tpu_torch.utils.checkpoints import state_dict_from_flax
from tests.test_detector import _darknet_buffer
from tests.test_goldens import _assert_close
from tests.test_torch_graphs import _uncapturable_ops

DETECT_CONF = 0.3     # random init: the default 0.7 keeps almost no box


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: these tests run many small operations, and
    under a parallel test run (several workers sharing the cores) every
    parallel region's barrier waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_detector():
    """The JAX detector at 64², its forward swapped to fp32 (the
    detector reads ``self.model`` when it first traces)."""
    det = JD.YoloDetector(img_size=64, batch_size=2, seed=0,
                          conf_thresh=DETECT_CONF)
    det.model = JD.YoloV3(compute_dtype=jnp.float32)
    return det


def _port_model(variables, dtype):
    model = TD.YoloV3(dtype)
    model.load_state_dict(state_dict_from_flax(variables, 'yolo'))
    return model.eval()


@pytest.mark.parametrize('size', [64, 96])
def test_yolov3_matches_jax_fp32(jax_detector, size):
    x = np.random.RandomState(1).rand(2, size, size, 3).astype(np.float32)
    ref = np.asarray(jax_detector.model.apply(jax_detector.vars,
                                              jnp.asarray(x), mutable=False))
    with torch.no_grad():
        out = _port_model(jax_detector.vars, torch.float32)(
            torch.from_numpy(x)).numpy()
    g = size // 32
    assert out.shape == ref.shape == (2, 3 * (g * g + 4 * g * g
                                              + 16 * g * g), 85)
    rel = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 2e-5, rel


def test_bf16_decode_matches_the_detector_golden(jax_detector):
    """tests/test_goldens.py's ``compute_detector_golden`` through the
    port (bf16, the JAX detector's seed-0 variables, the port's
    letterbox and detect)."""
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__), 'goldens.json')) as f:
        golden = json.load(f)['detector']
    rng = np.random.RandomState(7)
    frames = [(rng.rand(120, 180, 3) * 255).astype('u1') for _ in range(2)]
    model = _port_model(jax_detector.vars, torch.bfloat16)
    batch = torch.stack([TD.letterbox(torch.from_numpy(f), 160)[0]
                         for f in frames])
    with torch.no_grad():
        raw = model(batch).numpy()
    idx = [0, raw.shape[1] // 3, raw.shape[1] - 1]
    got = {
        'mean_box': [float(v) for v in np.abs(raw[..., :4]).mean(0).mean(0)],
        'mean_obj': float(raw[..., 4].mean()),
        'rows': [[float(v) for v in raw[0, i, :6]] for i in idx],
    }
    det = TD.YoloDetector(img_size=160, batch_size=2, topk=16, device='cpu')
    det.model.load_state_dict(model.state_dict())
    got['n_boxes'] = [int(len(b)) for b in det.detect(frames,
                                                       conf_thresh=0.0)]
    _assert_close(golden, got, 'detector', rtol=2e-2)


def _old_header(buf: bytes) -> bytes:
    """The same floats behind a version-0.1 header (int32 seen count)."""
    return np.array([0, 1, 0, 7], '<i4').tobytes() + buf[20:]


@pytest.mark.parametrize('header', ['int64 seen', 'int32 seen'])
def test_darknet_loaders_agree(jax_detector, header, tmp_path):
    buf, floats = _darknet_buffer()
    if header == 'int32 seen':
        buf = _old_header(buf)
    jvars, n_jax = JD.load_darknet_weights(jax_detector.vars, buf)
    want = state_dict_from_flax(jvars, 'yolo')
    template = TD.YoloV3().state_dict()
    got, n_port = TD.load_darknet_weights(template, buf)
    assert n_port == n_jax == floats.size
    assert set(got) == set(want) == set(template)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    # a weights file reaches YoloDetector's model unchanged
    path = tmp_path / 'yolov3.weights'
    path.write_bytes(buf)
    det = TD.YoloDetector(weights_path=str(path), img_size=64,
                          device='cpu')
    for k, v in det.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    # the same refusals
    for bad in (buf[:len(buf) // 2], buf + np.zeros(10, '<f4').tobytes()):
        with pytest.raises(ValueError) as e_jax:
            JD.load_darknet_weights(jax_detector.vars, bad)
        with pytest.raises(ValueError) as e_port:
            TD.load_darknet_weights(template, bad)
        assert str(e_port.value) == str(e_jax.value)


def _nms_rows():
    """tests/test_detector.py's case: two overlapping persons, one
    apart, a confident non-person."""
    rows = np.zeros((4, 85), np.float32)
    rows[:, :4] = [[50, 50, 20, 40], [52, 50, 20, 40],
                   [150, 150, 30, 30], [50, 50, 20, 40]]
    rows[0, 4], rows[0, 5] = 0.9, 0.9
    rows[1, 4], rows[1, 5] = 0.9, 0.8
    rows[2, 4], rows[2, 5] = 0.8, 0.95
    rows[3, 4], rows[3, 6] = 0.99, 0.99
    return rows


@pytest.mark.parametrize('case', ['reference', 'random 85', 'random 5',
                                  'empty'])
def test_nms_and_square_boxes_equal_the_reference(case):
    rng = np.random.RandomState(5)
    rows = {'reference': _nms_rows(),
            'random 85': np.concatenate(
                [rng.rand(300, 4) * [400, 400, 80, 160],
                 rng.rand(300, 81)], 1).astype(np.float32),
            'random 5': np.concatenate(
                [rng.rand(200, 4) * [300, 300, 60, 90], rng.rand(200, 1)],
                1).astype(np.float32),
            'empty': np.zeros((5, 85), np.float32)}[case]
    for conf, nms in ((0.5, 0.4), (0.2, 0.6), (0.7, 0.4)):
        got = TD.nms_person(rows, conf, nms)
        want = JD.nms_person(rows, conf, nms)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(TD.square_cxcywh(got),
                                      JD.square_cxcywh(want))
    if case == 'reference':
        kept = TD.nms_person(rows, conf_thresh=0.5, nms_thresh=0.4)
        assert {tuple(b[:2]) for b in kept} == {(50.0, 50.0),
                                                (150.0, 150.0)}


@pytest.mark.parametrize('hw', [(100, 200), (80, 120), (120, 80), (64, 64),
                                (30, 40), (48, 64)])
def test_letterbox_within_one_uint8_level(hw):
    img = (np.random.RandomState(hw[0]).rand(*hw, 3) * 255).astype(np.uint8)
    want, *want_params = JD.letterbox(img, 64)
    got, *got_params = TD.letterbox(torch.from_numpy(img), 64)
    assert got_params == want_params          # scale, pad_x, pad_y exactly
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1.0 / 255 + 1e-6
    # frames already at the letterbox scale pass through unchanged
    if max(hw) == 64:
        np.testing.assert_array_equal(got.numpy(), want)


def test_top_person_candidates_matches_full_nms():
    rng = np.random.RandomState(3)
    dets = rng.rand(2, 500, 85).astype(np.float32)
    dets[..., :4] *= 400
    topk = TD.top_person_candidates(torch.from_numpy(dets), k=256).numpy()
    np.testing.assert_array_equal(topk, np.asarray(
        JD.top_person_candidates(jnp.asarray(dets), k=256)))
    for b in range(2):
        np.testing.assert_allclose(
            TD.nms_person(topk[b], 0.5, 0.4),
            TD.nms_person(dets[b], 0.5, 0.4), rtol=1e-6)
    small = TD.top_person_candidates(torch.from_numpy(dets[:, :100]), k=256)
    assert small.shape == (2, 100, 5)


def _match(got: np.ndarray, want: np.ndarray, atol: float) -> None:
    """The same boxes, in any order."""
    assert got.shape == want.shape, (got.shape, want.shape)
    key = (lambda a: a[np.lexsort(np.round(a.T[::-1], 1))])
    np.testing.assert_allclose(key(got), key(want), atol=atol)


def test_detect_matches_jax_as_sets(jax_detector):
    """Three frames at the letterbox scale (identical inputs on both
    sides; a tail batch of one), fp32 on both: per frame the same square
    boxes in frame pixels. The tail pads to a power of two."""
    rng = np.random.RandomState(11)
    frames = [(rng.rand(*hw, 3) * 255).astype(np.uint8)
              for hw in ((64, 64), (48, 64), (64, 40))]
    want = jax_detector.detect(frames)
    det = TD.YoloDetector(img_size=64, batch_size=2, conf_thresh=DETECT_CONF,
                          dtype=torch.float32, device='cpu')
    det.model.load_state_dict(state_dict_from_flax(jax_detector.vars,
                                                   'yolo'))
    got = det.detect(frames)
    assert len(got) == len(want) == 3
    assert sum(len(b) for b in want) > 0
    for g, w in zip(got, want):
        _match(g, w, atol=1e-3)
    pending = det.detect_dispatch(frames)
    assert [p[1].shape[0] for p in pending] == [2, 1]
    # conf_thresh is host-only: an override changes the boxes, not the
    # forward
    assert sum(len(b) for b in det.detect(frames, conf_thresh=0.99)) <= sum(
        len(b) for b in got)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_detector_stage_is_capturable(dtype):
    det = TD.YoloDetector(img_size=64, batch_size=2, dtype=dtype,
                          device='cpu')
    x = torch.rand(2, 64, 64, 3)
    with torch.inference_mode():
        assert _uncapturable_ops(det._fwd.fn, x) == []


def test_unported_and_bad_arguments_raise():
    with pytest.raises(NotImplementedError, match='item 12'):
        TD.YoloDetector(mesh=object(), device='cpu')
    with pytest.raises(ValueError, match='multiple of 32'):
        TD.YoloDetector(img_size=100, device='cpu')
