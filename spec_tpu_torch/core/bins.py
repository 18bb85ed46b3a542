"""CamCalib angle-bin tables and decoders (torch twin of
``spec_tpu/core/bins.py``).

Each camera angle (vfov, pitch, roll) is predicted as 256 logits over
255 bin edges. Decoding is either argmax -> bin center (ce/kl losses) or
softargmax -> soft index in [-1, 1] -> angle (softargmax losses). The
tables are numpy constants; the decoders run on the logits' device.
"""

from __future__ import annotations

import numpy as np
import torch

from spec_tpu_torch.utils.graphs import device_constant

NUM_BINS = 256  # logits per head
NUM_EDGES = 255

VFOV_RANGE = (0.2617, 2.1)   # radians (~15 deg .. ~120 deg)
PITCH_RANGE = (-0.6, 0.6)    # radians
ROLL_RANGE = (-0.6, 0.6)     # radians (uniform table)
HORIZON_RANGE = (-0.5, 1.5)  # fraction of image height


def _centers(edges: np.ndarray) -> np.ndarray:
    """Midpoints between consecutive edges; last center = last edge."""
    c = edges.copy()
    c[:-1] += np.diff(edges) / 2
    return np.append(c, edges[-1])


def _legacy_roll_edges(
    minval: float = -np.pi / 6,
    maxval: float = np.pi / 6,
    sigma: float = 0.5,
    alpha: float = 0.04,
    beta: float = 1.1,
    kappa: float = np.pi,
) -> np.ndarray:
    """Non-uniform legacy roll bins, denser near roll = 0: the normalized
    cumulative sum of an inverted, scaled Gaussian bump."""
    x = np.linspace(minval, maxval, NUM_EDGES)
    pdf = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    pdf = pdf / pdf.max()
    pdf = pdf * alpha
    pdf = pdf.max() * beta - pdf
    cumsum = np.cumsum(pdf)
    cumsum = cumsum / cumsum.max() * kappa
    cumsum -= cumsum[pdf.size // 2]
    return cumsum


VFOV_EDGES = np.linspace(*VFOV_RANGE, NUM_EDGES).astype(np.float32)
PITCH_EDGES = np.linspace(*PITCH_RANGE, NUM_EDGES).astype(np.float32)
ROLL_EDGES = np.linspace(*ROLL_RANGE, NUM_EDGES).astype(np.float32)
HORIZON_EDGES = np.linspace(*HORIZON_RANGE, NUM_EDGES).astype(np.float32)
LEGACY_ROLL_EDGES = _legacy_roll_edges().astype(np.float32)

VFOV_CENTERS = _centers(np.linspace(*VFOV_RANGE, NUM_EDGES)).astype(
    np.float32)
PITCH_CENTERS = _centers(np.linspace(*PITCH_RANGE, NUM_EDGES)).astype(
    np.float32)
ROLL_CENTERS = _centers(np.linspace(*ROLL_RANGE, NUM_EDGES)).astype(
    np.float32)
HORIZON_CENTERS = _centers(np.linspace(*HORIZON_RANGE, NUM_EDGES)).astype(
    np.float32)
LEGACY_ROLL_CENTERS = _centers(_legacy_roll_edges()).astype(np.float32)


def softargmax1d(logits: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
    """Softmax expectation of the index over the last axis, mapped to
    [-1, 1] by idx / (D - 1) * 2 - 1."""
    logits = logits.float()
    dim = logits.shape[-1]
    z = logits * temperature
    probs = torch.exp(z - z.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    idx = torch.arange(dim, dtype=torch.float32, device=logits.device)
    expected = (probs * idx).sum(dim=-1)
    return expected / (dim - 1) * 2.0 - 1.0


def soft_idx_to_angle(soft_idx, lo: float, hi: float):
    """Soft index in [-1, 1] -> angle."""
    return (hi - lo) * ((soft_idx + 1.0) / 2.0) + lo


def bins_to_angle_argmax(logits: torch.Tensor,
                         centers: np.ndarray) -> torch.Tensor:
    """argmax over the logits -> bin-center lookup (ce/kl decode)."""
    table = device_constant(centers, logits.device)
    return table[logits.argmax(dim=-1)]


def convert_preds_to_angles(
    vfov_logits: torch.Tensor,
    pitch_logits: torch.Tensor,
    roll_logits: torch.Tensor,
    loss_type: str = 'softargmax_biased_l2',
    legacy: bool = False,
):
    """Unified decode -> (vfov, pitch, roll), each of shape (B,)."""
    if loss_type in ('kl', 'ce'):
        # The argmax roll decode always uses the legacy warped table.
        return (bins_to_angle_argmax(vfov_logits, VFOV_CENTERS),
                bins_to_angle_argmax(pitch_logits, PITCH_CENTERS),
                bins_to_angle_argmax(roll_logits, LEGACY_ROLL_CENTERS))
    if loss_type in ('softargmax_l2', 'softargmax_biased_l2'):
        vfov = soft_idx_to_angle(softargmax1d(vfov_logits), *VFOV_RANGE)
        pitch = soft_idx_to_angle(softargmax1d(pitch_logits), *PITCH_RANGE)
        if legacy:
            roll = bins_to_angle_argmax(roll_logits, LEGACY_ROLL_CENTERS)
        else:
            roll = soft_idx_to_angle(softargmax1d(roll_logits), *ROLL_RANGE)
        return vfov, pitch, roll
    raise ValueError(f'unknown loss_type: {loss_type}')


# -- encoders (targets for CamCalib training) ---------------------------

def angle_to_soft_idx(angle, lo: float, hi: float):
    """Angle -> soft index in [-1, 1]."""
    return 2.0 * ((angle - lo) / (hi - lo)) - 1.0


def angle_to_bin_index(angle: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Hard bin targets for ce/kl training, numpy ``digitize``
    semantics: bin 0 lies below the first edge."""
    return np.digitize(np.asarray(angle), np.asarray(edges))


def vfov2soft_idx(angle):
    return angle_to_soft_idx(angle, *VFOV_RANGE)


def pitch2soft_idx(angle):
    return angle_to_soft_idx(angle, *PITCH_RANGE)


def roll2soft_idx(angle):
    return angle_to_soft_idx(angle, *ROLL_RANGE)
