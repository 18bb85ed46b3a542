"""Float32 precision policy: the torch twin of ``geometry.fp32_matmuls``.

On an NVIDIA card two flags decide whether float32 math runs in TF32
(about three decimal digits, ~1e-3 relative):

* ``torch.backends.cuda.matmul.allow_tf32`` for matmuls and einsums
  (PyTorch's default: False);
* ``torch.backends.cudnn.allow_tf32`` for cuDNN convolutions
  (PyTorch's default: True).

Mesh, rotation and camera math must stay full fp32 to hold the
1e-5 m vertex budget, and an fp32 predictor must run its convolutions
without TF32 to agree with the fp32 reference. ``bfloat16`` is used only
through autocast around the backbones and the HMR head FCs, the same
places where the flax modules take ``dtype``.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def fp32_precision():
    """Turn TF32 off for matmuls and cuDNN convs inside the block and
    restore both flags after it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def fp32_matmuls(fn):
    """Decorator form of :func:`fp32_precision`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with fp32_precision():
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def exact_fp32():
    """:func:`fp32_precision` with autocast off as well: metric math that
    may be called inside a bf16 autocast region (an eval step whose model
    runs in bf16) still runs every matmul and einsum in exact fp32."""
    with fp32_precision(), torch.autocast('cuda', enabled=False), \
            torch.autocast('cpu', enabled=False):
        yield


def exact_fp32_fn(fn):
    """Decorator form of :func:`exact_fp32`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with exact_fp32():
            return fn(*args, **kwargs)

    return wrapped


def compute_dtype(dtype: torch.dtype, device_type: str):
    """Context for a backbone or head FC stack: bf16 autocast when
    ``dtype`` is bfloat16, exact fp32 (TF32 off) when it is float32.

    The autocast keeps no cache of cast weights: a cast cached inside a
    CUDA graph capture (``utils/graphs.py``) would live in the graph's
    memory and be handed out after it. Each use of a weight casts it
    again, which gives the same bits."""
    if dtype == torch.float32:
        return fp32_precision()
    if dtype == torch.bfloat16:
        return torch.autocast(device_type=device_type, dtype=torch.bfloat16,
                              cache_enabled=False)
    raise ValueError(f'unsupported compute dtype {dtype}; '
                     'use torch.float32 or torch.bfloat16')
