"""Chained ResNet identity bottlenecks with folded BatchNorm: the wrapper
of the CUDA kernel ``csrc/bottleneck.cu`` and its plain PyTorch twin.

Port of ``spec_tpu/ops/pallas/bottleneck.py``. One identity bottleneck
with every BatchNorm folded into its conv (:func:`fold_bn`) is, on NHWC
activations x (B, H, W, C) in the working dtype (float32 or bfloat16):

    h1 = relu(x . w1 + b1)                       rounded to the dtype
    h2 = relu(conv3x3(h1, w2, zero pad 1) + b2)  rounded to the dtype
    y  = relu(h2 . w3 + b3 + x)                  rounded to the dtype

with fp32 sums, fp32 biases and weights cast to the working dtype. The
3x3 zero-pads h1 after its ReLU, not x (a zero x would still give
relu(b1)). A chain of K blocks applies them in turn.

:func:`fused_bottleneck_chain` launches the kernel once per block for
CUDA tensors and runs :func:`fused_bottleneck_chain_plain` for CPU
tensors; nothing falls back from one to the other. ``LAUNCHES`` counts
kernel launches. The kernel runs its three products on the tensor cores
(``mma.sync``): bf16 x bf16 -> fp32 for bf16, and 3xTF32 for fp32. Each
fp32 operand splits into a TF32 ``hi`` and a TF32 ``lo`` (the rounded
remainder, so ``hi + lo`` is within 2^-22 of the operand), and a product
is ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` with fp32 sums: within about
2^-21 of the fp32 product, the order of fp32's own rounding of the sums,
where one TF32 pass errs by up to 2^-10. So the fp32 variant keeps the
fp32 budget (the design note heads the source).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from spec_tpu_torch.utils.precision import fp32_precision

# Kernel launches made by fused_bottleneck_chain in this process.
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHANNEL_QUANTUM = 16   # the kernel's quantum: C and M are multiples of it


def fold_bn(weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5):
    """Fold inference BatchNorm into the conv before it.

    weight: torch layout (O, I, kh, kw) or (O, I); BN parameters (O,).
    Returns (weight', bias') with ``conv(x, weight') + bias' ==
    bn(conv(x, weight))``, in fp32 (callers cast afterwards).
    """
    s = scale.float() * torch.rsqrt(var.float() + eps)
    w = weight.float() * s.reshape(-1, *([1] * (weight.ndim - 1)))
    return w, bias.float() - mean.float() * s


def _check_operands(x: torch.Tensor, weights) -> None:
    """Raise on anything the kernel does not take, before any launch."""
    if x.dtype not in _DTYPES:
        raise TypeError('fused_bottleneck_chain: x must be float32 or '
                        f'bfloat16, got {x.dtype}')
    if x.ndim != 4:
        raise ValueError('fused_bottleneck_chain: x must be NHWC (B, H, W, '
                         f'C), got shape {tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError('fused_bottleneck_chain: x must be contiguous NHWC')
    _, H, _, C = x.shape
    k = len(weights)
    if k == 0:
        raise ValueError('fused_bottleneck_chain: empty chain')
    if k >= H:
        raise ValueError(f'chain of {k} needs image height > {k}, got {H}')
    M = weights[0][0].shape[-1]
    shapes = ((C, M), (M,), (9, M, M), (M,), (M, C), (C,))
    names = ('w1', 'b1', 'w2', 'b2', 'w3', 'b3')
    for i, block in enumerate(weights):
        if len(block) != 6:
            raise ValueError(f'fused_bottleneck_chain: block {i} has '
                             f'{len(block)} tensors, expected 6')
        for name, t, shape in zip(names, block, shapes):
            if tuple(t.shape) != shape:
                raise ValueError(f'fused_bottleneck_chain: block {i} {name} '
                                 f'must be {shape}, got {tuple(t.shape)}')
            if not t.is_floating_point():
                raise TypeError(f'fused_bottleneck_chain: block {i} {name} '
                                f'must be floating point, got {t.dtype}')
            if not t.is_contiguous():
                raise ValueError(f'fused_bottleneck_chain: block {i} {name} '
                                 'must be contiguous')
            if t.device != x.device:
                raise ValueError(f'fused_bottleneck_chain: block {i} {name} '
                                 f'is on {t.device}, x on {x.device}')
    if x.device.type == 'cuda' and (C % _CHANNEL_QUANTUM
                                    or M % _CHANNEL_QUANTUM):
        raise ValueError('fused_bottleneck_chain: the kernel needs C and M '
                         f'divisible by {_CHANNEL_QUANTUM}, got C={C} M={M}')


def fused_bottleneck_chain_plain(x: torch.Tensor, weights) -> torch.Tensor:
    """The chain in plain PyTorch: fp32 math (TF32 off) on operands
    already rounded to x's dtype, rounding where the kernel does."""
    dt = x.dtype
    y = x
    with fp32_precision():
        for (w1, b1, w2, b2, w3, b3) in weights:
            M = w1.shape[-1]
            xf = y.float()
            h1 = torch.relu(xf @ w1.to(dt).float() + b1.float()).to(dt)
            # (9, M_in, M_out), tap 3*dy + dx -> OIHW (M_out, M_in, 3, 3)
            k2 = w2.to(dt).float().reshape(3, 3, M, M).permute(3, 2, 0, 1)
            h2 = F.conv2d(h1.float().permute(0, 3, 1, 2), k2, padding=1)
            h2 = torch.relu(h2.permute(0, 2, 3, 1) + b2.float()).to(dt)
            z = h2.float() @ w3.to(dt).float() + b3.float()
            y = torch.relu(z + xf).to(dt)
    return y.contiguous()


def bind_forward(lib: ctypes.CDLL):
    """The C entry ``spec_bottleneck_forward`` of a built library, with
    its argument types."""
    fn = lib.spec_bottleneck_forward
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    """The built kernel's C entry point, with its argument types."""
    from spec_tpu_torch.ops.cuda_build import load_library

    return bind_forward(load_library('bottleneck'))


def picked_tile(B: int, H: int, W: int, C: int, M: int,
                dtype: torch.dtype) -> tuple:
    """(TH, TW, stages): the output tile and the depth of the copy ring
    that the kernel picks for x (B, H, W, C) in ``dtype`` and width M on
    the current CUDA device."""
    from spec_tpu_torch.ops.cuda_build import load_library

    fn = load_library('bottleneck').spec_bottleneck_pick_tile
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(3)]
    err = fn(_DTYPES[dtype], B, H, W, C, M, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f'no {dtype} tile fits C={C} M={M} (CUDA error '
                           f'{err})')
    return tuple(v.value for v in out)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data is not 16-byte aligned (the
    kernel copies rows with 16-byte cp.async and reads bias pairs)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x: torch.Tensor, block, tile=(0, 0), fn=None) -> torch.Tensor:
    """One block on the kernel. ``tile`` (TH, TW) forces the kernel's
    output tile, for timing the candidates; (0, 0) lets the kernel pick
    it. ``fn``: another build's C entry (:func:`bind_forward`), for
    comparing two builds; None, this package's."""
    global LAUNCHES
    fn = fn or _kernel()
    B, H, W, C = x.shape
    dt = x.dtype
    w1, b1, w2, b2, w3, b3 = block
    M = w1.shape[-1]
    x = _aligned(x)
    w1, w2, w3 = (_aligned(w.to(dt)) for w in (w1, w2, w3))
    b1, b2, b3 = (_aligned(b.float()) for b in (b1, b2, b3))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # The runtime launches on its current device: make it the tensors'.
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPES[dt], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
                 out.data_ptr(), B, H, W, C, M, *tile, stream)
    if err != 0:
        raise RuntimeError(f'bottleneck kernel launch failed with CUDA '
                           f'error {err}')
    LAUNCHES += 1
    return out


def fused_bottleneck_chain(x: torch.Tensor, weights) -> torch.Tensor:
    """K chained identity bottlenecks with folded BN -> (B, H, W, C).

    x: contiguous NHWC (B, H, W, C), float32 or bfloat16. weights: K
    tuples ``(w1 (C, M), b1 (M,), w2 (9, M, M), b2 (M,), w3 (M, C),
    b3 (C,))`` in the JAX package's layouts (w2's first index is the
    tap 3*dy + dx). Weights are cast to x's dtype, biases to float32.
    Raises ValueError when K >= H, as the JAX function does.

    CUDA tensors launch the kernel once per block (the intermediate
    between blocks goes through device memory); CPU tensors run the
    plain version; any other device raises. The JAX function's
    ``row_tile`` and ``interpret`` are TPU tiling and interpret-mode
    parameters and have no counterpart here.
    """
    _check_operands(x, weights)
    if x.device.type == 'cpu':
        return fused_bottleneck_chain_plain(x, weights)
    if x.device.type != 'cuda':
        raise ValueError('fused_bottleneck_chain runs on CUDA (kernel) or '
                         f'CPU (plain version), not {x.device}')
    for block in weights:
        x = _launch(x, block)
    return x


def fused_identity_bottleneck(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Single fused identity bottleneck (a chain of one)."""
    return fused_bottleneck_chain(x, ((w1, b1, w2, b2, w3, b3),))
