"""Multi-head attention: the port's one entry point to it.

``softmax(q kᵀ · scale) v`` over (B, heads, L, D) operands through
``torch.nn.functional.scaled_dot_product_attention``, which picks its
backend by device, dtype and head size: on an H100 in float32 (no flash
or cuDNN kernel takes fp32) the memory-efficient (cutlass) kernel, one
launch a call; on the CPU PyTorch's own. The transformer trunk
(``models/backbones/vit.py``) and the decoder head
(``models/heads/transformer_head.py``) call it, nothing else in the
port does.

``LAUNCHES`` counts the calls of :func:`attention` (each one kernel
launch on a card) as ``ops/lbs.py`` counts K1's: a CUDA graph replay
skips the Python, and ``utils/graphs.StageGraph`` adds the calls its
capture made back on every replay.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Calls of attention() in this process.
LAUNCHES = 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """(B, H, Lq, D) queries over (B, H, Lk, D) keys and values ->
    (B, H, Lq, D), no mask, no dropout."""
    global LAUNCHES
    out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    LAUNCHES += 1
    return out
