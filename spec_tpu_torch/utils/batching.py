"""Padded-batch sizing (twin of ``spec_tpu/utils/batching.py``).

Padding every call to the next power of two, capped at the configured
batch size, keeps the set of batch shapes small (cuDNN picks one
algorithm per shape) while a one-item call does not pay a full batch.
"""

from __future__ import annotations


def pad_pow2(n: int, cap: int) -> int:
    """Smallest power of two >= ``n``, capped at ``cap``."""
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)
