"""attention_roofline.predict: the least time of the profiled slice's
attention (``driver.attention_bound_s``: the trunk's q kᵀ and p v and the
decoder's cross-attentions over each call's persons, at the card's 3xTF32
rate or HBM's, whichever is longer; ``benchmark/work_hmr2.py``) over the
device time of the attention kernels: the mean duration of the events
named in ``KERNELS`` times the launches (the ``launches_attention`` that
the slice's graph replay spans count, or the events seen where more), in
%. None where the slice launched no attention."""

from benchmark import spans

# Substrings of the scaled_dot_product_attention backends' kernel names
# (memory-efficient cutlass, flash, cuDNN).
KERNELS = ('fmha_cutlass', 'flash_fwd', 'sdpa')


def launches() -> int:
    """``launches_attention`` over the slice's graph replay spans."""
    return sum(s.counts.get('launches_attention', 0)
               for _, under in spans.calls(spans.recorded()) for s in under
               if s.name.startswith('graph/') and s.name.endswith('/replay'))


def read(rec):
    p = rec.profile
    bound = getattr(rec.driver, 'attention_bound_s', None)
    if p is None or bound is None:
        return None

    def ours(name):
        return any(k in name for k in KERNELS)

    seen = sum(c for n, c in p['count_by_name'].items() if ours(n))
    if not seen:
        return None
    total = sum(t for n, t in p['by_name'].items() if ours(n))
    device_s = total / seen * max(seen, launches())
    return 100.0 * sum(bound(c) for c in rec.slice_calls) / device_s
