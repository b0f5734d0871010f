"""Batch bucketing, copied from the JAX package's ``utils/batching.py``.

Kept for API parity only: the port runs eagerly and does not pad query
batches to buckets (the padding existed for ``jit`` shape caching).
"""

from __future__ import annotations

BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def bucket_size(n: int, buckets: tuple[int, ...] = BUCKETS) -> int:
    """Smallest bucket ≥ n (or round up to a multiple of the largest)."""
    if n <= 0:
        return buckets[0]
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top
