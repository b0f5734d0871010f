"""Hotness-scored inverted-list prefetch for the streaming tier.

A copy of ``ListPrefetcher`` from the JAX package's
``io_host/prefetcher.py`` (that module imports no JAX, but the port imports
nothing of the JAX package). The streaming tier feeds it every search's
probe table and stages its hottest lists back into the device cache on
request (``StreamingIVFFlatIndex.prefetch_hot_lists``). The JAX module's
``AdaptivePrefetcher`` and ``PrefetchScheduler`` belong to the serving
layer and are not ported yet.
"""

from __future__ import annotations

import threading
import time


class ListPrefetcher:
    """Hotness-scored inverted-list prefetch: per-list access counts with
    recency decay; the hottest lists whose decayed count reaches
    ``min_accesses`` are staged through ``stage_fn`` (the device cache).

    The JAX package's class also takes a relative ``hot_threshold`` that it
    never reads; the port leaves it out."""

    def __init__(self, stage_fn=None, half_life_s: float = 60.0,
                 min_accesses: float = 2.0):
        self.stage_fn = stage_fn
        self.half_life_s = half_life_s
        # Absolute staging floor (decayed accesses). Staging exists to
        # recover a WORKING SET; a relative threshold (score ≥ 0.7 × the
        # hottest list) starves recovery whenever probe counts across the
        # hot set vary >1.4×. The floor keeps the intent (don't burn
        # staging bandwidth on one-off cold touches) without coupling one
        # list's fate to another's popularity.
        self.min_accesses = min_accesses
        self._lock = threading.Lock()
        self._counts: dict[int, float] = {}
        self._last: dict[int, float] = {}

    def record_access(self, list_id: int, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            prev = self._decayed(list_id, now)
            self._counts[list_id] = prev + n
            self._last[list_id] = now

    def record_many(self, list_ids, counts) -> None:
        """Bulk accounting for one search batch's probe table (one lock
        acquisition instead of B·nprobe) — the feed the serving path uses
        (``io_host/streaming.StreamingIVFFlatIndex.search``)."""
        now = time.monotonic()
        with self._lock:
            for lid, n in zip(list_ids, counts):
                lid = int(lid)
                prev = self._decayed(lid, now)
                self._counts[lid] = prev + int(n)
                self._last[lid] = now

    def _decayed(self, list_id: int, now: float) -> float:
        c = self._counts.get(list_id, 0.0)
        last = self._last.get(list_id, now)
        return c * 0.5 ** ((now - last) / self.half_life_s)

    def hotness(self, list_id: int) -> float:
        """Normalized 0..1 score (count with recency decay / max)."""
        now = time.monotonic()
        with self._lock:
            mine = self._decayed(list_id, now)
            peak = max(
                (self._decayed(l, now) for l in self._counts), default=0.0
            )
        return mine / peak if peak > 0 else 0.0

    def get_hot_lists(self, n: int) -> list[int]:
        now = time.monotonic()
        with self._lock:
            scored = sorted(
                self._counts,
                key=lambda l: -self._decayed(l, now),
            )
        return scored[:n]

    def prefetch_hot_lists(self, max_lists: int = 64) -> list[int]:
        now = time.monotonic()
        with self._lock:
            scored = sorted(
                ((self._decayed(l, now), l) for l in self._counts),
                reverse=True,
            )
        hot = [
            l for score, l in scored[:max_lists]
            if score >= self.min_accesses
        ]
        if hot and self.stage_fn is not None:
            self.stage_fn(hot)
        return hot
