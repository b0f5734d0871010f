"""Prefetchers: access-pattern readahead, hotness-scored inverted-list
prefetch, and the throttled staging scheduler.

Copies of ``AdaptivePrefetcher`` (with ``AccessPattern``),
``ListPrefetcher`` and ``PrefetchScheduler`` from the JAX package's
``io_host/prefetcher.py`` (that module imports no JAX, but the port imports
nothing of the JAX package). ``AdaptivePrefetcher`` classifies each file's
read offsets (sequential, strided, random) and asks its reader
(``storage.shard_store.AlignedReader``) to prefetch the predicted next
blocks. The streaming tier feeds ``ListPrefetcher`` every search's probe
table and stages its hottest lists back into the device cache on request
(``StreamingIVFFlatIndex.prefetch_hot_lists``); the serving engine queues
that re-staging into ``PrefetchScheduler``, a priority queue with
pause / resume and a byte-rate throttle.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import heapq
import itertools
import threading
import time


class AccessPattern(enum.Enum):
    SEQUENTIAL = "sequential"
    STRIDED = "strided"
    RANDOM = "random"


class AdaptivePrefetcher:
    """Per-file access-history classifier and next-access predictor: keeps
    the last :attr:`HISTORY` offsets per file, takes the most common stride,
    classifies sequential / strided / random with a consistency score, and
    has the reader prefetch the predicted next ``prefetch_depth``
    accesses."""

    HISTORY = 100
    MIN_SAMPLES = 4

    def __init__(self, reader=None, prefetch_depth: int = 4,
                 block_size: int = 1 << 20):
        self.reader = reader
        self.prefetch_depth = prefetch_depth
        self.block_size = block_size
        self._hist: dict[str, collections.deque] = {}
        self._lock = threading.Lock()
        self.prefetches_issued = 0

    def record_access(self, path: str, offset: int) -> None:
        with self._lock:
            self._hist.setdefault(
                path, collections.deque(maxlen=self.HISTORY)
            ).append(offset)
        pattern, stride, _ = self.classify(path)
        if pattern != AccessPattern.RANDOM:
            self._issue(path, offset, stride)

    def classify(self, path: str) -> tuple[AccessPattern, int, float]:
        """Returns (pattern, dominant stride, consistency score 0..1)."""
        with self._lock:
            hist = list(self._hist.get(path, ()))
        if len(hist) < self.MIN_SAMPLES:
            return AccessPattern.RANDOM, 0, 0.0
        strides = [b - a for a, b in zip(hist, hist[1:])]
        counter = collections.Counter(strides)
        stride, freq = counter.most_common(1)[0]
        consistency = freq / len(strides)
        if consistency < 0.5 or stride == 0:
            return AccessPattern.RANDOM, 0, consistency
        if stride == self.block_size or 0 < stride <= self.block_size:
            return AccessPattern.SEQUENTIAL, stride, consistency
        return AccessPattern.STRIDED, stride, consistency

    def _issue(self, path: str, offset: int, stride: int) -> None:
        if self.reader is None or stride == 0:
            return
        for i in range(1, self.prefetch_depth + 1):
            nxt = offset + i * stride
            if nxt >= 0:
                self.reader.prefetch(path, nxt, abs(stride))
                with self._lock:
                    self.prefetches_issued += 1


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


@dataclasses.dataclass(order=True)
class _Task:
    neg_priority: int
    seq: int
    fn: object = dataclasses.field(compare=False)
    nbytes: int = dataclasses.field(compare=False, default=0)


class PrefetchScheduler:
    """Priority prefetch queue with pause/resume and byte-rate throttling
    (default limit 10 GB/s). One worker thread runs the queued staging
    calls, highest priority first; a failing call is dropped (prefetch is
    best-effort: a search stages what it misses itself)."""

    def __init__(self, bandwidth_limit_bps: float = 10e9):
        self.bandwidth_limit_bps = bandwidth_limit_bps
        self._heap: list[_Task] = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._paused = False
        self._stop = False
        self._bytes_window = 0.0
        self._window_start = time.monotonic()
        self.completed = 0
        self._worker = threading.Thread(
            target=self._loop, name="prefetch-scheduler", daemon=True
        )
        self._worker.start()

    def schedule(self, fn, priority: int = 0, nbytes: int = 0) -> None:
        with self._cv:
            if self._stop:
                raise RuntimeError("scheduler stopped")
            heapq.heappush(
                self._heap, _Task(-priority, next(self._seq), fn, nbytes)
            )
            self._cv.notify()

    def pause(self) -> None:
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=5)

    def _throttle(self, nbytes: int) -> None:
        now = time.monotonic()
        if now - self._window_start >= 1.0:
            self._window_start = now
            self._bytes_window = 0.0
        self._bytes_window += nbytes
        over = self._bytes_window / self.bandwidth_limit_bps - (
            now - self._window_start
        )
        if over > 0:
            time.sleep(min(over, 1.0))

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._heap or self._paused) and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                task = heapq.heappop(self._heap)
            try:
                if task.nbytes:
                    self._throttle(task.nbytes)
                task.fn()
            except Exception:  # noqa: BLE001 — prefetch is best-effort
                pass
            finally:
                self.completed += 1
