"""Token-bucket rate limiter (S5, ``server/query_service.h:169-191``,
``query_service.cpp:639-677``): try/blocking acquire + dynamic rate update.
Unlike the reference's, it is actually wired into the Search path.

A copy of the JAX package's ``server/ratelimit.py`` (the port imports
nothing of that package).
"""

from __future__ import annotations

import threading
import time


class RateLimiter:
    def __init__(self, rate_per_s: float = 10000.0, burst: int = 200):
        self._rate = float(rate_per_s)
        self._burst = float(burst)
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = time.monotonic()
        self._tokens = min(
            self._burst, self._tokens + (now - self._last) * self._rate
        )
        self._last = now

    def try_acquire(self, n: int = 1) -> bool:
        with self._lock:
            self._refill()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def acquire(self, n: int = 1, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                self._refill()
                if self._tokens >= n:
                    self._tokens -= n
                    return True
                needed = (n - self._tokens) / self._rate
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                needed = min(needed, remaining)
            time.sleep(max(needed, 1e-4))

    def set_rate(self, rate_per_s: float, burst: int | None = None) -> None:
        with self._lock:
            self._refill()
            self._rate = float(rate_per_s)
            if burst is not None:
                self._burst = float(burst)
                self._tokens = min(self._tokens, self._burst)

    @property
    def rate(self) -> float:
        return self._rate
