"""The one traffic generator: a mix file (``traffic/<name>.json``) read into
a schedule, and the callers that drive the engine with it.

A mix file holds parameters only:

- ``loop``: ``"closed"`` (each of ``callers`` sends its next request when
  the last is answered) or ``"open"`` (Poisson arrivals at ``rate_per_s``,
  issued by a pool of ``workers`` threads, as the gRPC server's worker pool
  takes requests off the wire);
- ``queries_per_request`` and ``k``.

Which pool queries a request carries, and when an open-loop request is due,
come from the seed. Every seed gives the same sizes and, in the open loop,
the same number of arrivals (a Poisson process conditioned on its count:
``round(rate · seconds)`` arrival times drawn uniformly over the window),
in another order. An open-loop request is timed from its due time, so a
stall counts against every request it delays; a closed-loop request from
its send.
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from vdb_bench.corpus import stream_seeds



class Schedule:
    """The requests of one phase (warm-up or window) of a run."""

    def __init__(self, traffic: dict, pool_size: int, seed: int,
                 seconds: float, phase: int):
        self.loop = traffic["loop"]
        if self.loop not in ("closed", "open"):
            raise ValueError(f"traffic loop {self.loop!r}: closed | open")
        self.per_request = int(traffic["queries_per_request"])
        self.k = int(traffic["k"])
        self.seconds = float(seconds)
        rng = np.random.default_rng([stream_seeds(seed)["traffic"], phase])
        self._order = rng.permutation(pool_size)
        self.threads = int(traffic["callers"] if self.loop == "closed"
                           else traffic["workers"])
        self.arrivals = None
        if self.loop == "open":
            n = int(round(float(traffic["rate_per_s"]) * self.seconds))
            self.arrivals = np.sort(rng.uniform(0.0, self.seconds, n))

    def pool_rows(self, i: int) -> np.ndarray:
        """Pool rows of request ``i``: the seeded order of the pool, read
        ``queries_per_request`` at a time, round and round."""
        j = (i * self.per_request + np.arange(self.per_request)) \
            % self._order.size
        return self._order[j]


OK, REFUSED, ERROR = 0, 1, 2     # a request's status


class Log:
    """Every request of a phase, in columns of numpy arrays indexed by
    request number, filled by the callers as answers come. The callers
    keep no Python object per request: tens of thousands of them would
    make the interpreter's collector pause for 0.1–0.2 s at a time (seen
    on an H100's host at 61,200 requests), stalling the engine, which
    shares the interpreter. Rows are allocated :data:`CHUNK` requests at
    a time."""

    CHUNK = 4096
    COLUMNS = {"t_due": "f8", "t_sent": "f8", "t_done": "f8",
               "status": "i1", "got": "i4", "filled": "?"}

    def __init__(self, per_request: int, k: int):
        self.per_request, self.k = per_request, k
        self.notes: dict[int, str] = {}     # request → why it failed
        self._chunks: list[dict] = []
        self._lock = threading.Lock()

    def _slot(self, i: int) -> tuple[dict, int]:
        c, j = divmod(i, self.CHUNK)
        while len(self._chunks) <= c:
            with self._lock:
                if len(self._chunks) <= c:
                    n, m, k = self.CHUNK, self.per_request, self.k
                    chunk = {name: np.zeros(n, dt)
                             for name, dt in self.COLUMNS.items()}
                    chunk.update(rows=np.zeros((n, m), np.int64),
                                 d=np.zeros((n, m, k), np.float32),
                                 ids=np.zeros((n, m, k), np.uint64))
                    self._chunks.append(chunk)
        return self._chunks[c], j

    def put(self, i, rows, t_due, t_sent, t_done, status, answer, note):
        chunk, j = self._slot(i)
        chunk["rows"][j] = rows
        chunk["t_due"][j], chunk["t_sent"][j] = t_due, t_sent
        chunk["t_done"][j] = t_done
        if status == OK:
            d, ids = (np.asarray(a) for a in answer)
            m = d.shape[0] if d.ndim == 2 else -1
            if (d.shape != ids.shape or d.ndim != 2
                    or d.shape[1] != self.k or m > self.per_request):
                status, note = ERROR, f"answer of shape {d.shape}"
            else:
                chunk["d"][j, :m], chunk["ids"][j, :m] = d, ids
                chunk["got"][j] = m
        if note:
            self.notes[i] = note
        chunk["status"][j] = status
        chunk["filled"][j] = True

    def columns(self) -> dict:
        """The filled requests' columns, in order of request number, with
        ``request`` (the numbers)."""
        if not self._chunks:
            return {"request": np.zeros(0, np.int64),
                    **{n: np.zeros(0, dt) for n, dt in self.COLUMNS.items()},
                    "rows": np.zeros((0, self.per_request), np.int64),
                    "d": np.zeros((0, self.per_request, self.k), np.float32),
                    "ids": np.zeros((0, self.per_request, self.k),
                                    np.uint64)}
        out = {n: np.concatenate([c[n] for c in self._chunks])
               for n in self._chunks[0]}
        keep = out["filled"]
        out = {n: a[keep] for n, a in out.items()}
        out["request"] = np.flatnonzero(keep)
        return out


def send(engine, name, queries, params):
    """One request through the calls the servicer makes once it has decoded
    it: ``get_state``, ``submit_search`` (admission, the coalescer),
    ``finish_search``. Returns ``(status, answer, note)``."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.service \
        import Rejected

    t0 = time.monotonic()
    try:
        st = engine.get_state(name)
        fut = engine.submit_search(st, queries, params)
        return OK, engine.finish_search(fut, name, t0, len(queries)), ""
    except Rejected as e:
        return REFUSED, None, f"{e.code}: {e.message}"
    except Exception as e:  # noqa: BLE001 — a failed answer, judged later
        return ERROR, None, f"{type(e).__name__}: {e}"


def drive(engine, name, params, pool: np.ndarray, sched: Schedule,
          t0: float):
    """Start the callers of ``sched`` against the engine from ``t0``
    (``perf_counter``); returns their threads and the :class:`Log` they
    fill. Closed loop: a caller sends until ``t0 + seconds``; open loop:
    every arrival is sent, however late, and the callers end when all are
    answered."""
    out = Log(sched.per_request, sched.k)
    nxt = itertools.count()
    t_end = t0 + sched.seconds

    def one(i, t_due):
        rows = sched.pool_rows(i)
        t_sent = time.perf_counter()
        status, answer, note = send(engine, name, pool[rows], params)
        out.put(i, rows, t_due, t_sent, time.perf_counter(), status,
                answer, note)

    def closed_caller():
        while True:
            i = next(nxt)
            now = time.perf_counter()
            if now >= t_end:
                return
            one(i, now)

    def open_worker():
        while True:
            i = next(nxt)
            if i >= sched.arrivals.size:
                return
            t_due = t0 + sched.arrivals[i]
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            one(i, t_due)

    target = closed_caller if sched.loop == "closed" else open_worker
    threads = [threading.Thread(target=target, name=f"vdb-bench-{j}",
                                daemon=True) for j in range(sched.threads)]
    for t in threads:
        t.start()
    return threads, out


def join(threads, deadline_s: float) -> bool:
    """Wait for the callers, at most ``deadline_s`` in all; whether every
    one ended."""
    t_stop = time.perf_counter() + deadline_s
    for t in threads:
        t.join(timeout=max(t_stop - time.perf_counter(), 0.0))
    return not any(t.is_alive() for t in threads)
