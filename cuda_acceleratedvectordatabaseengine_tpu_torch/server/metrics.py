"""Metrics: per-index latency percentiles, recall, throughput, device
memory and the serving stages, with a Prometheus ``/metrics`` and a JSON
``/health`` HTTP endpoint (port of the JAX package's ``server/metrics.py``).

The card's machine has no ``prometheus_client``, so this module keeps its
own histogram, counter and gauge families and renders the Prometheus text
format 0.0.4 itself, with the JAX collector's metric family names, label
names and sample lines (``_bucket`` / ``_count`` / ``_sum``, ``_total``,
``_created``). The stage percentiles (``record_stage``:
``decode``, ``queue_wait``, ``window_wait``, ``window_deadline``,
``window_cap``, ``dispatch``, ``handoff_wait``, ``fetch``, ``fetch_wait``,
``rerank``, ``encode``) are the serving layer's per-layer metrics. Of these,
``window_wait`` is the coalescer's wait in its window on the drain thread
(``window_deadline`` or ``window_cap`` beside it says whether the deadline
or the batch's cap ended it), ``handoff_wait`` the drain
thread's wait to hand a dispatched batch to the fetch thread,
``fetch_wait`` the fetch's wait for the card's work of a search, and
``rerank`` the device ms of an IVF-PQ search's exact rerank. Beside them
sit counts a search reports (:data:`COUNT_STAGES`, one sample a search:
``rerank_rows``, the rerank's candidates a query), kept in the same
windows and exported as ``vdb_stage_count``.
"""

from __future__ import annotations

import collections
import http.server
import json
import math
import threading
import time

import numpy as np

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"
# stage windows that hold counts, not milliseconds
COUNT_STAGES = ("rerank_rows",)


def _fmt(value: float) -> str:
    """A sample value as the Go client (and ``prometheus_client``) prints
    it: ``1.0``, ``+Inf``, ``1.2345e+010`` past six integer digits."""
    v = float(value)
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    s = repr(v)
    dot = s.find(".")
    if v > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _labels(names, values, extra=()) -> str:
    pairs = [f'{n}="{_escape_label(str(v))}"'
             for n, v in list(zip(names, values)) + list(extra)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Family:
    """One metric family: samples per label-value tuple, each with its
    creation time (the ``_created`` series of counters and histograms)."""

    def __init__(self, name: str, doc: str, labelnames=()):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, dict] = {}
        if not self.labelnames:
            self._child(())

    def _new(self) -> dict:
        raise NotImplementedError

    def _child(self, key: tuple) -> dict:
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new()
                child["created"] = time.time()
                self._children[key] = child
            return child

    def _key(self, kw) -> tuple:
        if set(kw) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(kw)} != "
                             f"{list(self.labelnames)}")
        return tuple(str(kw[n]) for n in self.labelnames)

    def _header(self, name: str, kind: str) -> list[str]:
        return [f"# HELP {name} {_escape_help(self.doc)}",
                f"# TYPE {name} {kind}"]

    def _created_lines(self, base: str) -> list[str]:
        with self._lock:
            items = list(self._children.items())
        if not items:
            return []
        return self._header(f"{base}_created", "gauge") + [
            f"{base}_created{_labels(self.labelnames, key)} "
            f"{_fmt(child['created'])}" for key, child in items]


class Histogram(_Family):
    def __init__(self, name, doc, labelnames=(), buckets=()):
        self.buckets = tuple(float(b) for b in buckets) + (math.inf,)
        super().__init__(name, doc, labelnames)

    def _new(self) -> dict:
        return {"counts": [0.0] * len(self.buckets), "sum": 0.0}

    def observe(self, value: float, **labels) -> None:
        child = self._child(self._key(labels))
        with self._lock:
            for i, b in enumerate(self.buckets):
                if value <= b:
                    child["counts"][i] += 1.0
            child["sum"] += value

    def render(self) -> list[str]:
        lines = self._header(self.name, "histogram")
        with self._lock:
            items = [(k, list(c["counts"]), c["sum"])
                     for k, c in self._children.items()]
        for key, counts, total in items:
            for b, c in zip(self.buckets, counts):
                le = (("le", _fmt(b)),)
                lines.append(f"{self.name}_bucket"
                             f"{_labels(self.labelnames, key, le)} {_fmt(c)}")
            lines.append(f"{self.name}_count{_labels(self.labelnames, key)} "
                         f"{_fmt(counts[-1])}")
            lines.append(f"{self.name}_sum{_labels(self.labelnames, key)} "
                         f"{_fmt(total)}")
        return lines + self._created_lines(self.name)


class Counter(_Family):
    def __init__(self, name, doc, labelnames=()):
        # the family is named without ``_total``, its sample with it
        self.base = name[:-len("_total")] if name.endswith("_total") else name
        super().__init__(name, doc, labelnames)

    def _new(self) -> dict:
        return {"value": 0.0}

    def inc(self, amount: float = 1.0, **labels) -> None:
        child = self._child(self._key(labels))
        with self._lock:
            child["value"] += amount

    def render(self) -> list[str]:
        lines = self._header(f"{self.base}_total", "counter")
        with self._lock:
            items = [(k, c["value"]) for k, c in self._children.items()]
        lines += [f"{self.base}_total{_labels(self.labelnames, key)} "
                  f"{_fmt(v)}" for key, v in items]
        return lines + self._created_lines(self.base)


class Gauge(_Family):
    def _new(self) -> dict:
        return {"value": 0.0}

    def set(self, value: float, **labels) -> None:
        child = self._child(self._key(labels))
        with self._lock:
            child["value"] = float(value)

    def render(self) -> list[str]:
        lines = self._header(self.name, "gauge")
        with self._lock:
            items = [(k, c["value"]) for k, c in self._children.items()]
        return lines + [f"{self.name}{_labels(self.labelnames, key)} "
                        f"{_fmt(v)}" for key, v in items]


class MetricsCollector:
    MAX_SAMPLES = 10_000   # bounded percentile windows

    def __init__(self):
        self._lock = threading.Lock()
        self._latencies: dict[str, collections.deque] = {}
        self._stages: dict[str, collections.deque] = {}
        self._recalls: dict[str, collections.deque] = {}
        self._search_counts: dict[str, int] = {}
        self._started = time.monotonic()
        self._total_queries = 0

        self.h_latency = Histogram(
            "vdb_search_duration_milliseconds", "Search latency (ms)",
            ["index"],
            buckets=(0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500, 1000),
        )
        self.c_searches = Counter(
            "vdb_searches_total", "Total searches", ["index"],
        )
        self.g_device_mem = Gauge(
            "vdb_gpu_memory_bytes", "Device HBM bytes used by indices",
        )
        self.g_qps = Gauge(
            "vdb_queries_per_second", "Uptime-average QPS",
        )
        self.g_nvme_bw = Gauge(
            "vdb_nvme_bandwidth_bytes", "Host storage read bandwidth",
        )
        self.g_recall = Gauge(
            "vdb_search_recall", "Sampled recall@k", ["index"],
        )
        self._families = (self.h_latency, self.c_searches, self.g_device_mem,
                          self.g_qps, self.g_nvme_bw, self.g_recall)

    # ------------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------------ #

    def record_search(self, index: str, latency_ms: float,
                      n_queries: int = 1) -> None:
        with self._lock:
            buf = self._latencies.setdefault(
                index, collections.deque(maxlen=self.MAX_SAMPLES)
            )
            buf.append(latency_ms)
            self._search_counts[index] = (
                self._search_counts.get(index, 0) + 1
            )
            self._total_queries += n_queries
            elapsed = max(time.monotonic() - self._started, 1e-9)
            self.g_qps.set(self._total_queries / elapsed)
        self.h_latency.observe(latency_ms, index=index)
        self.c_searches.inc(index=index)

    def record_stage(self, stage: str, ms: float) -> None:
        """Per-stage serving span (decode / queue_wait / window_wait /
        dispatch / handoff_wait / fetch / fetch_wait / rerank / encode):
        the decomposition of server-side request latency; or, for a name
        of :data:`COUNT_STAGES`, a count one search reported. Beside each
        ``window_wait`` the drain records how its window ended:
        ``window_deadline`` (waited out) or ``window_cap`` (closed, or never
        opened, because the batch's cap was queued)."""
        with self._lock:
            self._stages.setdefault(
                stage, collections.deque(maxlen=self.MAX_SAMPLES)
            ).append(ms)

    def get_stage_percentiles(self) -> dict:
        """{stage: {p50, p95, p99, max, mean, count}} over the sample
        window (``max`` shows the rare stalls a p99 hides)."""
        with self._lock:
            snap = {k: np.asarray(v) for k, v in self._stages.items() if v}
        return {
            k: {
                "p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "p99": float(np.percentile(a, 99)),
                "max": float(a.max()),
                "mean": float(a.mean()),
                "count": int(a.size),
            }
            for k, a in snap.items()
        }

    def reset_windows(self, index: str | None = None) -> None:
        """Clear the bounded percentile windows (per-index latency when
        ``index`` is given, else all) and the stage spans, so a measurement
        reads its own percentiles. Counters and histograms are untouched."""
        with self._lock:
            if index is None:
                self._latencies.clear()
            else:
                self._latencies.pop(index, None)
            self._stages.clear()

    def record_recall(self, index: str, recall: float) -> None:
        with self._lock:
            buf = self._recalls.setdefault(
                index, collections.deque(maxlen=self.MAX_SAMPLES)
            )
            buf.append(recall)
        self.g_recall.set(recall, index=index)

    def set_device_memory(self, nbytes: int) -> None:
        self.g_device_mem.set(nbytes)

    def set_storage_bandwidth(self, bytes_per_s: float) -> None:
        self.g_nvme_bw.set(bytes_per_s)

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #

    def get_percentiles(self, index: str) -> dict:
        with self._lock:
            buf = self._latencies.get(index)
            if not buf:
                return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "count": 0}
            arr = np.asarray(buf)
        return {
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "p99": float(np.percentile(arr, 99)),
            "count": int(self._search_counts.get(index, 0)),
        }

    def get_avg_recall(self, index: str) -> float:
        with self._lock:
            buf = self._recalls.get(index)
            return float(np.mean(buf)) if buf else 0.0

    def uptime_qps(self) -> float:
        with self._lock:
            elapsed = max(time.monotonic() - self._started, 1e-9)
            return self._total_queries / elapsed

    # ------------------------------------------------------------------ #
    # exposition
    # ------------------------------------------------------------------ #

    def prometheus_text(self) -> bytes:
        lines = []
        for fam in self._families:
            lines += fam.render()
        stages = self.get_stage_percentiles()
        for family, help_, counts in (
                ("vdb_stage_milliseconds",
                 "Serving stage latency decomposition", False),
                ("vdb_stage_count", "Counts a search reports", True)):
            chosen = sorted((k, q) for k, q in stages.items()
                            if (k in COUNT_STAGES) == counts)
            if chosen:
                lines += [f"# TYPE {family} gauge",
                          f"# HELP {family} {help_}"]
            for stage, q in chosen:
                for stat in ("p50", "p95", "p99", "max", "mean"):
                    lines.append(
                        f'{family}{{stage="{stage}",'
                        f'stat="{stat}"}} {q[stat]:.4f}'
                    )
                lines.append(
                    f'vdb_stage_samples{{stage="{stage}"}} {q["count"]}'
                )
        return ("\n".join(lines) + "\n").encode()

    def start_exposition(self, port: int, health_fn=None) -> int:
        """``/metrics`` (Prometheus text) and ``/health`` HTTP endpoints.
        ``health_fn`` (optional) returns a dict snapshot, typically
        :meth:`HealthServicer.snapshot`, rendered as JSON with HTTP 200 when
        ``healthy`` else 503. Returns the bound port (``port=0`` picks
        one)."""
        collector = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = collector.prometheus_text()
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE_LATEST)
                elif path == "/health":
                    snap = health_fn() if health_fn else {"healthy": True}
                    snap = dict(snap)
                    snap.setdefault("healthy", True)
                    snap["status"] = (
                        "healthy" if snap["healthy"] else "unhealthy"
                    )
                    snap["uptime_s"] = round(
                        time.monotonic() - collector._started, 3
                    )
                    body = (json.dumps(snap) + "\n").encode()
                    self.send_response(200 if snap["healthy"] else 503)
                    self.send_header("Content-Type", "application/json")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet — structured logs only
                pass

        self._http = http.server.ThreadingHTTPServer(("", port), Handler)
        self._http.daemon_threads = True
        threading.Thread(
            target=self._http.serve_forever, name="vdb-metrics-http",
            daemon=True,
        ).start()
        return self._http.server_address[1]

    def stop_exposition(self) -> None:
        srv = getattr(self, "_http", None)
        if srv is not None:
            srv.shutdown()
            srv.server_close()
            self._http = None
