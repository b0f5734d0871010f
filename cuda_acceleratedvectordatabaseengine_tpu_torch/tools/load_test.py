"""Concurrent gRPC load-test client (port of the JAX package's
``tools/load_test.py``; the reference's ``test/integration/load_test.cpp``):
N threads × M random-query requests against a live server, unary, packed
or streamed; reports QPS, success rate, latency percentiles, the
reference's qualitative rubric (<10 ms excellent / <50 ms good / <100 ms
acceptable) and, with ``--metrics-url``, the server's serving-stage
decomposition of this run. It speaks only gRPC (and HTTP for the metrics):
it runs no search itself and needs no device.

    python -m cuda_acceleratedvectordatabaseengine_tpu_torch.tools.load_test \
        --target 127.0.0.1:50051 --dimension 768 --threads 32 --packed
"""

from __future__ import annotations

import argparse
import json
import re
import threading
import time
import urllib.request

import grpc
import numpy as np


def parse_stage_metrics(text: str) -> dict:
    """Parse ``vdb_stage_milliseconds{stage=...,stat=...}`` lines from the
    server's /metrics exposition into ``{stage: {stat: ms, count: n}}`` —
    the serving-stage decomposition (decode / queue_wait / dispatch /
    fetch / encode)."""
    stages: dict = {}
    pat = re.compile(
        r'vdb_stage_(milliseconds|samples)\{stage="([^"]+)"'
        r'(?:,stat="([^"]+)")?\}\s+([0-9.eE+-]+)'
    )
    for m in pat.finditer(text):
        kind, stage, stat, val = m.groups()
        d = stages.setdefault(stage, {})
        if kind == "samples":
            d["count"] = int(float(val))
        else:
            d[stat] = float(val)
    return stages


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="gRPC load test")
    p.add_argument("--target", default="127.0.0.1:50051")
    p.add_argument("--index", default="default")
    p.add_argument("--dimension", type=int, default=128)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--requests", type=int, default=100)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--nprobe", type=int, default=8)
    p.add_argument("--batch", type=int, default=1,
                   help="queries per request")
    p.add_argument("--packed", action="store_true",
                   help="use packed_queries/packed_response bytes instead "
                        "of repeated Vector messages (cuts python-proto "
                        "serialization ~30x at dim 768)")
    p.add_argument("--stream", action="store_true",
                   help="send each thread's requests through ONE "
                        "StreamSearch bidirectional stream (pipelined "
                        "through the coalescer) instead of per-request "
                        "unary RPCs")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="per-RPC deadline in seconds (a whole stream "
                        "counts as one RPC)")
    p.add_argument("--metrics-url", default="",
                   help="server /metrics URL; when given, the report "
                        "embeds THIS run's serving-stage decomposition "
                        "(the stage windows are reset before the run via "
                        "GetStats reset)")
    args = p.parse_args(argv)

    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.grpc_api import (
        AdminServiceClient,
        QueryServiceClient,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.proto import (
        vdb_pb2,
    )

    channel = grpc.insecure_channel(args.target)
    grpc.channel_ready_future(channel).result(timeout=10)
    client = QueryServiceClient(channel)
    admin = AdminServiceClient(channel)
    # Isolate this run's server-side percentiles: clear the latency / stage
    # sample windows first, so server_p50 is THIS scenario's, not the
    # previous one's (a preceding warm-up pass would pollute it).
    try:
        admin.GetStats(vdb_pb2.StatsRequest(index=args.index, reset=True))
    except grpc.RpcError:
        pass

    latencies: list[float] = []
    # (start offset from run start [s], latency [ms]) per request — the
    # stall-timeline evidence: if slow requests cluster at the same
    # wall-clock offsets across scenarios regardless of wire format, the
    # tail is environmental, not a code path's.
    samples: list[tuple[float, float]] = []
    errors: list[str] = []
    error_times: list[float] = []
    lock = threading.Lock()
    run_start = time.monotonic()

    def make_request(local_rng):
        if args.packed:
            return vdb_pb2.SearchRequest(
                packed_queries=local_rng.standard_normal(
                    (args.batch, args.dimension)
                ).astype("<f4").tobytes(),
                packed_response=True,
                topk=args.topk, nprobe=args.nprobe, index=args.index,
            )
        return vdb_pb2.SearchRequest(
            queries=[
                vdb_pb2.Vector(values=local_rng.standard_normal(
                    args.dimension).astype(float))
                for _ in range(args.batch)
            ],
            topk=args.topk, nprobe=args.nprobe, index=args.index,
        )

    def worker(tid: int):
        local_rng = np.random.default_rng(tid)
        for _ in range(args.requests):
            req = make_request(local_rng)
            t0 = time.monotonic()
            try:
                client.Search(req, timeout=args.timeout)
                ok = True
            except grpc.RpcError as e:
                ok = False
                with lock:
                    errors.append(str(e.code()))
                    error_times.append(t0 - run_start)
            if ok:
                lat_ms = (time.monotonic() - t0) * 1000
                with lock:
                    latencies.append(lat_ms)
                    samples.append((t0 - run_start, lat_ms))

    def stream_worker(tid: int):
        """One StreamSearch per thread: requests pipeline server-side (up
        to the server's stream_window are in flight), responses arrive in
        order. Per-request latency = send→receive, so it includes queue
        wait under pipelining — the honest number."""
        local_rng = np.random.default_rng(tid)
        send_times: list[float] = []

        def gen():
            for _ in range(args.requests):
                req = make_request(local_rng)
                send_times.append(time.monotonic())
                yield req

        got = 0
        try:
            for _resp in client.StreamSearch(gen(), timeout=args.timeout):
                lat = (time.monotonic() - send_times[got]) * 1000
                t_send = send_times[got] - run_start
                got += 1
                with lock:
                    latencies.append(lat)
                    samples.append((t_send, lat))
        except grpc.RpcError as e:
            with lock:
                errors.extend([str(e.code())] * (args.requests - got))

    t0 = time.time()
    target_fn = stream_worker if args.stream else worker
    threads = [
        threading.Thread(target=target_fn, args=(i,))
        for i in range(args.threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0

    total = args.threads * args.requests
    lat = np.asarray(latencies) if latencies else np.zeros(1)
    avg = float(lat.mean())
    rubric = ("excellent" if avg < 10 else "good" if avg < 50
              else "acceptable" if avg < 100 else "poor")
    report = {
        "requests": total,
        "packed_wire": bool(args.packed),
        "stream": bool(args.stream),
        "batch": args.batch,
        "success_rate": len(latencies) / total,
        # successful queries only — failed requests must not inflate QPS
        "qps": round(len(latencies) * args.batch / wall, 1),
        "avg_ms": round(avg, 2),
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p95_ms": round(float(np.percentile(lat, 95)), 2),
        "p99_ms": round(float(np.percentile(lat, 99)), 2),
        "rubric": rubric,
        "errors": errors[:5],
        "n_errors": len(errors),
        "error_times_s": [round(t, 1) for t in error_times[:50]],
    }
    # Stall timeline: requests >= max(3x p50, 200 ms), as (start-offset s,
    # latency ms). Clustered offsets shared across scenarios = external
    # stall windows; uniform spread = a genuine code-path cost.
    p50 = float(np.percentile(lat, 50))
    slow = [
        (round(off, 1), round(ms)) for off, ms in samples
        if ms >= max(3 * p50, 200.0)
    ]
    report["n_slow"] = len(slow)
    report["slow_requests"] = slow[:50]
    # Server-side per-request percentiles (StatsResponse extension):
    # excludes client proto serialization / GIL / wire time — on shared-CPU
    # test hosts the client side dominates the client-observed numbers.
    try:
        stats = admin.GetStats(vdb_pb2.StatsRequest(index=args.index))
        report["server_p50_ms"] = round(stats.latency_p50_ms, 2)
        report["server_p95_ms"] = round(stats.latency_p95_ms, 2)
        report["server_p99_ms"] = round(stats.latency_p99_ms, 2)
    except grpc.RpcError:
        pass
    if args.metrics_url:
        # THIS run's serving-stage decomposition (the windows were reset
        # above, so the spans cover exactly this scenario's requests).
        try:
            with urllib.request.urlopen(args.metrics_url, timeout=5) as r:
                report["server_stages_ms"] = parse_stage_metrics(
                    r.read().decode()
                )
        except OSError:
            pass
    print(json.dumps(report, indent=2))
    return 0 if report["success_rate"] >= 0.8 else 1


if __name__ == "__main__":
    raise SystemExit(main())
