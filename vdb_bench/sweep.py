"""The rate sweep that fixes an open-loop cell's rate: for each seed one
index, built once, served the cell's mix at each rate in turn, in one
process. For each seed and rate: requests, their latency from the due time
(p50, p99, max), how late the senders ran, and the p99 of the window's
first and last quarters (a backlog that grows shows as a last quarter far
above the first). A refused or failed request misses every limit: it ranks
last and a percentile that falls on one reads ``inf`` (as
``readers.latency_ms`` counts it). One JSON line a seed and rate on
standard output.

    python3 -m vdb_bench.sweep --workload <open-loop cell> --seeds 7,8,9 \\
        --rates 1000,2000,3000 --seconds 51

The knee is the highest rate whose p99 meets the limit on every seed with
no growing backlog; the cell runs at about four fifths of it. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile

import numpy as np


def _pct(lat, q: float) -> float:
    """The ``q`` quantile (nearest rank) of ``lat``, ``inf`` counted."""
    if not len(lat):
        return float("nan")
    return float(np.sort(lat)[math.ceil(q * len(lat)) - 1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one index each")
    p.add_argument("--rates", required=True, help="comma-separated req/s")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    import torch

    from vdb_bench import harness, spec

    if not torch.cuda.is_available():
        print("vdb_bench.sweep: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    dev = torch.device("cuda")
    for seed in (int(v) for v in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="vdb-bench-") as data_path:
            engine = harness.build_engine(cell, data_path, dev, {})
            try:
                live = harness.set_up(cell, seed, dev, engine)
                harness.serve(live, cell.traffic, seed, harness.WARM_S, 0)
                for i, rate in enumerate(
                        float(r) for r in args.rates.split(",")):
                    mix = {**cell.traffic, "rate_per_s": rate}
                    served = harness.serve(live, mix, seed, args.seconds,
                                           10 + i)
                    print(json.dumps({"workload": cell.name, "seed": seed,
                                      "rate_per_s": rate,
                                      **_summary(served, args.seconds)}),
                          flush=True)
            finally:
                engine.close()
    return 0


def _summary(served: dict, seconds: float) -> dict:
    c, t0 = served["cols"], served["t0"]
    inside = c["t_due"] < t0 + seconds
    ok = c["status"] == 0
    lat = np.where(ok, (c["t_done"] - c["t_due"]) * 1e3, math.inf)[inside]
    due = (c["t_due"] - t0)[inside]
    q = seconds / 4
    late = (c["t_sent"] - c["t_due"])[inside] * 1e3
    return {"requests": int(inside.sum()),
            "failed": int((~ok[inside]).sum()), "ended": served["ended"],
            "p50_ms": _pct(lat, 0.5), "p99_ms": _pct(lat, 0.99),
            "max_ms": _pct(lat, 1.0),
            "p99_first_quarter_ms": _pct(lat[due < q], 0.99),
            "p99_last_quarter_ms": _pct(lat[due >= 3 * q], 0.99),
            "sender_late_p99_ms": _pct(late, 0.99)}


if __name__ == "__main__":
    raise SystemExit(main())
