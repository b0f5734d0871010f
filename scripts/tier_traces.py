#!/usr/bin/env python3
"""Where a batch of the tiers' harnesses spends its time, on the card.

Runs ``tools.streaming_bench`` with the given flags (its line printed),
then traces one warm search of its tier (device ms of each stage beside
the median of 5 host-to-host searches, and the idle share); then runs
``tools.pq_capacity`` on the same store at the pqcap-20M points
(``--rerank 0,256,512,512@0.3 --preload``; its lines printed) and, for
each point, traces two batches of its pipelined loop
(``search_batches_pipelined``: the ADC of the second overlaps the host
rerank of the first) beside twice the loop's pipelined batch time. Each
trace is taken in a ``utils/profiling.profiler_session`` and read only
when it kept 99% of its kernel launches as records
(``chip_smoke.trace_search``). Takes ``tools.streaming_bench``'s flags;
the capacity run shares ``--n``, ``--dim``, ``--nlist``, ``--nprobe``,
``--batch`` and ``--store-dir``. Without ``--store-dir`` the store is
written to a temporary directory and removed at the end (about n · dim
bytes of disk: 14.3 GiB at 20M × 768). Run from the repository root on a
machine with a card:

    python3 scripts/tier_traces.py --hot-clusters 32 --cache-frac 0.25
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (  # noqa: E402
    pq_capacity,
    streaming_bench,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (  # noqa: E402
    resolve_device,
)

PIPELINED_BATCHES = 2
RERANK_POINTS = "0,256,512,512@0.3"


class Pipelined:
    """``search`` runs ``PIPELINED_BATCHES`` copies of the batch through
    the index's pipelined loop (what ``trace_search`` traces)."""

    def __init__(self, idx):
        self.idx = idx

    def search(self, queries, params):
        out = None
        for out in self.idx.search_batches_pipelined(
                [queries] * PIPELINED_BATCHES, params):
            pass
        return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if any(a.split("=")[0] == "--store-dir" for a in argv):
        return traces(argv)
    with tempfile.TemporaryDirectory(prefix="tier_traces_") as sd:
        return traces(argv + ["--store-dir", sd])


def traces(argv) -> int:
    """The runs and traces of ``main`` with ``argv`` naming the store."""
    args = streaming_bench.parse_args(argv)
    dev = resolve_device(args.device)
    keep = {}
    print(json.dumps(streaming_bench.run(args, dev, keep=keep)), flush=True)
    tier, q, params = keep.pop("tier"), keep["queries"], keep["params"]
    ms, _ = chip_smoke.search_timed(tier, q, params, 5)
    trace = chip_smoke.trace_search(
        tier, q, params, float(np.median(ms)),
        stage_names=chip_smoke.STREAM_STAGES,
        kernel_stages=(chip_smoke.K1_KERNEL_STAGES
                       + chip_smoke.K3_KERNEL_STAGES))
    print(json.dumps({"stream_trace": {"scan_impl": args.scan_impl,
                                       "batch_ms": ms, **trace}}),
          flush=True)
    del tier
    shared = ["--n", str(args.n), "--dim", str(args.dim), "--nlist",
              str(args.nlist), "--nprobe", str(args.nprobe), "--batch",
              str(args.batch), "--store-dir", args.store_dir]
    if args.device is not None:
        shared += ["--device", args.device]
    pargs = pq_capacity.parse_args(shared + ["--rerank", RERANK_POINTS,
                                             "--preload"])
    keep = {}
    summary = pq_capacity.run(pargs, dev, keep=keep)
    print(json.dumps(summary), flush=True)
    for spec, point in zip(RERANK_POINTS.split(","), summary["points"]):
        name, _, _, params = pq_capacity.serve_point(
            keep["index"], pargs, spec, keep["reranker"])
        assert name == point["name"], (name, point["name"])
        trace = chip_smoke.trace_search(
            Pipelined(keep["index"]), keep["queries"], params,
            PIPELINED_BATCHES * point["batch_ms_pipelined"],
            stage_names=(chip_smoke.PQ_SEARCH_STAGES
                         + ("ivf_pq.host_rerank",)),
            kernel_stages=chip_smoke.K2_KERNEL_STAGES)
        print(json.dumps({"pqcap_trace": {"point": name,
                                          "batches": PIPELINED_BATCHES,
                                          **trace}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
