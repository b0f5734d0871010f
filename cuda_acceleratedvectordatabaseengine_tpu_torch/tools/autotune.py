"""Measured search-parameter autotuner CLI (port of the JAX package's
``tools/autotune.py``).

Loads a built snapshot, measures the probe coverage curve on held-out (or
sampled stored) queries through the index's ``calibrate_nprobe``, picks the
smallest ``nprobe`` meeting the coverage target, and optionally times
throughput at that point. The JSON report can be dropped into
``SearchParams``; ``--persist`` writes the tuned value into the snapshot's
manifest, so a server recovering the epoch serves ``nprobe=0`` with it.

Usage:
    python -m cuda_acceleratedvectordatabaseengine_tpu_torch.tools.autotune \\
        --snapshot /data/snap [--queries q.npy] [--target-coverage 0.99] \\
        [--k 10] [--measure-qps] [--batch 512] [--persist] [--output -]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _reference_static_nprobe(ntotal: int) -> int:
    """The reference's static tier table (its README's tuning section)."""
    if ntotal < 1_000_000:
        return 16
    if ntotal <= 100_000_000:
        return 32
    return 64


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Search-parameter autotuner")
    p.add_argument("--snapshot", required=True,
                   help="index snapshot directory (IVFFlatIndex.save)")
    p.add_argument("--queries", default="",
                   help=".npy file of held-out queries [n, dim]; default "
                        "samples stored rows (slightly optimistic)")
    p.add_argument("--target-coverage", type=float, default=0.99)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--sample", type=int, default=512,
                   help="stored-row sample size when no --queries given")
    p.add_argument("--candidates", type=int, nargs="+",
                   default=[4, 8, 12, 16, 24, 32, 48, 64, 96, 128])
    p.add_argument("--measure-qps", action="store_true",
                   help="time throughput at the recommended nprobe")
    p.add_argument("--batch", type=int, default=512,
                   help="query batch size for --measure-qps")
    p.add_argument("--qps-batches", type=int, default=8)
    p.add_argument("--persist", action="store_true",
                   help="write the calibrated nprobe into the snapshot's "
                        "manifest so servers recovering this epoch serve "
                        "nprobe=0 requests with the tuned value")
    p.add_argument("--output", default="-",
                   help="JSON output path, '-' = stdout")
    p.add_argument("--device", default=None,
                   help="device to load the snapshot on (default: cuda)")
    args = p.parse_args(argv)

    from cuda_acceleratedvectordatabaseengine_tpu_torch import (
        IVFFlatIndex,
        IVFPQIndex,
        SearchParams,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.manifest \
        import IndexManifest

    man = IndexManifest.load(args.snapshot)
    if man.kind == "ivf_flat":
        idx = IVFFlatIndex.load(args.snapshot, device=args.device)
    elif man.kind == "ivf_pq":
        idx = IVFPQIndex.load(args.snapshot, device=args.device)
    else:
        raise SystemExit(f"cannot tune snapshot kind {man.kind!r}")
    queries = None
    if args.queries:
        queries = np.load(args.queries).astype(np.float32)
        if queries.ndim != 2 or queries.shape[1] != idx.config.dimension:
            raise SystemExit(
                f"--queries must be [n, {idx.config.dimension}], "
                f"got {queries.shape}"
            )

    cal = idx.calibrate_nprobe(
        queries=queries,
        target_coverage=args.target_coverage,
        k=args.k,
        candidates=tuple(sorted(set(args.candidates))),
        sample=args.sample,
    )

    report = {
        "snapshot": args.snapshot,
        "kind": man.kind,
        "ntotal": idx.ntotal,
        "nlist": idx.config.nlist,
        "dimension": idx.config.dimension,
        "arena_dtype": str(
            getattr(idx.config, "dtype", None)
            or getattr(idx.config, "raw_dtype", "")
        ),
        "k": args.k,
        "query_source": ("file" if args.queries else "sampled stored rows "
                         "(coverage slightly optimistic; prefer held-out "
                         "queries)"),
        "target_coverage": args.target_coverage,
        "recommended_nprobe": cal["nprobe"],
        "measured_coverage": round(float(cal["coverage"]), 4),
        # True when coverage plateaus below target (duplicated-mass
        # geometry) and the knee was chosen instead — see
        # models/calibrate.probe_coverage_calibrate.
        "coverage_limited": bool(cal.get("coverage_limited", False)),
        "coverage_curve": {
            str(np_): round(float(c), 4) for np_, c in cal["curve"].items()
        },
        "reference_static_nprobe": _reference_static_nprobe(idx.ntotal),
    }

    if args.measure_qps:
        from cuda_acceleratedvectordatabaseengine_tpu_torch.models.calibrate \
            import sample_stored_rows

        if queries is not None:
            # held-out queries, tiled up to the batch size if short
            reps = -(-args.batch // queries.shape[0])
            qb = np.tile(queries, (reps, 1))[: args.batch]
        else:
            # The calibration's stand-in workload: sampled stored rows
            # (gaussian noise probes near-uniformly over lists and would
            # report a QPS the recommended nprobe never serves at). The
            # port keeps IVF-PQ raw rows in the original frame, so they are
            # queries as they are, OPQ or not.
            arena = getattr(idx, "arena", None)
            if arena is None:
                arena = getattr(idx, "raw", None)  # IVF-PQ keep_raw=True
            qb = sample_stored_rows(arena, args.batch, seed=1)
        params = SearchParams(nprobe=cal["nprobe"], k=args.k)
        idx.search(qb, params)  # warm up
        t0 = time.monotonic()
        for _ in range(args.qps_batches):
            idx.search(qb, params)
        dt = time.monotonic() - t0
        # Sequential blocking searches: each search fetches its result to
        # the host before the next one starts, so this under-reports the
        # pipelined serving throughput; labeled so the two are never
        # compared directly.
        report["sequential_qps"] = round(
            args.batch * args.qps_batches / dt, 1
        )
        report["batch"] = args.batch
        report["ms_per_batch_sequential"] = round(
            dt / args.qps_batches * 1000, 2
        )

    if args.persist:
        man = IndexManifest.load(args.snapshot)
        man.extra["calibrated_nprobe"] = int(cal["nprobe"])
        man.save(args.snapshot)
        report["persisted"] = True

    text = json.dumps(report, indent=2)
    if args.output == "-":
        print(text)
    else:
        with open(args.output, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
