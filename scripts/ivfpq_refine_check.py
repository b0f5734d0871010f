"""The IVF-PQ refine deployment (``vdb_bench`` cell ``ivfpq-10m-768.b64``)
on the card, outside the benchmark's runs: the rerank depth's recall and
cost, and the served answers against the plain IVF-PQ reference.

For each seed, one process builds the cell's index as a benchmark run does
(``vdb_bench.harness.set_up``: the corpus from the seed, the kind's build,
the install), then:

1. depths: for each ``--depths`` value (and each ``--nprobes`` value), the
   index's ``rerank_k`` set to it and ``--queries`` pool queries searched
   in 64-query batches through ``IVFPQIndex.search_async``: recall@10
   against the exact fp32 top-10 (``vdb_bench/reference/exact.py``), the
   rows the rerank read a query, the host ms a batch (enqueue to answer,
   one batch at a time) and the rerank's device ms;
2. reference: at the configuration's depth, ``--seconds`` of the cell's
   traffic through the engine (``harness.serve``), and for
   ``--sample`` of the window's requests the engine's answers against the
   plain IVF-PQ reference (``vdb_bench/reference/ivf_pq.py``) given the
   index's own centroids, codebooks, codes and raw rows: ids equal apart
   from ties, distances within the fp32 tolerance.

One JSON line a seed and step on standard output (also appended to
``--out``). Needs a CUDA card.

    python3 scripts/ivfpq_refine_check.py --seeds 11,12 \\
        --depths 512,1024,2048,4096 --nprobes 32,24 --out depths.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (  # noqa: E402
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat import (  # noqa: E402
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (  # noqa: E402
    compare_topk,
)
from vdb_bench import harness, spec, traffic  # noqa: E402
from vdb_bench.reference import exact, ivf_pq as ref_pq  # noqa: E402

CELL = "ivfpq-10m-768.b64"
BATCH = 64


def emit(out, rec) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def depth_sweep(live, depths, nprobes, n_queries) -> list[dict]:
    """Recall, rows, host and rerank ms of each (depth, nprobe) over the
    first ``n_queries`` pool queries."""
    index = live.index
    q = live.pool[:n_queries]
    q_dev = torch.from_numpy(q).to(index.device)
    _, truth = exact.exact_topk(q_dev, live.corpus.chunks(), live.k)
    truth = truth.cpu().numpy()
    out = []
    for nprobe in nprobes:
        for depth in depths:
            index.config.rerank_k = depth
            p = SearchParams(nprobe=nprobe, k=live.k, use_exact_rerank=True)
            index.search(q[:BATCH], p)                 # warm this shape
            torch.cuda.synchronize()
            hits, rows, host_ms, rerank_ms = 0, [], [], []
            for s0 in range(0, n_queries, BATCH):
                t0 = time.perf_counter()
                fin = index.search_async(q[s0:s0 + BATCH], p)
                _, ids = fin()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                rows.append(fin.counts["rerank_rows"])
                rerank_ms.append(fin.waits["rerank"])
                for a, b in zip(ids, truth[s0:s0 + BATCH]):
                    hits += len(set(a.tolist()) & set(b.tolist()))
            out.append({
                "nprobe": nprobe, "rerank_k": depth,
                "recall_at_10": hits / truth[:n_queries].size,
                "rerank_rows": float(np.mean(rows)),
                "batch_host_ms_p50": float(np.median(host_ms)),
                "rerank_ms_p50": float(np.median(rerank_ms))})
    return out


def reference_check(live, cell, seed, seconds, sample) -> dict:
    """The engine's answers of ``sample`` requests of a served window
    against the plain IVF-PQ reference on the index's own arrays."""
    index = live.index
    served = harness.serve(live, cell.traffic, seed, seconds, phase=2)
    cols = served["cols"]
    ok = np.flatnonzero(cols["status"] == traffic.OK)
    rng = np.random.default_rng(seed)
    picked = rng.choice(ok, min(sample, ok.size), replace=False)
    raw = index.raw
    flat_ids = index.ids.reshape(-1)
    depth = index.config.rerank_k
    n_diff = n_bad = 0
    max_err = 0.0
    short = []
    for r in picked:
        rows = cols["rows"][r][:cols["got"][r]]
        q = torch.from_numpy(live.pool[rows]).to(index.device)
        d_r, pos, sl = ref_pq.search(
            q, index.centroids, index.codebooks, index.code_arena,
            index.counts, raw.arena, live.params.nprobe, depth, live.k)
        pos = pos.cpu().numpy()
        ids_r = flat_ids[np.clip(pos, 0, None)]
        ids_r[pos < 0] = INVALID_ID
        qn = live.pool[rows]
        # fp32 sums in two orders over |q|² + |x|²: 1e-5 of it bounds both
        atol = 1e-5 * ((qn * qn).sum(1) + float(raw.arena_sq.max()))
        c = compare_topk(cols["d"][r][:len(rows)], cols["ids"][r][:len(rows)],
                         d_r.cpu().numpy(), ids_r, rtol=1e-5, atol=atol)
        n_diff += c.n_id_differences
        n_bad += c.n_unexplained + int(c.max_excess > 0)
        max_err = max(max_err, c.max_abs_err)
        short.append(float(sl.float().mean()))
    return {"requests": int(picked.size), "rerank_k": depth,
            "ids_differ": n_diff, "beyond_ties_or_tolerance": n_bad,
            "max_abs_err": max_err,
            "reference_rows_a_query": float(np.mean(short)),
            "ok": n_bad == 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--depths", default="512,1024,2048,4096")
    p.add_argument("--nprobes", default="32,24")
    p.add_argument("--queries", type=int, default=2048)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--sample", type=int, default=8)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ivfpq_refine_check: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    cell = spec.resolve(spec.load_benchmark(), CELL)
    configured = int(cell.config["index"]["rerank_k"])
    depths = [int(v) for v in args.depths.split(",") if v]
    nprobes = [int(v) for v in args.nprobes.split(",") if v]
    all_ok = True
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="ivfpq-check-") as data:
            engine = harness.build_engine(cell, data, dev, {})
            try:
                t0 = time.perf_counter()
                live = harness.set_up(cell, seed, dev, engine)
                emit(args.out, {
                    "seed": seed, "step": "build",
                    "seconds": time.perf_counter() - t0,
                    "train_s": live.train_s, "build_s": live.build_s,
                    "capacity": live.index.capacity,
                    "longest_list": int(live.counts.max()),
                    "arena_gb": live.arena_bytes / 1e9,
                    "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                    "device": torch.cuda.get_device_name(dev)})
                for rec in depth_sweep(live, depths, nprobes, args.queries):
                    emit(args.out, {"seed": seed, "step": "depth", **rec})
                live.index.config.rerank_k = configured
                rec = reference_check(live, cell, seed, args.seconds,
                                      args.sample)
                all_ok &= rec["ok"]
                emit(args.out, {"seed": seed, "step": "reference", **rec})
                harness.take_down(live, dev)
            finally:
                engine.close()
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
