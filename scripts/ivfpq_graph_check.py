"""IVF-PQ searches replayed from CUDA graphs against the same searches run
eagerly, on the card (``models/ivf_pq._SearchGraph``).

Builds a resident IVF-PQ index with bf16 raw rows on a clustered corpus at
the published width (``--n`` rows × 768 by default), then for each batch
size of ``--batches``, with and without the exact rerank at
``--rerank-k``:

1. answers: the search with ``graph_searches`` off, then three times with
   it on (eager, capture, replay); ids and distances must equal the eager
   search's exactly, and the rerank's rows a query too;
2. time: ``--reps`` searches one at a time (enqueue to answer) with graphs
   off and on: the host ms a search and the host ms of its enqueue alone.

One JSON line a batch size and mode on standard output; exits 1 where an
answer differs. Needs a CUDA card.

    python3 scripts/ivfpq_graph_check.py --n 400000 --batches 64,37,1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cuda_acceleratedvectordatabaseengine_tpu_torch import (  # noqa: E402
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
)


def corpus(n, dim, clusters, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = 4.0 * torch.randn((clusters, dim), generator=g, device=dev)
    pick = torch.randint(0, clusters, (n,), generator=g, device=dev)
    return (centers[pick] + torch.randn((n, dim), generator=g, device=dev)
            ).to(torch.bfloat16)


def timed(idx, q, p, reps):
    enq = []
    t0 = time.perf_counter()
    for _ in range(reps):
        t1 = time.perf_counter()
        fin = idx.search_async(q, p)
        enq.append(time.perf_counter() - t1)
        fin()
    return ((time.perf_counter() - t0) / reps * 1e3,
            float(np.median(enq)) * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=400_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=512)
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--m", type=int, default=96)
    ap.add_argument("--rerank-k", type=int, default=2048)
    ap.add_argument("--batches", default="64,37,1")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script: nothing is captured")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    x = corpus(args.n, args.dim, args.nlist // 4, args.seed, dev)
    idx = IVFPQIndex(IVFPQConfig(
        dimension=args.dim, nlist=args.nlist, m=args.m,
        raw_dtype="bfloat16", rerank_k=args.rerank_k), device=dev)
    idx.train_from_device(x)
    idx.build_from_device(x, np.arange(args.n, dtype=np.uint64))
    rng = np.random.default_rng(args.seed)
    ok = True
    for b in (int(s) for s in args.batches.split(",")):
        rows = rng.integers(0, args.n, b)
        q = (x[torch.from_numpy(rows).to(dev)].float().cpu().numpy()
             + rng.standard_normal((b, args.dim)).astype(np.float32))
        for rerank in (True, False):
            p = SearchParams(nprobe=args.nprobe, k=10,
                             use_exact_rerank=rerank)
            idx.graph_searches = False
            fin = idx.search_async(q, p)
            d0, i0 = fin()
            rows0 = fin.counts.get("rerank_rows")
            same = True
            for _ in range(3):
                idx.graph_searches = True
                fin = idx.search_async(q, p)
                d1, i1 = fin()
                same &= (np.array_equal(i0, i1) and np.array_equal(d0, d1)
                         and fin.counts.get("rerank_rows") == rows0)
            idx.graph_searches = False
            eager_ms, eager_enq = timed(idx, q, p, args.reps)
            idx.graph_searches = True
            graph_ms, graph_enq = timed(idx, q, p, args.reps)
            ok &= same
            print(json.dumps({
                "batch": b, "rerank": rerank, "equal": bool(same),
                "rerank_rows": rows0, "eager_ms": eager_ms,
                "graph_ms": graph_ms, "eager_enqueue_ms": eager_enq,
                "graph_enqueue_ms": graph_enq,
                "graphs": len(idx._graphs),
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
