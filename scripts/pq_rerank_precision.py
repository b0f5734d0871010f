#!/usr/bin/env python3
"""Where the reranked IVF-PQ recall of ``tools.pq_sweep`` is lost: in the
rows the rerank reads, or in the ground truth it is held to.

Builds ``tools.pq_sweep``'s index from its flags twice, with the rerank's
raw rows in bf16 and in fp32 (``--raw-dtype`` is set by this script), and
searches each config of ``--config`` as the sweep does (K2, the device
rerank). Each result is held to two ground truths over the same rows and
queries: the sweep's exact fp32 oracle, and an oracle whose cross term
``q · x`` takes its inputs rounded to bf16 and sums in fp32 (squared norms
in fp32), as an fp32 matrix product at a single bf16 pass does. Prints one
JSON line for each raw dtype and config: recall@k against either truth,
the shortlist containment (``kN`` configs) against the exact one, and how
many of the two truths' top-k ids differ. Run from the repository root on
a machine with a card:

    python3 scripts/pq_rerank_precision.py --aniso 0.5 \\
        --config 512:64 --config 512:128 --config 512:128:k128
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq import (  # noqa: E402
    _ivf_pq_search_device,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (  # noqa: E402
    pq_sweep,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.tools.bench import (  # noqa: E402
    CHUNK_ROWS,
    device_label,
    recall_at,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (  # noqa: E402
    resolve_device,
)


def bf16_pass_truth(args, dev, queries) -> np.ndarray:
    """Top-k ids of ``queries`` over the sweep's rows when the cross term
    is the fp32 sum of bf16-rounded products (the norms exact fp32)."""
    rows = pq_sweep.corpus(args, dev)
    q_sq = (queries * queries).sum(1, keepdim=True)
    q_b = queries.bfloat16().float()
    best_d = torch.full((queries.shape[0], args.k), float("inf"), device=dev)
    best_i = torch.full_like(best_d, -1, dtype=torch.long)
    for start in range(0, args.n, CHUNK_ROWS):
        xc = rows(start, min(CHUNK_ROWS, args.n - start))
        for s0 in range(0, xc.shape[0], pq_sweep.ORACLE_SLICE * 64):
            x = xc[s0:s0 + pq_sweep.ORACLE_SLICE * 64]
            d = q_sq - 2.0 * (q_b @ x.bfloat16().float().T) + (x * x).sum(
                1)[None]
            v, i = torch.topk(d, args.k, dim=1, largest=False)
            best_d, sel = torch.topk(torch.cat([best_d, v], 1), args.k,
                                     dim=1, largest=False)
            best_i = torch.gather(torch.cat([best_i, i + start + s0], 1), 1,
                                  sel)
    return best_i.cpu().numpy()


def main(argv=None) -> int:
    args = pq_sweep.parse_args(argv)
    dev = resolve_device(args.device)
    label = device_label(dev)
    bf16_truth = None
    for raw_dtype in ("bfloat16", "float32"):
        args.raw_dtype = raw_dtype
        idx, queries, truth, build_s = pq_sweep.build(
            args, dev, lambda msg: print(f"[{raw_dtype}] {msg}",
                                         file=sys.stderr, flush=True))
        if bf16_truth is None:
            bf16_truth = bf16_pass_truth(args, dev, queries)
        sargs = pq_sweep.search_args(idx)
        flat_ids = idx.ids.reshape(-1)
        for spec in args.config:
            batch, rerank_k, nprobe, out_k = pq_sweep.parse_config(
                spec, args.nprobe, args.k)
            _, pos = _ivf_pq_search_device(
                queries[:batch], nprobe=nprobe, k=out_k, metric=idx.metric,
                rerank_k=rerank_k, scan_impl=pq_sweep.SCAN_IMPL, **sargs)
            pos = pos.cpu().numpy()
            got = flat_ids[np.clip(pos, 0, flat_ids.size - 1)].astype(
                np.int64)
            got[pos < 0] = -9
            print(json.dumps({
                "raw_dtype": raw_dtype, "config": spec,
                "aniso": args.aniso, "opq": bool(args.opq),
                "recall_exact_truth": recall_at(got[:, :args.k],
                                                truth[:batch], args.k),
                "recall_bf16_pass_truth": recall_at(
                    got[:, :args.k], bf16_truth[:batch], args.k),
                "containment_exact_truth": (
                    recall_at(got, truth[:batch], args.k)
                    if out_k > args.k else None),
                "truths_differ_share": 1.0 - recall_at(
                    bf16_truth[:batch], truth[:batch], args.k),
                "build_s": build_s, "device": label,
            }), flush=True)
        del idx, sargs
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
