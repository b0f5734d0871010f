"""The index kind ``ivf_pq_refine``: a resident IVF-PQ index with an exact
rerank, the upstream ``IVFPQIndex`` "with refine"
(``models/ivf_pq.IVFPQIndex``): 8-bit residual codes scanned by K2
(``ops/grouped_pq_scan``), the raw rows kept on the card, and every request
reranking the top ``rerank_k`` ADC candidates of its probed lists exactly.

The five functions of the kind contract (``kinds/ivf_flat.py``'s
docstring). The configuration's ``index`` names ``m``, ``nbits``,
``raw_dtype``, ``rerank_k`` and the coarse k-means' ``train_iters`` beside
the shape every kind has.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vdb_bench import roofline_pq, traffic
from vdb_bench.harness import _sync
from vdb_bench.reference import exact

SLOT_ALIGN = 128     # the port's list capacity step


def create_args(cfg: dict) -> tuple[int, int, str]:
    """The configuration's subquantizers and code bits, the resident
    tier."""
    return int(cfg["index"]["m"]), int(cfg["index"]["nbits"]), ""


def search_fields(cfg: dict) -> dict:
    """Every request asks for the exact rerank."""
    return {"use_exact_rerank": True}


def build(engine, cfg: dict, x: torch.Tensor, dev) -> tuple:
    """The IVF-PQ index of ``cfg`` with its raw rows and its rerank depth,
    trained on ``x`` (``train_from_device``) and filled with it in one
    bulk build (``build_from_device``: the lists sized once, near the p99
    list size and at least 1.5 times the mean, a row past a full list in
    its next-nearest, as the IVF-Flat kind's build places rows);
    ``(index, train_s, build_s)``."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq \
        import IVFPQConfig, IVFPQIndex

    st = engine.get_state(cfg["name"])
    ix = cfg["index"]
    index = IVFPQIndex(IVFPQConfig(
        dimension=st.config["dimension"], nlist=st.config["nlist"],
        m=st.config["m"], nbits=st.config["nbits"],
        metric=st.config["metric"], keep_raw=True,
        raw_dtype=ix["raw_dtype"], rerank_k=int(ix["rerank_k"]),
        train_iters=int(ix["train_iters"])), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    index.train_from_device(x)
    _sync(dev)
    t1 = time.perf_counter()
    index.build_from_device(x, np.arange(x.shape[0], dtype=np.uint64))
    _sync(dev)
    return index, t1 - t0, time.perf_counter() - t1


def facts(index) -> dict:
    """Codes, raw rows and capacity, and what K2's bound reads: the
    centroids, the list occupancy and the emitted row width."""
    counts = index.counts.detach().cpu()
    cap = index.capacity
    occupied = -(-max(int(counts.max()), 1) // SLOT_ALIGN) * SLOT_ALIGN
    return {
        "summary": (f"codes {tuple(index.code_arena.shape)} "
                    f"{index.code_arena.dtype}, raw rows "
                    f"{index.raw.arena.dtype}, capacity {cap}, longest list "
                    f"{int(counts.max())}, rerank_k "
                    f"{index.config.rerank_k}"),
        "centroids": index.centroids.detach().cpu(), "counts": counts,
        "scan_slots": min(occupied, cap), "m": index.config.m,
        "arena_bytes": index.memory_stats()["total_bytes"]}


def bounds(cols, pool_dev, live, cfg: dict, k: int) -> list[float]:
    """K2's roofline bound (seconds) of each answered request of the
    window, each request being one device batch; probes from the plain
    coarse probe over the index's centroids
    (``roofline_pq.grouped_pq_scan_bound``)."""
    probes = exact.coarse_probe(pool_dev, live.centroids.to(pool_dev.device),
                                cfg["index"]["nprobe"]).cpu()
    out = []
    for rows in cols["rows"][cols["status"] == traffic.OK]:
        b = roofline_pq.grouped_pq_scan_bound(
            probes[torch.from_numpy(rows)], live.counts, live.scan_slots,
            cfg["index"]["dim"], live.m)
        out.append(b["bound_s"])
    return out
