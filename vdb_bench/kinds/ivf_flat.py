"""The index kind ``ivf_flat``: a resident IVF-Flat index
(``models/ivf_flat.IVFFlatIndex``) on the engine's arena dtype, its lists
scanned by K1 (``ops/grouped_scan``).

An index kind holds what the harness knows of one index family. A
configuration names it under ``index.kind``; ``spec.load_kind`` loads
``kinds/<kind>.py``. The corpus, the query pool, the install, the serving,
the judgement and the metric readers are the harness's, the same for every
kind: a kind never changes them. Every kind module defines:

- ``create_args(cfg) -> (m, nbits, tier)``: the arguments of the engine's
  ``create_index`` after name, dimension, metric and nlist;
- ``search_fields(cfg) -> dict``: fields of every request's
  ``SearchParams`` besides ``nprobe`` and ``k`` (an exact rerank, say);
- ``build(engine, cfg, x, dev) -> (index, train_s, build_s)``: the index
  of the engine's created state, trained and filled with the corpus ``x``
  (row ``i`` has id ``i``) by the port's own build calls, the training and
  the fill each timed on the host clock with the card synchronised;
- ``facts(index) -> dict``: what set-up reads off the built index:
  ``arena_bytes`` (the device bytes the index accounts for, read by
  ``arena_gb``), ``summary`` (its part of the "built" log line), and any
  other key the kind's ``bounds`` reads, kept on the harness's ``Live``;
- ``bounds(cols, pool_dev, live, cfg, k) -> list[float]``: the roofline
  bound in seconds of the kind's list scan for each answered request of
  the window (``run.batch_bounds()``; ``k1_roofline`` sets their mean
  against K1's traced time), or ``[]`` where the kind has none, so that a
  reader of them reads nothing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vdb_bench import roofline, traffic
from vdb_bench.harness import _sync
from vdb_bench.reference import exact


def create_args(cfg: dict) -> tuple[int, int, str]:
    """No subquantizers (IVF-Flat), the engine's default code bits, the
    resident tier."""
    return 0, 0, ""


def search_fields(cfg: dict) -> dict:
    """None: requests keep ``SearchParams``' defaults."""
    return {}


def build(engine, cfg: dict, x: torch.Tensor, dev) -> tuple:
    """The IVF-Flat index of ``cfg`` trained and built on ``x`` by the
    port's build calls, with the engine's arena dtype; ``(index, train_s,
    build_s)``."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat \
        import IVFFlatConfig, IVFFlatIndex

    st = engine.get_state(cfg["name"])
    index = IVFFlatIndex(IVFFlatConfig(
        dimension=st.config["dimension"], nlist=st.config["nlist"],
        metric=st.config["metric"], dtype=st.config["dtype"]), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    index.train_from_device(x)
    _sync(dev)
    t1 = time.perf_counter()
    index.build_from_device(x, np.arange(x.shape[0], dtype=np.uint64))
    _sync(dev)
    return index, t1 - t0, time.perf_counter() - t1


def facts(index) -> dict:
    """The arena's occupancy and layout, for K1's bound."""
    arena = index.arena
    return {
        "summary": f"arena {arena.arena.dtype}, capacity {arena.capacity}",
        "centroids": index.centroids.detach().cpu(),
        "counts": arena.counts.detach().cpu(), "capacity": arena.capacity,
        "elem_bytes": arena.arena.element_size(),
        "scaled": arena.arena_scale is not None,
        "anchored": arena.anchors is not None,
        "arena_bytes": index.memory_stats()["total_bytes"]}


def bounds(cols, pool_dev, live, cfg: dict, k: int) -> list[float]:
    """K1's roofline bound (seconds) of each answered request of the
    window, each request being one device batch; probes from the plain
    coarse probe over the index's centroids."""
    probes = exact.coarse_probe(pool_dev, live.centroids.to(pool_dev.device),
                                cfg["index"]["nprobe"]).cpu()
    out = []
    for rows in cols["rows"][cols["status"] == traffic.OK]:
        b = roofline.grouped_scan_bound(
            probes[torch.from_numpy(rows)], live.counts, live.capacity,
            cfg["index"]["dim"], live.elem_bytes, k, live.scaled,
            live.anchored)
        out.append(b["bound_s"])
    return out
