"""Chunked balanced index builds (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/builder.py``).

Chunks of ``(ids, vectors)`` stream in one at a time (for example off a
memory-mapped Arrow file, ``ArrowStorage.iter_vector_chunks``), the index
trains on a sample first, and IVF-Flat chunks append through the balanced
path (capacity fixed up front near the mean list size, overflow spilled
to next-nearest lists), so the corpus never sits whole in host RAM and
the arena never reallocates mid-build.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    PackedListArena,
)

# Capacity ≈ 1.35× the mean list size, slot-aligned: balanced assignment
# spills the overflow of fat lists to their next-nearest centroid, so the
# padded arena stays ~35% over the dense size (the JAX package's law).
CAPACITY_FACTOR = 1.35


def chunked_capacity(n_total: int, nlist: int) -> int:
    mean = max(1, n_total // max(nlist, 1))
    align = PackedListArena.SLOT_ALIGN
    return -(-int(mean * CAPACITY_FACTOR) // align) * align


def build_index_chunked(
    index,
    chunks: Iterable[tuple[np.ndarray, np.ndarray]],
    n_total: int,
    *,
    train_sample: np.ndarray | None = None,
    tombstones: np.ndarray | None = None,
    progress: Callable[[float], None] | None = None,
    row_sink: Callable[[np.ndarray, np.ndarray], None] | None = None,
) -> int:
    """Stream ``chunks`` of ``(ids, vectors)`` (host numpy) into ``index``
    (an ``IVFFlatIndex`` or ``IVFPQIndex``), each chunk uploaded once to
    the index's device.

    - Trains on ``train_sample`` first when the index is untrained.
    - IVF-Flat chunks go through ``append_balanced`` with a capacity fixed
      up front from ``n_total``; IVF-PQ ``reserve``\\ s the same capacity
      and ingests with ``add_from_device``.
    - ``tombstones``: ids filtered out of every chunk.
    - ``progress(frac)`` is called after every chunk with rows done /
      ``n_total``.
    - ``row_sink(ids, vectors)`` receives every ingested (post-filter)
      chunk.

    Returns the number of rows ingested. Peak host RAM is one chunk plus
    the training sample.
    """
    is_pq = hasattr(index, "codebooks")
    if not index.trained:
        if train_sample is None or not len(train_sample):
            raise ValueError("untrained index needs a train_sample")
        index.train(np.ascontiguousarray(train_sample, np.float32))
    cap = chunked_capacity(n_total, index.config.nlist)
    if is_pq:
        index.reserve(cap)
    done = 0
    for ids, vecs in chunks:
        ids = np.asarray(ids, np.uint64)
        vecs = np.ascontiguousarray(vecs, np.float32)
        if tombstones is not None and tombstones.size:
            keep = ~np.isin(ids, tombstones)
            ids, vecs = ids[keep], vecs[keep]
        if not len(ids):
            continue
        x_dev = torch.from_numpy(vecs).to(index.device)
        if is_pq:
            index.add_from_device(x_dev, ids)
        else:
            index.append_balanced(x_dev, ids=ids, capacity=cap)
        del x_dev
        if row_sink is not None:
            row_sink(ids, vecs)
        done += len(ids)
        if progress is not None:
            progress(min(1.0, done / max(n_total, 1)))
    return done


def train_sample_rows(config) -> int:
    """Training subsample budget for a config (the law of
    ``IVFFlatIndex.train``: ``train_sample_per_list * nlist``)."""
    return int(config.train_sample_per_list) * int(config.nlist)
