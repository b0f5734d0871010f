"""Host-store exact rerank: the capacity tier's second stage (port of the
JAX package's ``io_host/host_rerank.py``).

  device: IVF-PQ ADC scan over the resident code arena (~m bytes a row)
          → a top-``R`` candidate shortlist per query
  host:   gather those R rows per query from the int8-residual
          :class:`HostListStore` in host RAM, dequantize, recompute exact
          distances (one batched BLAS contraction), keep the top k.

The rows live in host RAM and never go to the card: the stage touches only
``B × R`` rows a batch, so uniform traffic costs what a hot working set
costs. Two paths compute it, as in the JAX package: the fused C++ pass of
``native.rerank`` (gather, factored int8 dequant, dot and top-k in one read
of each candidate row, no ``[B, R, D]`` fp32 transient, in C++ threads
without the GIL) where ``use_native`` is set and the flattened store is
C-contiguous, and the numpy path (the JAX package's, step for step)
otherwise. The path follows the store's layout and the flag, never a
failure: ``use_native`` without a buildable native library raises.

Quantization contract of the int8 store: a stored row is ``anchor[list] +
code · scale_row`` and ``sq`` holds the norm of that stored point, so the
reranked distances are exact distances to the stored point.
"""

from __future__ import annotations

import threading

import numpy as np

from cuda_acceleratedvectordatabaseengine_tpu_torch import native
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric

FLT_MAX = np.float32(3.4028235e38)


def _flatten_lists(arrs, empty_shape, dtype):
    """Concatenate per-list arrays, without a copy when they are
    consecutive contiguous views tiling one backing array start to end
    (list ``l`` = ``base[off_l:off_l+c_l]``, as a persisted store loads):
    the base, often a memmap, then serves the gathers through the page
    cache."""
    from numpy.lib.array_utils import byte_bounds

    nonempty = [a for a in arrs if a.shape[0]]
    if not nonempty:
        return np.zeros(empty_shape, dtype)
    first = nonempty[0]
    owner = first.base if first.base is not None else first
    zero_copy = (
        isinstance(owner, np.ndarray)
        and owner.flags["C_CONTIGUOUS"]
        and owner.dtype == first.dtype
        and all(
            (a.base is owner or a is owner) and a.flags["C_CONTIGUOUS"]
            and a.dtype == first.dtype
            for a in nonempty
        )
    )
    if zero_copy:
        prev = byte_bounds(first)[0]
        for a in nonempty:
            lo, hi = byte_bounds(a)
            if lo != prev:
                zero_copy = False
                break
            prev = hi
    if zero_copy:
        olo, _ = byte_bounds(owner)
        start = (byte_bounds(first)[0] - olo) // first.dtype.itemsize
        inner = int(np.prod(first.shape[1:], dtype=np.int64))
        total = sum(a.shape[0] for a in nonempty)
        return owner.reshape(-1)[start:start + total * inner].reshape(
            (total,) + first.shape[1:]
        )
    return np.concatenate(nonempty)


class HostReranker:
    """Exact second-stage rerank over a flattened :class:`HostListStore`
    (int8 or fp32). The per-list arrays are flattened once at construction,
    so every later gather is one fancy-index.

    ``use_native`` (the JAX package's default) reranks a C-contiguous store
    through ``native.rerank``; the library is built here, so a missing
    compiler fails the construction, not a search. ``native_batches`` and
    ``numpy_batches`` count the batches each path ran."""

    def __init__(self, store, batch_rows: int = 131072,
                 use_native: bool = True):
        self.dim = store.dim
        self.quantized = store.dtype == "int8"
        self.use_native = use_native
        if use_native:
            native.load_library()
        self.native_batches = 0
        self.numpy_batches = 0
        self._count_lock = threading.Lock()
        counts = np.asarray(
            [v.shape[0] for v in store.vectors], dtype=np.int64
        )
        n = int(counts.sum())
        self.ntotal = n
        self.batch_rows = int(batch_rows)
        vdt = np.int8 if self.quantized else np.float32
        self.vecs = _flatten_lists(store.vectors, (0, store.dim), vdt)
        self.sq = _flatten_lists(store.sq, (0,), np.float32)
        ids = _flatten_lists(store.ids, (0,), np.uint64)
        self.ids = ids
        if self.quantized:
            self.scale = _flatten_lists(store.scale, (0,), np.float32)
            self.anchors = np.asarray(store.anchors, np.float32)
            self.anchor_row = np.repeat(
                np.arange(store.nlist, dtype=np.int32), counts
            )
        else:
            self.scale = None
            self.anchors = None
            self.anchor_row = None

        # id → flat row. Dense-ish ids get an O(1) inverse table (up to 32×
        # id-space slack, capped at a 4 GB table: the sorted search costs
        # ~24 cache-missing probes a lookup at serving batch sizes); sparse
        # uint64 ids take a sorted binary search.
        self._inv = None
        self._order = None
        self._sorted_ids = None
        if n:
            ids64 = ids.astype(np.int64, copy=False)
            max_id = int(ids64.max())
            if max_id < min(32 * n + 1024, 1 << 29):
                inv = np.full(max_id + 1, -1, np.int64)
                inv[ids64] = np.arange(n, dtype=np.int64)
                self._inv = inv
            else:
                self._order = np.argsort(ids, kind="stable")
                self._sorted_ids = ids[self._order]

    def preload(self, chunk_rows: int = 1 << 20) -> None:
        """Page the backing row store into RAM sequentially: a memmap left
        by the zero-copy flatten faults its pages in on first gather, at
        random-read speed; one sequential pass reads them at disk speed."""
        for s in range(0, self.vecs.shape[0], chunk_rows):
            np.sum(self.vecs[s:s + chunk_rows, :1].astype(np.int32))

    def nbytes(self) -> int:
        total = self.vecs.nbytes + self.sq.nbytes + self.ids.nbytes
        for a in (self.scale, self.anchors, self.anchor_row, self._inv,
                  self._order, self._sorted_ids):
            if a is not None:
                total += a.nbytes
        return total

    def _rows_of_ids(self, flat_ids: np.ndarray) -> np.ndarray:
        """Map candidate ids → flat store rows (-1 for unknown / invalid)."""
        valid = flat_ids != INVALID_ID
        rows = np.full(flat_ids.shape, -1, np.int64)
        if not valid.any() or self.ntotal == 0:
            return rows
        ids64 = flat_ids[valid].astype(np.int64)
        if self._inv is not None:
            in_range = (ids64 >= 0) & (ids64 < self._inv.size)
            got = np.full(ids64.shape, -1, np.int64)
            got[in_range] = self._inv[ids64[in_range]]
            rows[valid] = got
        else:
            pos = np.searchsorted(self._sorted_ids, flat_ids[valid])
            pos = np.minimum(pos, self.ntotal - 1)
            hit = self._sorted_ids[pos] == flat_ids[valid]
            rows[valid] = np.where(hit, self._order[pos], -1)
        return rows

    def _anchor_dots(self, queries, rows):
        """Per-candidate query·anchor terms ``[B, R]`` through each query's
        unique candidate anchors (at most nprobe of them: every candidate
        comes from a probed list), not a dense ``[B, nlist]`` product."""
        b, r = rows.shape
        lists = self.anchor_row[np.maximum(rows, 0)]        # [B, R]
        qa_cand = np.empty((b, r), np.float32)
        for i in range(b):
            u, inv = np.unique(lists[i], return_inverse=True)
            qa_cand[i] = (queries[i] @ self.anchors[u].T)[inv]
        return qa_cand

    _METRIC_CODE = {
        Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2,
    }

    def _count(self, native_path: bool) -> None:
        with self._count_lock:
            if native_path:
                self.native_batches += 1
            else:
                self.numpy_batches += 1

    def _rerank_native(self, queries, q_sq, rows, cand_ids, metric, k,
                       qa_cand):
        """Fused C++ rerank (``native.rerank``): gather + factored dequant
        + dot + top-k in one pass over each candidate row."""
        return native.rerank(
            self.vecs, rows, cand_ids, queries,
            q_sq if metric == Metric.L2 else None,
            self._METRIC_CODE[metric], k,
            scale=self.scale,
            sq=self.sq if metric == Metric.L2 else None,
            anchor_row=self.anchor_row,
            qa_cand=qa_cand,
        )

    def rerank(
        self,
        queries: np.ndarray,   # [B, D] fp32, the original (unrotated) frame
        cand_ids: np.ndarray,  # [B, R] uint64, INVALID_ID padding allowed
        metric: Metric,
        k: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact distances of each query to its R candidates; top-k,
        ascending, FLT_MAX / INVALID_ID padding. For cosine the caller
        passes L2-normalized queries and a store of normalized rows."""
        b, r = cand_ids.shape
        queries = np.ascontiguousarray(queries, np.float32)
        out_d = np.full((b, k), FLT_MAX, np.float32)
        out_i = np.full((b, k), INVALID_ID, np.uint64)
        rows = self._rows_of_ids(cand_ids)
        q_sq = np.einsum("bd,bd->b", queries, queries)
        # Factored int8 dots: q·x̂ = q·anchor[l] + scale·(q·code).
        qa_cand = (
            self._anchor_dots(queries, rows) if self.quantized else None
        )
        # The native pass reads the store in place: only a C-contiguous
        # store takes it (a multi-GB store is never copied for it).
        if self.use_native and self.vecs.flags["C_CONTIGUOUS"]:
            self._count(True)
            return self._rerank_native(queries, q_sq, rows, cand_ids,
                                       metric, k, qa_cand)
        self._count(False)
        # Chunk over queries so the fp32 cast transient stays bounded
        # (B·R·D fp32 at B=512, R=256, D=768 would be ~400 MB).
        step = max(self.batch_rows // max(r, 1), 1)
        for s in range(0, b, step):
            e = min(s + step, b)
            rs = rows[s:e]                       # [c, R]
            safe = np.maximum(rs, 0)
            cand = self.vecs[safe.ravel()].astype(np.float32)
            cand = cand.reshape(e - s, r, self.dim)
            # One batched BLAS contraction: [c, R, D] @ [c, D, 1].
            dots = np.matmul(
                cand, queries[s:e, :, None], dtype=np.float32
            )[..., 0]                            # [c, R]
            if self.quantized:
                dots *= self.scale[safe]
                dots += qa_cand[s:e]
            if metric == Metric.INNER_PRODUCT:
                d = -dots
            elif metric == Metric.COSINE:
                d = 1.0 - dots
            else:
                d = np.maximum(
                    q_sq[s:e, None] - 2.0 * dots + self.sq[safe], 0.0
                )
            d = np.where(rs >= 0, d, FLT_MAX).astype(np.float32)
            if r > k:
                part = np.argpartition(d, k - 1, axis=1)[:, :k]
            else:
                part = np.broadcast_to(np.arange(r), (e - s, r))
            dk = np.take_along_axis(d, part, axis=1)
            order = np.argsort(dk, axis=1, kind="stable")
            top = np.take_along_axis(part, order, axis=1)[:, :k]
            dd = np.take_along_axis(d, top, axis=1)
            ii = np.take_along_axis(cand_ids[s:e], top, axis=1)
            ii = np.where(dd < FLT_MAX, ii, INVALID_ID)
            nk = min(k, r)
            out_d[s:e, :nk] = dd[:, :nk]
            out_i[s:e, :nk] = ii[:, :nk]
        return out_d, out_i
