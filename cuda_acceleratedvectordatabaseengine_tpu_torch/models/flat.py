"""Exact brute-force flat index (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/models/flat.py``).

One padded ``[N_pad, dim]`` table on the device, grown by doubling, and
searched by ``ops/scan.scan_all``: a product over the whole occupied
prefix plus ``torch.topk``, chunked over rows. The JAX version runs no
Pallas kernel here, and neither does the port.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
    _remove_device,
    plan_removals,
    torch_dtype,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.normalize import (
    l2_normalize,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.scan import scan_all
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (
    resolve_device,
)

_ROW_ALIGN = 1024
FLT_MAX = np.float32(np.finfo(np.float32).max)


class FlatIndex:
    """Exact nearest-neighbour index over one device-resident table, on
    ``device`` (the card unless another is named). ``dtype`` is the
    stored row type (bf16 by default, as in the JAX package). Distances
    are fp32-exact distances from the fp32 query to the STORED rows (their
    norms too); the JAX package rounds the query to bf16 and takes the
    norms of the unrounded input, so on a bf16 table the two differ by
    bf16 rounding, and on an fp32 table they agree."""

    def __init__(self, dimension: int, metric: Metric = Metric.L2,
                 dtype="bfloat16", chunk_size: int = 65536,
                 device: torch.device | str | None = "cuda"):
        self.dimension = dimension
        self.metric = Metric.parse(metric) if isinstance(metric, str) \
            else metric
        self.dtype = torch_dtype(dtype if isinstance(dtype, (str, torch.dtype))
                                 else np.dtype(dtype).name)
        self.chunk_size = chunk_size
        self.device = resolve_device(device)
        self._n = 0
        self._data = torch.zeros((_ROW_ALIGN, dimension), dtype=self.dtype,
                                 device=self.device)
        self._data_sq = torch.zeros((_ROW_ALIGN,), device=self.device)
        self._ids = np.full((_ROW_ALIGN,), INVALID_ID, np.uint64)

    def __len__(self) -> int:
        return self._n

    def add(self, vectors: np.ndarray, ids: np.ndarray | None = None) -> None:
        vectors = np.ascontiguousarray(vectors, np.float32)
        n = vectors.shape[0]
        if n == 0:
            return
        if vectors.shape[1] != self.dimension:
            raise ValueError(f"vector dim {vectors.shape[1]} != index dim "
                             f"{self.dimension}")
        if ids is None:
            ids = np.arange(self._n, self._n + n, dtype=np.uint64)
        vec_d = torch.from_numpy(vectors).to(self.device)
        if self.metric == Metric.COSINE:
            vec_d = l2_normalize(vec_d)
        new_n = self._n + n
        cap = self._data.shape[0]
        if new_n > cap:
            new_cap = max(new_n, cap * 2)
            new_cap = -(-new_cap // _ROW_ALIGN) * _ROW_ALIGN
            pad = new_cap - cap
            self._data = torch.cat([self._data, self._data.new_zeros(
                (pad, self.dimension))])
            self._data_sq = torch.cat([self._data_sq,
                                       self._data_sq.new_zeros(pad)])
            ids_new = np.full((new_cap,), INVALID_ID, np.uint64)
            ids_new[: self._n] = self._ids[: self._n]
            self._ids = ids_new
        stored = vec_d.to(self.dtype)
        self._data[self._n:new_n] = stored
        self._data_sq[self._n:new_n] = (stored.float() ** 2).sum(-1)
        self._ids[self._n:new_n] = np.asarray(ids).astype(np.uint64)
        self._n = new_n

    def remove_ids(self, ids: np.ndarray) -> int:
        """Delete by user id, swap-from-tail within the table (the single
        list case of ``models/arena.plan_removals``); unknown ids are
        ignored. Rows stay prefix-packed."""
        ids = np.unique(np.asarray(ids, np.uint64))
        ids = ids[ids != INVALID_ID]
        if ids.size == 0 or self._n == 0:
            return 0
        d = np.flatnonzero(np.isin(self._ids[: self._n], ids))
        if d.size == 0:
            return 0
        _, src_s, dst_s, new_counts = plan_removals(
            np.asarray([self._n], np.int64),
            np.zeros(d.size, np.int64),
            d.astype(np.int64),
        )
        new_n = int(new_counts[0])
        if src_s.size:
            _remove_device(
                (self._data, self._data_sq),
                torch.from_numpy(src_s).to(self.device),
                torch.from_numpy(dst_s).to(self.device),
            )
            self._ids[dst_s] = self._ids[src_s]
        self._ids[new_n: self._n] = INVALID_ID
        removed = self._n - new_n
        self._n = new_n
        return removed

    def search(
        self, queries: np.ndarray, k: int = 10
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k: ``(distances [B, k] fp32, ids [B, k] uint64)``,
        ascending, with FLT_MAX / UINT64_MAX for underfull results."""
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            self.device)
        if self.metric == Metric.COSINE:
            q = l2_normalize(q)
        d, pos = scan_all(q, self._data, self._data_sq, self._n, k,
                          self.metric, self.chunk_size)
        d = d.cpu().numpy().copy()
        pos = pos.cpu().numpy()
        ids = self._ids[np.clip(pos, 0, self._ids.size - 1)]
        ids[pos < 0] = INVALID_ID
        d[pos < 0] = FLT_MAX
        return d, ids
