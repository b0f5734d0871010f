"""The search cycle every index family of the port serves through.

A search enqueues its device half and returns a :class:`PendingSearch`;
calling that waits for the card and brings the answer to the host. The
cycle's parts live here once: the request check, nprobe, the pinned query
upload and the enqueue under ``_mutate_lock`` (:class:`IVFIndexBase`), the
``done`` event, the answer's pinned copies (``utils/transfer.HostCopy``),
the finalize's wait, copy and id map (:class:`PendingSearch`). A resident
family writes only its device half, its snapshot and a host post-step.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
    Metric,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.normalize import (
    l2_normalize,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (
    resolve_device,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.profiling import (
    trace,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.transfer import (
    HostCopy,
    upload,
)

FLT_MAX = np.float32(np.finfo(np.float32).max)


@dataclasses.dataclass
class SearchParams:
    """``nprobe=0`` resolves to the index's measured-coverage calibration
    (:meth:`IVFFlatIndex.calibrate_nprobe`), else the default."""

    nprobe: int = 10
    k: int = 10
    use_exact_rerank: bool = False  # fp32 rerank from the lo plane, where
                                    # the index stores residuals


class ListHeat:
    """Per-list heat behind ``get_hot_lists``, one definition for both
    index families: each search adds 1 to each list that each query
    probed (probe -1 excluded), counted on the index's device
    (``index_add_`` into an int64 tensor), so a search adds no host copy;
    :meth:`to_numpy` fetches the counts. The JAX package counts a probed
    list once per batch (IVF-Flat) or the lists of the returned positions
    (IVF-PQ)."""

    def __init__(self, nlist: int, device: torch.device):
        self._counts = torch.zeros(nlist, dtype=torch.int64, device=device)
        self._lock = threading.Lock()

    def add_probes(self, probe_ids: torch.Tensor) -> None:
        """Count one search's ``probe_ids [B, nprobe]`` (on the device)."""
        flat = probe_ids.reshape(-1)
        with self._lock:
            self._counts.index_add_(0, flat.clamp_min(0).long(),
                                    (flat >= 0).long())

    def mark(self, list_ids) -> None:
        """Count each named list once (a warm-up's ``list_ids``)."""
        ids = torch.from_numpy(np.unique(np.asarray(list_ids, np.int64)))
        with self._lock:
            self._counts[ids.to(self._counts.device)] += 1

    def reset(self, list_id: int) -> None:
        with self._lock:
            self._counts[int(list_id)] = 0

    def to_numpy(self) -> np.ndarray:
        """A copy of the counts (never a view of a CPU tensor)."""
        return self._counts.cpu().numpy().copy()


def positions_to_ids(pos: np.ndarray, ids_table: np.ndarray) -> np.ndarray:
    """User uint64 ids of ``ids_table [nlist, cap]`` at global positions
    (``list · cap + slot``, int32; -1 = empty → UINT64_MAX)."""
    flat = ids_table.reshape(-1)
    out = flat[np.clip(pos, 0, flat.size - 1)]
    out[pos < 0] = INVALID_ID
    return out


def resolve_nprobe(params: SearchParams, calibrated: int | None,
                   nlist: int) -> int:
    """``params.nprobe``, or where ≤ 0 the index's measured-coverage
    calibration, else the default; at most ``nlist``."""
    nprobe = params.nprobe
    if nprobe <= 0:
        nprobe = calibrated or SearchParams().nprobe
    return min(nprobe, nlist)


def flat_rerank_depth(params: SearchParams, has_lo: bool, keep: int) -> int:
    """IVF-Flat's exact-rerank depth: 0 unless the search asks for it and
    the arena keeps a lo plane, else ``min(max(4k, keep), 256)``, ``keep``
    the scan's depth without a rerank."""
    if not (params.use_exact_rerank and has_lo):
        return 0
    return min(max(4 * params.k, keep), 256)


class SearchSpans(NamedTuple):
    """The range names of one family's search cycle, made once."""

    upload: str
    finalize: str
    fetch_wait: str
    copy: str
    id_map: str

    @classmethod
    def of(cls, prefix: str) -> "SearchSpans":
        return cls(*(f"{prefix}.{name}" for name in cls._fields))


class PendingSearch:
    """A search whose device half is enqueued; calling it (once) returns
    ``(distances [B, k] fp32, ids [B, k] uint64)`` ascending, FLT_MAX /
    UINT64_MAX for underfull rows. ``waits`` (host ms: ``enqueue``, and
    ``fetch_wait`` once called, 0.0 on the CPU) and ``counts`` are for the
    caller to record; a post-step adds to both."""

    def __init__(self, spans: SearchSpans, d: torch.Tensor, pos: torch.Tensor,
                 ids_table: np.ndarray, post=None):
        """Made right after the search's last launch, under its enqueue
        lock: records ``done``, then enqueues the copies of ``d`` and
        ``pos``. ``post(d, ids, waits, counts)`` runs after the id map."""
        self._done = None
        if d.is_cuda:
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(d.device))
        self._host = HostCopy(d, pos)
        self._spans = spans
        self._ids_table = ids_table
        self._post = post
        self._answer = None
        self.waits = {"fetch_wait": 0.0}
        self.counts: dict = {}

    @classmethod
    def ready(cls, d: np.ndarray, ids: np.ndarray) -> "PendingSearch":
        """A search answered synchronously: no wait, no stage."""
        pending = cls.__new__(cls)
        pending._answer = (d, ids)
        pending.waits, pending.counts = {}, {}
        return pending

    def __call__(self) -> tuple[np.ndarray, np.ndarray]:
        if self._answer is not None:
            return self._answer
        spans = self._spans
        with trace(spans.finalize):
            # the wait for this search's device work, apart from the
            # copies enqueued after it
            if self._done is not None:
                with trace(spans.fetch_wait, stage="fetch_wait",
                           record=self.waits.__setitem__):
                    self._done.synchronize()
            with trace(spans.copy):
                d, pos = self._host.numpy()
            with trace(spans.id_map):
                ids = positions_to_ids(pos, self._ids_table)
                d[pos < 0] = FLT_MAX
        if self._post is None:
            return d, ids
        return self._post(d, ids, self.waits, self.counts)


def warm_up(index, batch_sizes, nprobes, variants) -> None:
    """One ``index.search`` per nprobe × batch size × ``SearchParams``
    variant, so first-use costs (kernel builds, allocator growth, graph
    captures) are paid before serving."""
    if nprobes is None:
        nprobes = (SearchParams().nprobe,)
    dummy = np.zeros((1, index.config.dimension), np.float32)
    for np_ in nprobes:
        for bs in batch_sizes:
            q = np.repeat(dummy, bs, axis=0)
            for params in variants:
                index.search(q, dataclasses.replace(params, nprobe=int(np_)))


class IVFIndexBase:
    """The search cycle and residency surface of a resident index family,
    which sets ``SPANS`` and writes :meth:`_enqueue`. A search snapshots
    and enqueues under ``_mutate_lock``, the lock every mutation holds, so
    device work runs in lock order on the one stream and reads the rows
    its snapshot's id table describes, even across a removal that moves
    rows in place (``models/arena.py``)."""

    SPANS: SearchSpans

    def __init__(self, config, device):
        self.config = config
        self.metric = config.metric
        self.device = resolve_device(device)
        self.trained = False
        # Measured-coverage nprobe; SearchParams(nprobe=0) resolves to it.
        self.calibrated_nprobe: int | None = None
        # Hotness stats behind warmup/evict decisions (ListHeat).
        self._heat = ListHeat(config.nlist, self.device)
        # Serializes mutations (each plans slots from the current counts)
        # against each other and against the enqueue of a search.
        self._mutate_lock = threading.Lock()

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.config.seed
        )

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device
        )

    def _assign_metric(self) -> Metric:
        # rows are assigned by L2 (cosine rows are pre-normalized) or by
        # negated inner product
        return (Metric.INNER_PRODUCT if self.metric == Metric.INNER_PRODUCT
                else Metric.L2)

    def _device_sample(self, x_dev: torch.Tensor):
        """``(sample, generator)``: at most ``train_sample_per_list ·
        nlist`` rows of a device-resident corpus, drawn before the fp32
        cast (a bf16 corpus is never copied whole), unit rows for cosine."""
        cfg = self.config
        x_dev = x_dev.to(self.device)
        n = x_dev.shape[0]
        if n < cfg.nlist:
            raise ValueError(f"need ≥ nlist={cfg.nlist} training vectors")
        gen = self._generator()
        cap = cfg.train_sample_per_list * cfg.nlist
        if n > cap:
            idx = torch.randperm(n, generator=gen, device=self.device)[:cap]
            sample = x_dev[idx].float()
        else:
            sample = x_dev.float()
        if self.metric == Metric.COSINE:
            sample = l2_normalize(sample)
        return sample, gen

    def search(
        self, queries: np.ndarray, params: SearchParams | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched ANN search. Returns ``(distances [B, k] fp32, ids [B, k]
        uint64)`` ascending, with FLT_MAX/UINT64_MAX sentinels for
        underfull rows."""
        return self.search_async(queries, params)()

    def search_batch(
        self, queries: np.ndarray, params: SearchParams | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Alias of :meth:`search` with the batched signature."""
        return self.search(queries, params)

    def search_async(
        self, queries: np.ndarray, params: SearchParams | None = None
    ) -> PendingSearch:
        """Enqueue the device search and return its :class:`PendingSearch`
        (``waits["enqueue"]``: host ms from entry to return). Nothing here
        waits for the card, except an IVF-PQ search capturing graphs."""
        t_enqueue = time.perf_counter()
        params = params or SearchParams()
        if not self.trained:
            raise RuntimeError("index must be trained before search()")
        queries = np.ascontiguousarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        if queries.shape[1] != self.config.dimension:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim "
                f"{self.config.dimension}"
            )
        nprobe = resolve_nprobe(params, self.calibrated_nprobe,
                                self.config.nlist)
        with trace(self.SPANS.upload):
            q_dev = upload(queries, self.device)
        with self._mutate_lock:
            pending = PendingSearch(
                self.SPANS, *self._enqueue(q_dev, queries, params, nprobe))
        pending.waits["enqueue"] = (time.perf_counter() - t_enqueue) * 1e3
        return pending

    def _enqueue(self, q_dev, queries, params, nprobe):
        """The device half under ``_mutate_lock``: ``(d, pos, ids_table,
        post)``, :class:`PendingSearch`'s arguments (``queries``: the host
        rows ``q_dev`` holds)."""
        raise NotImplementedError

    def warmup_lists(self, list_ids=None, batch_sizes=(1, 8, 64),
                     nprobes=None) -> None:
        """Run one search per batch size × nprobe × search variant
        (:func:`warm_up`); optionally mark ``list_ids`` as accessed."""
        if not self.trained:
            return
        warm_up(self, batch_sizes, nprobes, self._warmup_params())
        if list_ids is not None:
            self._heat.mark(list_ids)

    def _warmup_params(self) -> tuple:
        return (SearchParams(),)

    def evict_list(self, list_id: int) -> None:
        """The index is device-resident with nothing to evict; reset the
        list's heat, the accounting effect of an eviction."""
        self._heat.reset(list_id)

    @property
    def list_access_count(self) -> np.ndarray:
        """Per-list heat (:class:`ListHeat`): searches' queries that probed
        each list, fetched from the device."""
        return self._heat.to_numpy()

    def get_hot_lists(self, n: int) -> np.ndarray:
        """Most-accessed lists."""
        return np.argsort(-self.list_access_count, kind="stable")[:n]
