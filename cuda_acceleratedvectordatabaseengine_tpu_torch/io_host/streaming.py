"""Streaming IVF-Flat search for corpora larger than device memory
(PyTorch port of ``cuda_acceleratedvectordatabaseengine_tpu/io_host/
streaming.py``).

The corpus lives packed in host RAM (:class:`HostListStore`); an
:class:`~.cache.HbmListCache` holds the hot inverted lists on the device.
A search batch

  1. runs the coarse probe on the device (the centroids stay resident),
  2. splits its probe columns into *waves* whose distinct lists fit the
     cache, and per wave makes those lists resident (one batched upload of
     the misses) and scans the cache arena with the probes remapped to
     cache slots with the scan that ``scan_impl`` names, routed by
     ``ops/flat_scan.py`` as for the resident index: the grouped kernel K1
     (``"auto"`` on CUDA), the sorted full-row kernel K3
     (``"pallas_sorted"``, and every search deeper than K1's ``KMAX``),
     the pair kernel K4 (``"pallas"`` on a bf16 / fp32 cache) or the
     gather scan (``"auto"`` on the CPU),
  3. merges the waves' top-k on the host and maps (list, offset) to ids.

Waves are pipelined two deep: wave i's scan is issued, then wave i + 1's
uploads are staged on the host while it runs; every upload and scan is
issued on the current stream, so an upload never lands in a slot an
earlier scan is still reading (see ``io_host/cache.py``). The stages run in
the ``torch.profiler`` ranges ``streaming.coarse_probe``,
``streaming.stage`` (host staging, H2D copy, slot writes; once per wave),
the scan's own ranges, and ``streaming.merge`` (device-to-host copies and
the host merge).
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.cache import (
    HbmListCache,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.prefetcher import (
    ListPrefetcher,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
    torch_dtype,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat import (
    FLT_MAX,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.search import (
    PendingSearch,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
    Metric,
    pairwise_distance,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.flat_scan import (
    resolve_scan,
    scan_flat,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.normalize import (
    l2_normalize,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
    topk_smallest,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (
    resolve_device,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.profiling import (
    trace,
)

class HostListStore:
    """Packed inverted lists in host RAM, the host side of the tier.

    Two storage modes:

    - ``dtype="float32"``: fp32 vectors + fp32 squared norms per list.
    - ``dtype="int8"``: int8 residual codes + per-row dequant scales +
      per-list fp32 anchors (the arena quantization contract,
      ``models/arena.PackedListArena``); 4× less host RAM and 4× fewer
      upload bytes per miss than fp32. ``sq`` holds norms of the stored
      (dequantized) point.
    """

    def __init__(self, nlist: int, dim: int, dtype: str = "float32"):
        if dtype not in ("float32", "int8"):
            raise ValueError(f"unsupported store dtype {dtype!r}")
        self.nlist = nlist
        self.dim = dim
        self.dtype = dtype
        vdt = np.int8 if dtype == "int8" else np.float32
        self.vectors: list[np.ndarray] = [
            np.zeros((0, dim), vdt) for _ in range(nlist)
        ]
        self.sq: list[np.ndarray] = [
            np.zeros((0,), np.float32) for _ in range(nlist)
        ]
        self.ids: list[np.ndarray] = [
            np.zeros((0,), np.uint64) for _ in range(nlist)
        ]
        self.scale: list[np.ndarray] | None = (
            [np.zeros((0,), np.float32) for _ in range(nlist)]
            if dtype == "int8" else None
        )
        # [nlist, dim] fp32 residual anchors (int8 mode; zeros = no anchor)
        self.anchors: np.ndarray | None = (
            np.zeros((nlist, dim), np.float32) if dtype == "int8" else None
        )
        self._ids_cat: np.ndarray | None = None
        self._ids_start: np.ndarray | None = None

    @classmethod
    def from_assignments(cls, vectors, ids, assignments, nlist,
                         dtype: str = "float32", anchors=None):
        """Pack (vectors, ids, assignments) into a store. ``dtype="int8"``
        residual-quantizes each row against ``anchors[list]`` with per-row
        max-abs scales, and ``sq`` holds norms of the dequantized row (the
        JAX package's arithmetic, step for step, so both stores hold the
        same bits)."""
        store = cls(nlist, vectors.shape[1], dtype=dtype)
        if dtype == "int8":
            if anchors is None:
                raise ValueError("int8 stores need per-list anchors")
            store.anchors = np.ascontiguousarray(anchors, np.float32)
        order = np.argsort(assignments, kind="stable")
        sorted_lists = assignments[order]
        bounds = np.searchsorted(sorted_lists, np.arange(nlist + 1))
        for l in range(nlist):
            rows = order[bounds[l]:bounds[l + 1]]
            v = np.ascontiguousarray(vectors[rows], np.float32)
            if dtype == "int8":
                res = v - store.anchors[l]
                scale = np.maximum(
                    np.abs(res).max(axis=-1), 1e-12
                ).astype(np.float32) / np.float32(127.0)
                codes = np.clip(
                    np.round(res / scale[:, None]), -127, 127
                )
                deq = store.anchors[l] + codes * scale[:, None]
                store.vectors[l] = codes.astype(np.int8)
                store.scale[l] = scale
                store.sq[l] = np.einsum(
                    "nd,nd->n", deq, deq
                ).astype(np.float32)
            else:
                store.vectors[l] = v
                store.sq[l] = (v.astype(np.float64) ** 2).sum(-1).astype(
                    np.float32
                )
            store.ids[l] = ids[rows].astype(np.uint64)
        return store

    @classmethod
    def from_arena(cls, arena) -> "HostListStore":
        """Snapshot a resident ``PackedListArena`` without a dequantize
        round trip: an int8 arena keeps its codes, scales and anchors
        bit for bit; a bf16 / fp32 arena comes down as fp32. Each list is
        copied out, so the store holds only occupied rows."""
        nlist = arena.nlist
        counts = arena.counts.cpu().numpy()
        rows = arena.arena.cpu()
        sq = arena.arena_sq.cpu().numpy()
        scales = None
        if arena.dtype == torch.int8 and arena.arena_scale is not None:
            store = cls(nlist, arena.dim, dtype="int8")
            rows = rows.numpy()
            scales = arena.arena_scale.cpu().numpy()
            if arena.anchors is not None:
                store.anchors = arena.anchors.cpu().numpy().astype(
                    np.float32)
        else:
            store = cls(nlist, arena.dim, dtype="float32")
        for l in range(nlist):
            c = int(counts[l])
            v = rows[l, :c]
            store.vectors[l] = (v.copy() if scales is not None
                                else v.to(torch.float32, copy=True).numpy())
            store.sq[l] = sq[l, :c].copy()
            store.ids[l] = arena.ids[l, :c].copy()
            if scales is not None:
                store.scale[l] = scales[l, :c].copy()
        return store

    def count(self, list_id: int) -> int:
        return self.vectors[list_id].shape[0]

    def max_count(self) -> int:
        return max((v.shape[0] for v in self.vectors), default=0)

    def total(self) -> int:
        return sum(v.shape[0] for v in self.vectors)

    def fetch(self, list_id: int):
        """``host_fetch`` of the cache: ``(values, sq, count)`` for an fp32
        store, ``(codes, sq, count, scale, anchor)`` for an int8 one."""
        base = (
            self.vectors[list_id], self.sq[list_id], self.count(list_id),
        )
        if self.dtype == "int8":
            return base + (self.scale[list_id], self.anchors[list_id])
        return base

    def lookup_ids(self, lists: np.ndarray, offs: np.ndarray) -> np.ndarray:
        """Vectorized (list, offset) → user id; ``-1`` lists map to
        INVALID_ID. The concatenated id table is built at first use and
        kept (``invalidate_ids`` drops it after a mutation)."""
        if self._ids_cat is None:
            counts = np.asarray([i.shape[0] for i in self.ids], np.int64)
            self._ids_start = np.concatenate(
                [[0], np.cumsum(counts)]
            ).astype(np.int64)
            self._ids_cat = (
                np.concatenate(self.ids)
                if counts.sum() else np.zeros((0,), np.uint64)
            )
        out = np.full(lists.shape, INVALID_ID, np.uint64)
        valid = lists >= 0
        if valid.any():
            flat = (
                self._ids_start[lists[valid]] + offs[valid].astype(np.int64)
            )
            out[valid] = self._ids_cat[flat]
        return out

    def invalidate_ids(self) -> None:
        self._ids_cat = self._ids_start = None

    def nbytes(self) -> int:
        n = sum(
            v.nbytes + s.nbytes + i.nbytes
            for v, s, i in zip(self.vectors, self.sq, self.ids)
        )
        if self.scale is not None:
            n += sum(s.nbytes for s in self.scale) + self.anchors.nbytes
        return n


def _stage_lists(cache, store, gate, list_ids) -> None:
    """Make ``list_ids`` resident in ``cache`` from ``store``, under the
    tier's cache ``gate``."""
    with gate:
        cache.ensure_resident(np.asarray(list_ids, np.int64), store.fetch)


class StreamingIVFFlatIndex:
    """IVF-Flat search over a host-RAM corpus through a device list cache.

    Device memory is bounded by ``cache_slots × capacity × dim`` stored
    bytes (plus the centroids), whatever the corpus size. Runs on
    ``device``: the card unless the caller names another. Built from an
    index, the tier copies its rows to the host store: a later
    ``remove_ids`` on that index is not seen here (removal while a tier
    serves is not supported, as in the JAX package).
    """

    trained = True          # both constructors require trained inputs
    read_only = True        # mutations go to the next build

    def __init__(
        self,
        base: IVFFlatIndex,
        cache_slots: int | None = None,
        max_device_bytes: int | None = None,
        policy: str = "lru",
        scan_impl: str = "auto",
        device: torch.device | str | None = "cuda",
    ):
        if not base.trained:
            raise RuntimeError("base index must be trained")
        store = HostListStore.from_arena(base.arena)
        self._init_from_store(
            store, base.centroids, base.config, cache_slots,
            max_device_bytes, policy, scan_impl, base.arena.capacity, device,
        )

    @classmethod
    def from_store(
        cls,
        store: HostListStore,
        centroids,
        config,
        cache_slots: int | None = None,
        max_device_bytes: int | None = None,
        policy: str = "lru",
        scan_impl: str = "auto",
        capacity: int | None = None,
        device: torch.device | str | None = "cuda",
    ) -> "StreamingIVFFlatIndex":
        """Build straight from a host-RAM store: the entry point for a
        corpus that never fit on the device."""
        self = cls.__new__(cls)
        self._init_from_store(
            store, centroids, config, cache_slots, max_device_bytes,
            policy, scan_impl, capacity, device,
        )
        return self

    def _init_from_store(self, store, centroids, config, cache_slots,
                         max_device_bytes, policy, scan_impl, capacity,
                         device) -> None:
        self.device = resolve_device(device)
        self.config = config
        self.metric = config.metric
        if not isinstance(centroids, torch.Tensor):
            centroids = torch.tensor(np.asarray(centroids, np.float32))
        self.centroids = centroids.float().to(self.device)
        self.store = store
        nlist = config.nlist
        cap = capacity if capacity is not None else max(
            -(-store.max_count() // 128) * 128, 128
        )
        if store.dtype == "int8":
            # codes, per-row scales and anchors stay quantized end to end:
            # 1 byte per dimension on the wire and on the device
            dtype = torch.int8
        else:
            dtype = torch_dtype(config.dtype)
            if dtype == torch.int8:
                # an fp32 store under an int8 config would need fresh
                # per-row scales per miss; bf16 keeps most of the saving
                dtype = torch.bfloat16
        if cache_slots is None:
            per_slot = cap * config.dimension * dtype.itemsize
            budget = max_device_bytes or (per_slot * max(nlist // 4, 1))
            cache_slots = max(int(budget // max(per_slot, 1)), 1)
        cache_slots = min(cache_slots, nlist)
        self.cache = self._make_cache(cache_slots, cap, config.dimension,
                                      dtype, policy)
        # the scan for a shallow search; a deeper one is routed per call
        self.scan_impl = resolve_scan(
            scan_impl, on_cuda=self.device.type == "cuda",
            scaled=self.cache.quantized)
        # the scanned slot prefix: the store is read-only, so its longest
        # list bounds every cached list
        self._scan_capacity = max(store.max_count(), 1)
        # Serializes cache mutation against the wave pipeline: a background
        # staging that evicts a list between a wave's slot mapping and its
        # scan issue would scan the wrong rows.
        self._cache_gate = threading.RLock()
        # Hotness-driven residency: every search feeds its probe table in,
        # and prefetch_hot_lists re-stages the decayed-hot working set. The
        # prefetcher holds the cache, the store and the gate, not the tier,
        # so dropping the tier frees its device cache and pinned buffers
        # at once (no reference cycle waits for the collector).
        self.list_prefetcher = ListPrefetcher(stage_fn=functools.partial(
            _stage_lists, self.cache, self.store, self._cache_gate))
        self.batches = 0
        self.waves = 0

    def _make_cache(self, cache_slots, cap, dim, dtype, policy):
        return HbmListCache(cache_slots, cap, dim, dtype, policy,
                            device=self.device)

    # ------------------------------------------------------------------ #
    # serving surface
    # ------------------------------------------------------------------ #

    @property
    def ntotal(self) -> int:
        return self.store.total()

    def warmup_lists(self, list_ids=None, batch_sizes=(1, 8, 64),
                     nprobes=None) -> None:
        """Stage ``list_ids`` into the cache; with none, run one search per
        batch size × nprobe (first-use costs: the kernel build, allocator
        growth)."""
        if list_ids is not None:
            self.prefetch_lists(np.asarray(list_ids, np.int64))
            return
        if nprobes is None:
            nprobes = (1,)
        dummy = np.zeros((1, self.config.dimension), np.float32)
        for np_ in nprobes:
            params = SearchParams(nprobe=int(np_))
            for bs in batch_sizes:
                self.search(np.repeat(dummy, bs, axis=0), params)

    def evict_list(self, list_id: int) -> None:
        """Free the list's cache slot."""
        self.cache.evict_list(int(list_id))

    def memory_stats(self) -> dict:
        cent = self.centroids.numel() * 4
        return {
            "arena_bytes": self.cache.memory_bytes(),
            "centroid_bytes": int(cent),
            "total_bytes": self.cache.memory_bytes() + int(cent),
            "host_bytes": self.store.nbytes(),
            "total_vectors": self.ntotal,
            "nlist": self.config.nlist,
            "capacity_per_list": self.cache.capacity,
            "cache_hit_rate": self.cache.get_hit_rate(),
        }

    def prefetch_lists(self, list_ids) -> None:
        """Make ``list_ids`` resident (warmup and hotness staging)."""
        _stage_lists(self.cache, self.store, self._cache_gate, list_ids)

    def prefetch_hot_lists(self, max_lists: int | None = None) -> list[int]:
        """Stage the hottest lists (recency-decayed probe counts of the
        served searches) back into the cache; at most half the cache by
        default, so re-staging never wipes the live working set."""
        if max_lists is None:
            max_lists = max(1, self.cache.n_slots // 2)
        max_lists = min(max_lists, self.cache.n_slots)
        return self.list_prefetcher.prefetch_hot_lists(max_lists)

    def search_async(
        self, queries: np.ndarray, params: SearchParams | None = None
    ) -> PendingSearch:
        """:meth:`search`, run now (the tier stages lists between its
        scans): a :meth:`PendingSearch.ready`, which records no stage."""
        return PendingSearch.ready(*self.search(queries, params))

    def search(
        self, queries: np.ndarray, params: SearchParams | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched search; returns ``(distances [B, k] fp32, ids [B, k]
        uint64)`` ascending, FLT_MAX / INVALID_ID padding short rows."""
        params = params or SearchParams()
        queries = np.ascontiguousarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        b = queries.shape[0]
        nprobe = min(params.nprobe, self.config.nlist)

        with trace("streaming.coarse_probe"):
            q = torch.from_numpy(queries).to(self.device)
            if self.metric == Metric.COSINE:
                q = l2_normalize(q)
            _, probe = topk_smallest(
                pairwise_distance(q, self.centroids, self.metric), nprobe)
            probe_h = probe.int().cpu().numpy()   # [B, nprobe], tiny
        uniq, cnt = np.unique(probe_h, return_counts=True)
        self.list_prefetcher.record_many(uniq, cnt)

        # One probe column whose distinct lists exceed the cache cannot be
        # staged in one wave. Rows are independent: split the batch in
        # half and recurse (a one-row column touches one list).
        if b > 1:
            worst = max(len(np.unique(probe_h[:, j]))
                        for j in range(probe_h.shape[1]))
            if worst > self.cache.n_slots:
                mid = (b + 1) // 2
                d1, i1 = self.search(queries[:mid], params)
                d2, i2 = self.search(queries[mid:], params)
                return (np.concatenate([d1, d2], axis=0),
                        np.concatenate([i1, i2], axis=0))

        waves = self._plan_waves(probe_h)
        self.batches += 1
        self.waves += len(waves)
        k = params.k
        cap = self.cache.capacity
        all_d, all_l, all_o = [], [], []

        def convert(d_dev, pos_dev, rev):
            with trace("streaming.merge"):
                d = d_dev.cpu().numpy()
                pos = pos_dev.cpu().numpy()
                valid = pos >= 0
                safe = np.maximum(pos, 0)
                all_d.append(d)
                all_l.append(np.where(valid, rev[safe // cap], -1))
                all_o.append(np.where(valid, safe % cap, 0))

        # Two waves in flight: wave i's scan is issued, then wave i + 1's
        # misses are staged on the host while it runs. The in-place slot
        # writes are issued on the same stream after wave i's scan, so they
        # never change rows it is reading.
        pending: list[tuple] = []
        wave_sets = [set(int(l) for l in np.unique(probe_h[:, cols]))
                     for cols in waves]
        for wi, cols in enumerate(waves):
            wave_probe = probe_h[:, cols]
            with self._cache_gate:
                with trace("streaming.stage"):
                    mapping = self.cache.ensure_resident(
                        wave_probe.reshape(-1), self.store.fetch,
                        soft_protect=(wave_sets[wi + 1]
                                      if wi + 1 < len(waves) else None),
                    )
                lut = np.full(self.config.nlist, -1, np.int32)
                for l, s in mapping.items():
                    lut[l] = s
                # fixed width: pad every wave to nprobe columns of -1
                # (skipped by every scan, the sentinel row never read)
                slot_probe = np.full((b, nprobe), -1, np.int32)
                slot_probe[:, :len(cols)] = lut[wave_probe]
                d_dev, pos_dev = self._run_cache_scan(
                    q, torch.from_numpy(slot_probe).to(self.device), k)
            # slot → list, captured before the next wave remaps
            rev = np.full(self.cache.n_slots + 1, -1, np.int64)
            for l, s in mapping.items():
                rev[s] = l
            pending.append((d_dev, pos_dev, rev))
            if len(pending) > 2:
                convert(*pending.pop(0))
        for w in pending:
            convert(*w)

        with trace("streaming.merge"):
            d = np.concatenate(all_d, axis=1)
            lists = np.concatenate(all_l, axis=1)
            offs = np.concatenate(all_o, axis=1)
            order = np.argsort(d, axis=1, kind="stable")[:, :k]
            d = np.take_along_axis(d, order, 1).copy()
            lists = np.take_along_axis(lists, order, 1)
            offs = np.take_along_axis(offs, order, 1)
            out_ids = self.store.lookup_ids(lists, offs)
            d[lists < 0] = FLT_MAX
        return d, out_ids

    def _run_cache_scan(self, q, slot_probe, k: int):
        """One wave's scan over the cache arena (slot-remapped probes)."""
        c = self.cache
        return scan_flat(
            self.scan_impl, q, c.cache_arena, c.cache_sq, c.cache_counts,
            slot_probe, k, self.metric, arena_scale=c.cache_scale,
            arena_anchors=c.cache_anchors, scan_capacity=self._scan_capacity)

    def _plan_waves(self, probe_h: np.ndarray) -> list[list[int]]:
        """Greedy column grouping: each wave's distinct lists ≤ cache
        slots."""
        slots = self.cache.n_slots
        waves: list[list[int]] = []
        current: list[int] = []
        working: set[int] = set()
        for col in range(probe_h.shape[1]):
            col_lists = set(int(l) for l in np.unique(probe_h[:, col]))
            if len(col_lists) > slots:
                raise ValueError(
                    f"one probe column touches {len(col_lists)} lists but "
                    f"the cache has {slots} slots; raise cache_slots or "
                    "lower the batch size"
                )
            if current and len(working | col_lists) > slots:
                waves.append(current)
                current, working = [], set()
            current.append(col)
            working |= col_lists
        if current:
            waves.append(current)
        return waves

    def stats(self) -> dict:
        return {
            "hit_rate": self.cache.get_hit_rate(),
            "hits": self.cache.hits,
            "misses": self.cache.misses,
            "resident": len(self.cache.resident_lists()),
            "slots": self.cache.n_slots,
            "device_bytes": self.cache.memory_bytes(),
            "host_bytes": self.store.nbytes(),
            "h2d_bytes": self.cache.h2d_bytes,
            "batches": self.batches,
            "waves": self.waves,
        }
