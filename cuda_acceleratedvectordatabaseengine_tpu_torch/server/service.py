"""The serving engine and the ``vdb.QueryService`` / ``vdb.AdminService``
servicers (port of the JAX package's ``server/service.py``).

``VdbEngine`` holds the index registry, the epochs, the metrics and the
admission control; every index it creates or loads lives on the engine's
device (the card unless another is named). A search is admitted (circuit
breaker, rate limiter, concurrency limiter), submitted to the index's
request coalescer, dispatched as one device batch per drained window
(``search_async``) and finalized one batch later, so the coalescer
dispatches batch N before it fetches batch N−1.

This module imports neither ``grpc`` nor ``protobuf``: the servicers import
them when they are built, so the engine runs on a machine without either.
Admission and completion are engine methods (``submit_search``,
``finish_search``) that the servicers call after decoding a request; a
refusal raises :class:`Rejected` naming the gRPC status code.

Differences from the JAX engine:

- a warm-up failure propagates (activation fails) instead of being dropped;
- a snapshot that fails to reload at start-up is logged through
  ``get_logger`` and recorded on the index state (``IndexState.error``);
- ``close()`` also stops every index's coalescer;
- an unported option raises ``NotImplementedError``: a
  ``query_upload_dtype`` other than ``"float32"``;
- the mesh of sharded serving (``parallel/``) is one process's list of
  devices: ``shard_serving`` / ``mesh_shards`` build it over the visible
  devices of the engine's device type (on the CPU, ``mesh_shards`` CPU
  shards), and ``VdbEngine(mesh=...)`` takes an explicit one, which wins.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import os
import threading
import time

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.builder import (
    build_index_chunked,
    train_sample_rows,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
    PrefetchScheduler,
    StreamingIVFFlatIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq import (
    IVFPQConfig,
    IVFPQIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.search import (
    PendingSearch,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel import (
    ShardedIVFFlatIndex,
    ShardedIVFPQIndex,
    ShardedStreamingIVFFlatIndex,
    make_mesh,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.balancer import (
    AdaptiveController,
    CircuitBreaker,
    ConcurrencyLimiter,
    Priority,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.coalescer import (
    QueueFullError,
    RequestCoalescer,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.config import (
    ServerConfig,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.metrics import (
    MetricsCollector,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.ratelimit import (
    RateLimiter,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
    ArrowStorage,
    IndexManifest,
    VectorFileWriter,
    load_ivf_flat,
    load_ivf_flat_host,
    load_ivf_pq,
    load_ivf_pq_capacity,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.epoch import (
    EpochManager,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.snapshot import (
    VECTORS_FILE,
    save_ivf_pq,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.batching import (
    BUCKETS,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (
    resolve_device,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.logging import (
    get_logger,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.profiling import (
    trace,
)

log = get_logger("vdb.server")

MAX_TOPK = 1000
MAX_QUERIES = 8192    # one device batch; rate limiting is per request, so
                      # this is the per-token work bound (see _validate)
MAX_DIMENSION = 65536


class Rejected(Exception):
    """A search refused at admission or past its deadline; ``code`` is the
    name of the gRPC status the wire returns for it."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


@dataclasses.dataclass
class IndexState:
    """Per-index live state."""

    name: str
    config: dict                      # creation parameters
    index: object | None = None       # IVFFlatIndex | IVFPQIndex | streaming
    epoch: str = ""
    coalescer: RequestCoalescer | None = None
    pending_vectors: list = dataclasses.field(default_factory=list)
    pending_ids: list = dataclasses.field(default_factory=list)
    error: str = ""                   # why the active epoch failed to load


@dataclasses.dataclass
class BuildJob:
    epoch_id: str
    progress: float = 0.0
    error: str = ""
    done: bool = False


class VdbEngine:
    """Shared engine state: index registry, epochs, metrics, admission. All
    indices live on ``device`` (``"cuda"`` unless another is named); with a
    mesh (``mesh``, or one built from ``shard_serving`` / ``mesh_shards``)
    resident IVF-Flat / IVF-PQ indices serve through the sharded views and
    streaming tiers cache on the mesh."""

    def __init__(self, config: ServerConfig,
                 device: torch.device | str | None = None, mesh=None):
        self.config = config
        self.device = resolve_device(device)
        mode = config.shard_serving
        if mode not in ("auto", "on", "off"):
            raise ValueError(
                f"shard_serving must be auto|on|off, got {mode!r}"
            )
        if config.query_upload_dtype != "float32":
            raise NotImplementedError(
                f"query_upload_dtype {config.query_upload_dtype!r} is not "
                f"ported; only 'float32' is"
            )
        # Sharded serving: epoch activation wraps resident indices in the
        # sharded views and builds streaming tiers on the mesh, so every
        # coalesced batch dispatches one mesh-wide search. An explicit mesh
        # wins over the config; "auto" builds one only over more than one
        # device.
        self.mesh = mesh
        if mesh is None and mode != "off":
            n = config.mesh_shards or (
                torch.cuda.device_count() if self.device.type == "cuda"
                else 1)
            if n > 1 or mode == "on":
                self.mesh = (make_mesh(n) if self.device.type == "cuda"
                             else make_mesh(devices=[self.device] * n))
        if self.mesh is not None:
            log.info("sharded serving over %d devices", self.mesh.size)
        os.makedirs(config.data_path, exist_ok=True)
        self.epochs = EpochManager(
            os.path.join(config.data_path, "epochs"),
            keep_epochs=config.keep_epochs,
        )
        self.indices_dir = os.path.join(config.data_path, "indices")
        os.makedirs(self.indices_dir, exist_ok=True)
        self.metrics = MetricsCollector()
        self.rate_limiter = RateLimiter(
            config.rate_limit_rps, config.rate_limit_burst
        )
        self.breaker = CircuitBreaker(
            config.breaker_error_threshold,
            config.breaker_open_seconds,
            config.breaker_decay,
        )
        self.limiter = ConcurrencyLimiter(config.max_concurrent_requests)
        self.adaptive = AdaptiveController(config.max_batch_size)
        self.lock = threading.RLock()
        self.indices: dict[str, IndexState] = {}
        self.build_jobs: dict[str, BuildJob] = {}
        # In-memory mirror of each index's tombstone log (sorted unique
        # u64). The file is the WAL; this cache makes the per-AddVectors
        # unmark check O(set) instead of a full-file read under the
        # engine lock, and lets appends dedupe.
        self._tomb_cache: dict[str, np.ndarray] = {}
        # Background hotness-driven residency: a timer queues each
        # streaming-tier index's hot-list re-staging into the byte-rate
        # throttled PrefetchScheduler.
        self.prefetch_scheduler = PrefetchScheduler(
            bandwidth_limit_bps=config.prefetch_bandwidth_bps
        )
        self._stop_event = threading.Event()
        self._hotness_thread = None
        if config.prefetch_hot_interval_s > 0:
            self._hotness_thread = threading.Thread(
                target=self._hotness_loop, name="hotness-prefetch",
                daemon=True,
            )
            self._hotness_thread.start()
        self._recover()

    def _hotness_loop(self) -> None:
        interval = self.config.prefetch_hot_interval_s
        while not self._stop_event.wait(interval):
            with self.lock:
                live = [
                    st.index for st in self.indices.values()
                    if st.index is not None
                    and hasattr(st.index, "prefetch_hot_lists")
                ]
            for idx in live:
                cache = getattr(idx, "cache", None)
                if cache is None:
                    continue
                n_max = max(1, cache.n_slots // 2)
                per_slot = int(cache.memory_bytes() // max(cache.n_slots, 1))
                self.prefetch_scheduler.schedule(
                    idx.prefetch_hot_lists,
                    priority=0, nbytes=per_slot * n_max,
                )

    def close(self) -> None:
        """Stop the background machinery (hotness loop, prefetch scheduler,
        every index's coalescer); idempotent."""
        self._stop_event.set()
        if self._hotness_thread is not None:
            self._hotness_thread.join(timeout=2)
            self._hotness_thread = None
        try:
            self.prefetch_scheduler.stop()
        except RuntimeError:
            pass
        with self.lock:
            states = list(self.indices.values())
        for st in states:
            if st.coalescer is not None:
                st.coalescer.stop()
                st.coalescer = None

    # ------------------------------------------------------------------ #
    # recovery: re-register created indices, reload active epochs
    # ------------------------------------------------------------------ #

    def _recover(self) -> None:
        for name in sorted(os.listdir(self.indices_dir)):
            cfg_path = os.path.join(self.indices_dir, name, "config.json")
            if not os.path.isfile(cfg_path):
                continue
            with open(cfg_path) as f:
                cfg = json.load(f)
            st = IndexState(name=name, config=cfg)
            self.indices[name] = st
            active = self.epochs.active_dir(name)
            if active and os.path.isfile(
                os.path.join(active, IndexManifest.FILENAME)
            ):
                try:
                    self._load_epoch_into(st, self.epochs.active_epoch(name))
                except Exception as e:  # noqa: BLE001 — degrade, don't die
                    st.error = f"{type(e).__name__}: {e}"
                    log.error("index %s: active epoch failed to load: %s",
                              name, st.error)

    # ------------------------------------------------------------------ #
    # index lifecycle
    # ------------------------------------------------------------------ #

    def create_index(self, name, dimension, metric, nlist, m, nbits,
                     tier: str = "", rerank_k: int = 0) -> None:
        """Register an index and write its creation parameters.
        ``rerank_k`` (IVF-PQ only) is the exact-rerank depth of an index
        the engine builds itself (``IVFPQConfig.rerank_k``); 0 keeps the
        default depth and writes nothing."""
        if rerank_k < 0 or (rerank_k and not m):
            raise ValueError(f"rerank_k {rerank_k}: a depth >= 0, and an "
                             f"IVF-PQ parameter (m > 0)")
        with self.lock:
            if name in self.indices:
                raise KeyError(f"index {name!r} already exists")
            cfg = {
                "dimension": dimension,
                "metric": metric,
                "nlist": nlist or self.config.default_nlist,
                "m": m,
                "nbits": nbits or 8,
                "dtype": self.config.arena_dtype,
                "tier": tier or "resident",
            }
            if rerank_k:
                cfg["rerank_k"] = int(rerank_k)
            d = os.path.join(self.indices_dir, name)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump(cfg, f, indent=2)
            self.indices[name] = IndexState(name=name, config=cfg)

    def _new_index(self, cfg: dict):
        if cfg.get("m"):
            return IVFPQIndex(IVFPQConfig(
                dimension=cfg["dimension"], nlist=cfg["nlist"], m=cfg["m"],
                nbits=cfg.get("nbits", 8), metric=cfg["metric"],
                raw_dtype=cfg.get("dtype", "bfloat16"),
                # Capacity tier: only codes live on the device (~m bytes a
                # row); the exact rerank reads the epoch's host row store.
                keep_raw=cfg.get("tier") != "pq_capacity",
                rerank_k=int(cfg.get("rerank_k", 0)),
            ), device=self.device)
        return IVFFlatIndex(IVFFlatConfig(
            dimension=cfg["dimension"], nlist=cfg["nlist"],
            metric=cfg["metric"], dtype=cfg.get("dtype", "bfloat16"),
        ), device=self.device)

    def _make_coalescer(self, st: IndexState) -> RequestCoalescer:
        return RequestCoalescer(
            dispatch_fn=lambda items: self._dispatch_batch(st, items),
            window_s=self.config.coalesce_window_ms / 1000.0,
            max_batch=self.config.max_batch_size,
            name=f"coalesce-{st.name}",
            # max_batch counts QUERIES, not requests: a drained batch of
            # multi-query requests never exceeds the warmed batch width.
            weight_fn=lambda item: int(item[0].shape[0]),
            # Latency-adaptive draining: shrinks the batch cap only when
            # the measured batch wall time blows the budget.
            max_batch_fn=lambda: self.adaptive.batch_size(
                self.limiter.active, self.limiter.max_concurrent
            ),
            # Fail-fast backlog bound: shed at admission instead of
            # queueing work past its deadline.
            max_queue=self.config.max_queued_requests or None,
            record_stage=self.metrics.record_stage,
        )

    def _load_epoch_into(self, st: IndexState, epoch_id: str) -> None:
        path = self.epochs.epoch_dir(st.name, epoch_id)
        man = IndexManifest.load(path)
        tier = st.config.get("tier")
        if tier == "streaming" and man.kind == "ivf_flat":
            # Past the device memory wall: the epoch loads into host RAM
            # and serves through a device list cache, so activation never
            # materializes a device arena.
            store, centroids, cfg, cap = load_ivf_flat_host(path)
            # Size the cache so one probe column of the coalescer's largest
            # batch fits without row-splitting.
            slots = None
            if not self.config.streaming_cache_bytes:
                slots = min(
                    cfg.nlist,
                    max(cfg.nlist // 4, self.config.max_batch_size),
                )
            cache_kw = dict(
                cache_slots=slots,
                max_device_bytes=self.config.streaming_cache_bytes or None,
                capacity=cap,
                policy=self.config.streaming_cache_policy,
            )
            if self.mesh is not None:
                # the cache's slot bytes stripe over the mesh: the cached
                # working set grows with the shard count
                index = ShardedStreamingIVFFlatIndex(
                    self.mesh, store, torch.from_numpy(centroids), cfg,
                    **cache_kw)
            else:
                index = StreamingIVFFlatIndex.from_store(
                    store, torch.from_numpy(centroids).to(self.device), cfg,
                    device=self.device, **cache_kw)
        elif tier == "pq_capacity" and man.kind == "ivf_pq":
            # Capacity tier: codes rebuild the device arena; raw rows load
            # into an int8 host store serving the exact rerank.
            index = load_ivf_pq_capacity(
                path, rerank_k=self.config.pq_rerank_k,
                margin=self.config.pq_rerank_margin, device=self.device,
            )
        elif man.kind == "ivf_pq":
            index = load_ivf_pq(path, device=self.device)
        else:
            index = load_ivf_flat(path, device=self.device)

        # Re-apply persisted tombstones: snapshots are immutable, so
        # deletions accepted since the last build live in the per-index
        # log and are replayed on every load (idempotent by id).
        tombs = self._read_tombstones(st.name)
        if tombs.size:
            if hasattr(index, "remove_ids") and not getattr(
                index, "read_only", False
            ):
                index.remove_ids(tombs)
            else:
                log.warning(
                    "index %s: %d tombstoned ids NOT applied (read-only "
                    "serving tier); rebuild an epoch to bake them",
                    st.name, int(tombs.size),
                )

        if (
            self.mesh is not None
            and isinstance(index, (IVFFlatIndex, IVFPQIndex))
            and not getattr(index, "read_only", False)
        ):
            # Resident tier on a mesh: publish the loaded (and tombstone-
            # replayed) arena as slot stripes. The base stays attached for
            # mutations and snapshots; the pq_capacity tier (read-only, its
            # second stage the host reranker) stays on one device.
            index = (ShardedIVFPQIndex(index, self.mesh)
                     if isinstance(index, IVFPQIndex)
                     else ShardedIVFFlatIndex(index, self.mesh))

        # Warm every batch size the coalescer can emit and every serving
        # nprobe (the configured ones and the snapshot's calibration)
        # before the swap goes live: first-use costs (the kernel build,
        # allocator growth) land here, not on a request. A failure fails
        # the activation.
        sizes = [b for b in BUCKETS if b <= self.config.max_batch_size]
        if self.config.max_batch_size not in sizes:
            sizes.append(self.config.max_batch_size)
        nprobes = sorted(
            {int(self.config.default_nprobe)}
            | {int(p) for p in (self.config.warm_nprobes or ())}
            | ({int(index.calibrated_nprobe)}
               if getattr(index, "calibrated_nprobe", None) else set())
        )
        index.warmup_lists(batch_sizes=tuple(sizes), nprobes=tuple(nprobes))
        with self.lock:
            # Deletes accepted during the warm-up hit the OLD index and the
            # log but missed the replay above: apply the delta before the
            # new index goes live, under the lock.
            fresh = self._read_tombstones(st.name)
            delta = (
                fresh[~np.isin(fresh, tombs)] if tombs.size else fresh
            )
            if delta.size and hasattr(index, "remove_ids") and not getattr(
                index, "read_only", False
            ):
                index.remove_ids(delta)
            st.index = index
            st.epoch = epoch_id
            st.error = ""
            if st.coalescer is None:
                st.coalescer = self._make_coalescer(st)
        self._update_memory_gauge()

    def activate_epoch(self, name: str, epoch_id: str) -> None:
        """The ActivateEpoch RPC: load ``epoch_id`` into the index (load,
        tombstone replay, warm-up, swap) and record it as the active
        epoch."""
        self._load_epoch_into(self.get_state(name), epoch_id)
        self.epochs.activate_epoch(name, epoch_id)

    def _update_memory_gauge(self) -> None:
        total = 0
        for st in list(self.indices.values()):
            if st.index is not None:
                total += st.index.memory_stats()["total_bytes"]
        self.metrics.set_device_memory(total)

    def get_state(self, name: str) -> IndexState:
        with self.lock:
            if name not in self.indices:
                raise KeyError(name)
            return self.indices[name]

    # ------------------------------------------------------------------ #
    # ingest + build
    # ------------------------------------------------------------------ #

    def add_vectors(self, name, vectors, ids) -> tuple[int, int]:
        st = self.get_state(name)
        with self.lock:
            self._unmark_tombstones(name, np.asarray(ids, np.uint64))
            if (
                st.index is not None and st.index.trained
                and not getattr(st.index, "read_only", False)
            ):
                st.index.add(vectors, ids)
                total = st.index.ntotal
            else:
                # untrained index or a read-only serving tier: buffer for
                # the next BuildEpoch
                st.pending_vectors.append(vectors)
                st.pending_ids.append(ids)
                total = sum(len(v) for v in st.pending_vectors)
        self._update_memory_gauge()
        return len(vectors), total

    def remove_vectors(self, name, ids) -> tuple[int, int]:
        """Delete by user id. Only a mutable resident index deletes in
        place; the read-only serving tiers (streaming, pq_capacity) raise
        ``PermissionError`` and take deletions through an epoch rebuild.

        Durability: accepted deletions also append to a per-index tombstone
        log (``deletions.u64``) that is replayed whenever an epoch snapshot
        loads and consumed by the next build that bakes them, so a restart
        or an epoch reload never resurrects a deleted id."""
        st = self.get_state(name)
        with self.lock:
            if st.index is None or not st.index.trained:
                raise ValueError("index has no live data to remove from")
            if getattr(st.index, "read_only", False) or not hasattr(
                st.index, "remove_ids"
            ):
                raise PermissionError(
                    "serving tier is read-only; rebuild an epoch without "
                    "the removed ids instead"
                )
            ids = np.asarray(ids, np.uint64)
            removed = st.index.remove_ids(ids)
            total = st.index.ntotal
            self._append_tombstones(name, ids)
        self._update_memory_gauge()
        return removed, total

    # ------------------------------------------------------------------ #
    # deletion tombstones (durability across epoch reloads / restarts)
    # ------------------------------------------------------------------ #

    def _tombstone_path(self, name: str) -> str:
        return os.path.join(self.indices_dir, name, "deletions.u64")

    def _append_tombstones(self, name: str, ids: np.ndarray) -> None:
        with self.lock:
            existing = self._read_tombstones(name)
            fresh = np.asarray(ids, np.uint64)
            if existing.size:
                fresh = fresh[~np.isin(fresh, existing)]
            fresh = np.unique(fresh)
            if fresh.size == 0:
                return
            with open(self._tombstone_path(name), "ab") as f:
                f.write(np.ascontiguousarray(fresh, "<u8").tobytes())
                # an acknowledged removal survives power loss
                f.flush()
                os.fsync(f.fileno())
            self._tomb_cache[name] = np.union1d(existing, fresh)

    def _read_tombstones(self, name: str) -> np.ndarray:
        with self.lock:
            cached = self._tomb_cache.get(name)
            if cached is not None:
                return cached
            try:
                with open(self._tombstone_path(name), "rb") as f:
                    raw = f.read()
            except FileNotFoundError:
                raw = b""
            # A torn final record (crash mid-append) is dropped; complete
            # earlier records still apply.
            raw = raw[: len(raw) - (len(raw) % 8)]
            tombs = np.unique(np.frombuffer(raw, "<u8"))
            self._tomb_cache[name] = tombs
            return tombs

    def _write_tombstones(self, name: str, ids: np.ndarray) -> None:
        """Atomic full rewrite (temp + rename): a crash mid-rewrite never
        leaves a truncated log that resurrects deletions."""
        path = self._tombstone_path(name)
        ids = np.unique(np.asarray(ids, np.uint64))
        if ids.size == 0:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        else:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(np.ascontiguousarray(ids, "<u8").tobytes())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        self._tomb_cache[name] = ids

    def _clear_tombstones(self, name: str) -> None:
        with self.lock:
            self._tomb_cache[name] = np.zeros(0, np.uint64)
            try:
                os.remove(self._tombstone_path(name))
            except FileNotFoundError:
                pass

    def _consume_tombstones(self, name: str, baked: np.ndarray) -> None:
        """Drop exactly the tombstones a finished build baked into its
        snapshot: deletions accepted while it ran are absent from that
        snapshot and stay in the log to be replayed on the next load."""
        with self.lock:
            existing = self._read_tombstones(name)
            if existing.size == 0:
                return
            kept = existing[~np.isin(existing, np.asarray(baked, np.uint64))]
            if kept.size == existing.size:
                return
            self._write_tombstones(name, kept)

    def _unmark_tombstones(self, name: str, ids: np.ndarray) -> None:
        """Re-adding an id revokes its tombstone; otherwise the next build
        would drop a legitimately re-used id."""
        with self.lock:
            existing = self._read_tombstones(name)
            if existing.size == 0:
                return
            kept = existing[
                ~np.isin(existing, np.asarray(ids, np.uint64))
            ]
            if kept.size == existing.size:
                return
            self._write_tombstones(name, kept)

    def build_epoch(self, name: str, source_path: str = "") -> str:
        """Start an asynchronous epoch build; returns its epoch id. The
        ``BuildJob`` in ``build_jobs[name]`` reports progress and errors."""
        st = self.get_state(name)
        with self.lock:
            job = self.build_jobs.get(name)
            if job and not job.done:
                raise RuntimeError(f"build already running for {name!r}")
            epoch_id, epoch_dir = self.epochs.create_epoch(name)
            job = BuildJob(epoch_id=epoch_id)
            self.build_jobs[name] = job

        def worker():
            try:
                self._build_worker(st, job, epoch_dir, source_path)
            except Exception as e:  # noqa: BLE001
                job.error = str(e)
                log.error("index %s: build of epoch %s failed: %s",
                          name, epoch_id, e)
            finally:
                job.done = True

        threading.Thread(
            target=worker, name=f"build-{name}", daemon=True
        ).start()
        return epoch_id

    def _build_worker(self, st, job, epoch_dir, source_path) -> None:
        """Chunked build: the source file streams through the index's
        device ingest one chunk at a time (peak host RAM ≈ one chunk plus
        the training sample), with ``build_index_chunked``'s capacity law
        and BuildJob progress per chunk."""
        cfg = st.config
        with self.lock:
            pending_v = st.pending_vectors
            pending_i = st.pending_ids
            st.pending_vectors, st.pending_ids = [], []
        if not source_path and not pending_v:
            if (
                st.index is not None and st.index.trained
                and not getattr(st.index, "read_only", False)
            ):
                # Re-snapshot the live index. Read the log BEFORE save: a
                # delete accepted mid-save may or may not land in the
                # snapshot, so only what save captured is consumed.
                tombs = self._read_tombstones(st.name)
                st.index.save(epoch_dir)
                self._consume_tombstones(st.name, tombs)
                job.progress = 1.0
                return
            raise ValueError(
                "no data: provide source_path or AddVectors first"
            )

        # Tombstones read up front: ids deleted since the last build do not
        # enter the new epoch (filtered per chunk); the log entries baked
        # here are consumed once the build succeeds.
        tombs = self._read_tombstones(st.name)
        index = self._new_index(cfg)
        chunk_rows = max(1, self.config.build_chunk_rows)
        n_pending = sum(len(v) for v in pending_v)
        n_source = ArrowStorage.num_rows(source_path) if source_path else 0
        n_total = n_source + n_pending
        job.progress = 0.05

        # Training sample: evenly spaced slices across the source file
        # (bounded RAM, robust to clustered file order) + the pending
        # buffers, which already sit in RAM.
        budget = train_sample_rows(index.config)
        parts = []
        if n_source:
            parts.append(ArrowStorage.read_train_sample(
                source_path, min(budget, n_source)
            ))
        parts.extend(
            np.ascontiguousarray(v, np.float32) for v in pending_v
        )
        sample = np.concatenate(parts)
        job.progress = 0.1

        # pq_capacity epochs stream their host-rerank rows to the epoch's
        # vectors file as chunks ingest (arrival order; the loader matches
        # rows to the arena by id): the corpus never sits in RAM.
        writer = None
        row_sink = None
        if cfg.get("tier") == "pq_capacity":
            os.makedirs(epoch_dir, exist_ok=True)
            writer = VectorFileWriter(os.path.join(epoch_dir, VECTORS_FILE))
            normalize = Metric.parse(cfg["metric"]) == Metric.COSINE

            def row_sink(ids_c, vecs_c):
                if normalize:
                    vecs_c = vecs_c / np.maximum(
                        np.linalg.norm(vecs_c, axis=1, keepdims=True),
                        1e-12,
                    )
                writer.append(ids_c, vecs_c)

        def chunks():
            if source_path:
                yield from ArrowStorage.iter_vector_chunks(
                    source_path, chunk_rows
                )
            for v, i in zip(pending_v, pending_i):
                yield (
                    np.asarray(i, np.uint64),
                    np.ascontiguousarray(v, np.float32),
                )

        try:
            build_index_chunked(
                index, chunks(), n_total,
                train_sample=sample, tombstones=tombs,
                progress=lambda f: setattr(
                    job, "progress", 0.1 + 0.75 * f
                ),
                row_sink=row_sink,
            )
        finally:
            if writer is not None:
                writer.close()
        job.progress = 0.85
        if self.config.auto_calibrate_nprobe:
            # Measured-coverage calibration on a sample of the training
            # rows, persisted in the epoch manifest; opt-in (one full-probe
            # sweep a build).
            try:
                rng = np.random.default_rng(0)
                pick = rng.choice(
                    len(sample), size=min(512, len(sample)), replace=False
                )
                index.calibrate_nprobe(queries=sample[pick])
            except Exception as e:  # noqa: BLE001 — tuning must not
                log.warning(                      # fail the build
                    "auto-calibration skipped for %s: %s", st.name, e
                )
        if cfg.get("tier") == "pq_capacity":
            # codes (device) + the rows the sink streamed to the epoch
            save_ivf_pq(epoch_dir, index, host_rows_file=True)
        else:
            index.save(epoch_dir)
        # Consume exactly the tombstones this build baked out: deletions
        # accepted during the build are not in the snapshot.
        self._consume_tombstones(st.name, tombs)
        job.progress = 1.0

    # ------------------------------------------------------------------ #
    # the batched search path
    # ------------------------------------------------------------------ #

    def submit_search(self, st: IndexState, queries: np.ndarray,
                      params: SearchParams,
                      priority: Priority = Priority.NORMAL):
        """Admission control and the coalescer submit of one decoded
        request: breaker, rate limiter (one token per request, not per
        query), concurrency limiter, then ``coalescer.submit``. Returns the
        future; the concurrency slot stays held until
        :meth:`finish_search`. Raises :class:`Rejected` when refused. Runs
        in the span ``engine.submit``."""
        with trace("engine.submit"):
            if not self.breaker.allow():
                raise Rejected("UNAVAILABLE", "circuit breaker open")
            if not self.rate_limiter.try_acquire(1):
                raise Rejected("RESOURCE_EXHAUSTED", "rate limit exceeded")
            if not self.limiter.try_enter():
                raise Rejected("RESOURCE_EXHAUSTED",
                               "too many concurrent requests")
            try:
                return st.coalescer.submit(
                    (queries, params, time.monotonic()), priority=priority,
                )
            except QueueFullError as e:
                self.limiter.exit()
                self.breaker.record(True)  # shedding is not an engine failure
                raise Rejected("RESOURCE_EXHAUSTED", str(e)) from None

    def finish_search(self, fut, index_name: str, t0: float,
                      n_queries: int, encode=None):
        """Await a submitted search and return ``encode(d, ids)`` (``(d,
        ids)`` without an encoder); always releases the concurrency slot
        taken by :meth:`submit_search` and records the breaker outcome and
        the request's latency. A search past the adaptive deadline raises
        :class:`Rejected` (``DEADLINE_EXCEEDED``); a queued one is
        cancelled before it reaches the device. What follows the answer
        (encode, slot, breaker, latency) runs in the span
        ``engine.finish``; the wait for the answer is no span."""
        try:
            d, ids = fut.result(timeout=self.adaptive.timeout_s())
        except concurrent.futures.TimeoutError:
            cancelled = fut.cancel()
            # a client deadline must not trip the breaker
            self._release(index_name, t0, n_queries, ok=True)
            raise Rejected(
                "DEADLINE_EXCEEDED",
                "queue wait exceeded adaptive deadline ("
                + ("cancelled while queued" if cancelled
                   else "batch already running") + ")",
            ) from None
        except BaseException:
            self._release(index_name, t0, n_queries, ok=False)
            raise
        with trace("engine.finish"):
            ok = False
            try:
                t_enc = time.monotonic()
                out = encode(d, ids) if encode is not None else (d, ids)
                self.metrics.record_stage(
                    "encode", (time.monotonic() - t_enc) * 1000
                )
                ok = True
                return out
            finally:
                self._release(index_name, t0, n_queries, ok)

    def _release(self, index_name: str, t0: float, n_queries: int,
                 ok: bool) -> None:
        """The end of an admitted search: its concurrency slot freed, the
        breaker's outcome and, where ``ok``, the request's latency."""
        self.limiter.exit()
        self.breaker.record(ok)
        if ok:
            self.metrics.record_search(
                index_name, (time.monotonic() - t0) * 1000, n_queries,
            )

    def _dispatch_batch(self, st: IndexState, items: list):
        """Dispatch stage of a drained coalescer batch: one ``search_async``
        per group of equal search parameters; returns the finalize thunk
        the coalescer forces one batch later (batch N's device work
        overlaps batch N−1's result fetch).

        items: [(queries [m, D] np, SearchParams, t_submit)] → thunk() →
        per-item (dists, ids) slices. Every index family's ``search_async``
        returns a ``models/search.PendingSearch`` (the streaming tier's
        runs its search here, synchronously), whose readings are recorded; a
        plain callable in its place (a wrapper that injects a fault)
        serves its answer and records none. Runs in the span
        ``engine.dispatch``."""
        with trace("engine.dispatch"):
            index = st.index
            t_start = time.monotonic()
            groups: dict[tuple, list[int]] = {}
            for i, (_, p, *_) in enumerate(items):
                groups.setdefault(
                    (p.nprobe, p.k, p.use_exact_rerank), []
                ).append(i)
            for it in items:
                if len(it) > 2:
                    self.metrics.record_stage(
                        "queue_wait", (t_start - it[2]) * 1000
                    )
            pendings: list[tuple[list[int], object]] = []
            for (nprobe, k, rerank), idxs in groups.items():
                qs = np.concatenate([items[i][0] for i in idxs])
                params = SearchParams(
                    nprobe=nprobe, k=k, use_exact_rerank=rerank
                )
                pendings.append((idxs, index.search_async(qs, params)))
            self.metrics.record_stage(
                "dispatch", (time.monotonic() - t_start) * 1000
            )

            def finalize() -> list:
                t_f = time.monotonic()
                results: list = [None] * len(items)
                for idxs, pending in pendings:
                    d, out_ids = pending()
                    # the search's own host and device times (``enqueue``,
                    # ``fetch_wait``; IVF-PQ's ``rerank``) and its counts
                    # (``rerank_rows``); none for the streaming tier
                    if isinstance(pending, PendingSearch):
                        for stage, v in {**pending.waits,
                                         **pending.counts}.items():
                            self.metrics.record_stage(stage, v)
                    off = 0
                    for i in idxs:
                        m = items[i][0].shape[0]
                        results[i] = (d[off:off + m], out_ids[off:off + m])
                        off += m
                now = time.monotonic()
                self.metrics.record_stage("fetch", (now - t_f) * 1000)
                # adaptive sizing sees the batch's dispatch→fetch wall time
                self.adaptive.record_latency_ms((now - t_start) * 1000)
                return results

            return finalize


# ---------------------------------------------------------------------- #
# gRPC servicers (grpc and protobuf are imported when one is built)
# ---------------------------------------------------------------------- #

def _wire_priority(request) -> Priority:
    """SearchRequest.priority wire values (0/unset=normal, 1=low, 2=normal,
    3=high, 4=urgent) → coalescer Priority."""
    mapping = {
        1: Priority.LOW, 2: Priority.NORMAL,
        3: Priority.HIGH, 4: Priority.URGENT,
    }
    return mapping.get(getattr(request, "priority", 0), Priority.NORMAL)


class _Servicer:
    def __init__(self, engine: VdbEngine):
        import grpc
        from google.protobuf import empty_pb2

        from cuda_acceleratedvectordatabaseengine_tpu_torch.server.proto \
            import vdb_pb2

        self.engine = engine
        self._grpc = grpc
        self._empty = empty_pb2.Empty
        self._pb = vdb_pb2

    def _abort(self, context, code: str, msg: str):
        context.abort(getattr(self._grpc.StatusCode, code), msg)


class QueryServiceImpl(_Servicer):
    """gRPC ``vdb.QueryService``."""

    def Search(self, request, context):
        # validation first: client errors (INVALID_ARGUMENT / NOT_FOUND)
        # never trip the breaker
        t_in = time.monotonic()
        st, queries, params = self._validate(request, context)
        self.engine.metrics.record_stage(
            "decode", (time.monotonic() - t_in) * 1000
        )
        t0 = time.monotonic()
        fut = self._admit_and_submit(st, queries, params, request, context)
        return self._finish(fut, request, context, t0, queries.shape[0])

    def StreamSearch(self, request_iterator, context):
        """Bidirectional streaming search: responses in request order; up
        to ``config.stream_window`` requests are pipelined into the
        coalescer at once. A validation or admission failure aborts the
        whole stream with the status the unary path returns."""
        eng = self.engine
        window = max(1, eng.config.stream_window)
        pending: collections.deque = collections.deque()
        try:
            for request in request_iterator:
                st, queries, params = self._validate(request, context)
                t0 = time.monotonic()
                fut = self._admit_and_submit(
                    st, queries, params, request, context
                )
                pending.append((fut, request, t0, queries.shape[0]))
                while len(pending) >= window:
                    fut, req, t0, nq = pending.popleft()
                    yield self._finish(fut, req, context, t0, nq)
            while pending:
                fut, req, t0, nq = pending.popleft()
                yield self._finish(fut, req, context, t0, nq)
        finally:
            # Aborted or cancelled with work in flight: release the
            # admission slots of unfinished items.
            while pending:
                fut, _req, _t0, _nq = pending.popleft()
                fut.cancel()
                eng.limiter.exit()
                eng.breaker.record(True)

    def _admit_and_submit(self, st, queries, params, request, context):
        try:
            return self.engine.submit_search(
                st, queries, params, _wire_priority(request)
            )
        except Rejected as e:
            self._abort(context, e.code, e.message)

    def _encode(self, request, d, ids):
        resp = self._pb.SearchResponse()
        if request.packed_response:
            # one memcpy instead of b·k message appends
            resp.packed_ids = np.ascontiguousarray(ids, dtype="<u8").tobytes()
            resp.packed_distances = np.ascontiguousarray(
                d, dtype="<f4"
            ).tobytes()
        else:
            for row_d, row_i in zip(d, ids):
                result = resp.results.add()
                for dist, nid in zip(row_d, row_i):
                    if nid == INVALID_ID:
                        continue
                    result.neighbors.add(id=int(nid), distance=float(dist))
        return resp

    def _finish(self, fut, request, context, t0, n_queries):
        try:
            return self.engine.finish_search(
                fut, request.index, t0, n_queries,
                encode=lambda d, ids: self._encode(request, d, ids),
            )
        except Rejected as e:
            self._abort(context, e.code, e.message)

    def _validate(self, request, context):
        eng = self.engine
        if not request.queries and not request.packed_queries:
            self._abort(context, "INVALID_ARGUMENT", "no queries provided")
        if request.topk <= 0 or request.topk > MAX_TOPK:
            self._abort(context, "INVALID_ARGUMENT",
                        f"topk must be in (0, {MAX_TOPK}]")
        if not request.index:
            self._abort(context, "INVALID_ARGUMENT", "index name required")
        try:
            st = eng.get_state(request.index)
        except KeyError:
            self._abort(context, "NOT_FOUND",
                        f"index {request.index!r} not found")
        if st.index is None or not st.index.trained:
            self._abort(context, "FAILED_PRECONDITION",
                        f"index {request.index!r} has no active epoch")
        index = st.index
        dim = index.config.dimension
        if request.metric:
            try:
                req_metric = Metric.parse(request.metric)
            except ValueError as e:
                self._abort(context, "INVALID_ARGUMENT", str(e))
            if req_metric != index.metric:
                self._abort(
                    context, "INVALID_ARGUMENT",
                    f"index metric is {index.metric.value}, "
                    f"request asked {request.metric}",
                )
        if request.packed_queries:
            raw = request.packed_queries
            if len(raw) % (4 * dim):
                self._abort(context, "INVALID_ARGUMENT",
                            f"packed_queries length {len(raw)} is not a "
                            f"multiple of 4*dim ({4 * dim})")
            queries = np.frombuffer(raw, dtype="<f4").reshape(-1, dim)
            queries = np.ascontiguousarray(queries, np.float32)
            if queries.shape[0] > MAX_QUERIES:
                self._abort(context, "INVALID_ARGUMENT",
                            f"at most {MAX_QUERIES} queries per request")
        else:
            if len(request.queries) > MAX_QUERIES:
                self._abort(context, "INVALID_ARGUMENT",
                            f"at most {MAX_QUERIES} queries per request")
            queries = np.zeros((len(request.queries), dim), np.float32)
            for i, v in enumerate(request.queries):
                if len(v.values) != dim:
                    self._abort(
                        context, "INVALID_ARGUMENT",
                        f"query {i} has dim {len(v.values)}, "
                        f"index dim {dim}",
                    )
                queries[i] = v.values
        nprobe = request.nprobe
        if not nprobe:
            # unset → the index's persisted calibration when present, else
            # the config default
            nprobe = (
                getattr(st.index, "calibrated_nprobe", None)
                or self.engine.config.default_nprobe
            )
        params = SearchParams(
            nprobe=nprobe, k=request.topk,
            use_exact_rerank=request.rerank_exact,
        )
        return st, queries, params

    def Warmup(self, request, context):
        try:
            st = self.engine.get_state(request.index)
        except KeyError:
            self._abort(context, "NOT_FOUND",
                        f"index {request.index!r} not found")
        if st.index is not None:
            st.index.warmup_lists(
                list(request.lists) if request.lists else None
            )
        return self._empty()

    def LoadIndex(self, request, context):
        eng = self.engine
        try:
            st = eng.get_state(request.index)
        except KeyError:
            self._abort(context, "NOT_FOUND",
                        f"index {request.index!r} not found")
        epoch = request.epoch or eng.epochs.active_epoch(request.index)
        if not epoch:
            self._abort(context, "NOT_FOUND", "no epoch to load")
        try:
            eng._load_epoch_into(st, epoch)
        except FileNotFoundError:
            self._abort(context, "NOT_FOUND",
                        f"epoch {epoch!r} has no snapshot")
        return self._empty()


class AdminServiceImpl(_Servicer):
    """gRPC ``vdb.AdminService``."""

    def CreateIndex(self, request, context):
        if not request.name:
            self._abort(context, "INVALID_ARGUMENT", "index name required")
        if request.dimension <= 0 or request.dimension > MAX_DIMENSION:
            self._abort(context, "INVALID_ARGUMENT",
                        f"dimension must be in (0, {MAX_DIMENSION}]")
        metric = request.metric or "L2"
        try:
            Metric.parse(metric)
        except ValueError as e:
            self._abort(context, "INVALID_ARGUMENT", str(e))
        tier = getattr(request, "tier", "") or "resident"
        if tier not in ("resident", "streaming", "pq_capacity"):
            self._abort(context, "INVALID_ARGUMENT",
                        f"unknown tier {tier!r} "
                        "(resident|streaming|pq_capacity)")
        if tier == "streaming" and request.m:
            self._abort(context, "INVALID_ARGUMENT",
                        "streaming tier supports IVF-Flat only (m must be 0)")
        if tier == "pq_capacity" and not request.m:
            self._abort(context, "INVALID_ARGUMENT",
                        "pq_capacity tier is IVF-PQ: m must be > 0")
        try:
            self.engine.create_index(
                request.name, request.dimension, metric,
                request.nlist, request.m, request.nbits, tier,
            )
        except KeyError as e:
            self._abort(context, "ALREADY_EXISTS", str(e))
        return self._empty()

    def AddVectors(self, request, context):
        if not request.vectors:
            self._abort(context, "INVALID_ARGUMENT", "no vectors provided")
        try:
            st = self.engine.get_state(request.index)
        except KeyError:
            self._abort(context, "NOT_FOUND",
                        f"index {request.index!r} not found")
        dim = st.config["dimension"]
        vecs = np.zeros((len(request.vectors), dim), np.float32)
        ids = np.zeros(len(request.vectors), np.uint64)
        for i, v in enumerate(request.vectors):
            if len(v.values) != dim:
                self._abort(context, "INVALID_ARGUMENT",
                            f"vector {i} has dim {len(v.values)}, "
                            f"index dim {dim}")
            vecs[i] = v.values
            ids[i] = v.id
        added, total = self.engine.add_vectors(request.index, vecs, ids)
        return self._pb.AddVectorsResponse(added=added, total=total)

    def RemoveVectors(self, request, context):
        if not request.ids:
            self._abort(context, "INVALID_ARGUMENT", "no ids provided")
        try:
            removed, total = self.engine.remove_vectors(
                request.index, np.asarray(request.ids, np.uint64)
            )
        except KeyError:
            self._abort(context, "NOT_FOUND",
                        f"index {request.index!r} not found")
        except (ValueError, PermissionError) as e:
            self._abort(context, "FAILED_PRECONDITION", str(e))
        return self._pb.RemoveVectorsResponse(removed=removed, total=total)

    def BuildEpoch(self, request, context):
        try:
            self.engine.get_state(request.index)
        except KeyError:
            self._abort(context, "NOT_FOUND",
                        f"index {request.index!r} not found")
        try:
            self.engine.build_epoch(request.index, request.source_path)
        except RuntimeError as e:
            self._abort(context, "ALREADY_EXISTS", str(e))
        except ValueError as e:
            self._abort(context, "FAILED_PRECONDITION", str(e))
        return self._empty()

    def ActivateEpoch(self, request, context):
        eng = self.engine
        try:
            st = eng.get_state(request.index)
        except KeyError:
            self._abort(context, "NOT_FOUND",
                        f"index {request.index!r} not found")
        epoch = request.epoch
        if not epoch:
            job = eng.build_jobs.get(request.index)
            if job is None:
                self._abort(context, "NOT_FOUND", "no epoch given")
            if not job.done:
                self._abort(context, "FAILED_PRECONDITION",
                            f"build in progress ({job.progress:.0%})")
            if job.error:
                self._abort(context, "INTERNAL",
                            f"build failed: {job.error}")
            epoch = job.epoch_id
        try:
            eng.activate_epoch(st.name, epoch)
        except (KeyError, FileNotFoundError) as e:
            self._abort(context, "NOT_FOUND", str(e))
        return self._empty()

    def GetStats(self, request, context):
        eng = self.engine
        try:
            st = eng.get_state(request.index)
        except KeyError:
            self._abort(context, "NOT_FOUND",
                        f"index {request.index!r} not found")
        if getattr(request, "reset", False):
            # clear this index's percentile windows (and the stage spans)
            # before answering: the caller is delimiting a measurement
            eng.metrics.reset_windows(request.index)
        total = indexed = 0
        mem_gb = 0.0
        if st.index is not None:
            stats = st.index.memory_stats()
            total = indexed = stats["total_vectors"]
            mem_gb = stats["total_bytes"] / (1 << 30)
        pending = sum(len(v) for v in st.pending_vectors)
        pct = eng.metrics.get_percentiles(request.index)
        return self._pb.StatsResponse(
            total_vectors=total + pending,
            indexed_vectors=indexed,
            current_epoch=st.epoch,
            gpu_memory_used=mem_gb,
            nvme_usage=0.0,
            latency_p50_ms=pct["p50"],
            latency_p95_ms=pct["p95"],
            latency_p99_ms=pct["p99"],
        )
