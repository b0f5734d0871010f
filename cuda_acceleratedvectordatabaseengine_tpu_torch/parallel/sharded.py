"""Slot-striped sharded IVF search and data-parallel k-means over a device
mesh (PyTorch port of ``cuda_acceleratedvectordatabaseengine_tpu/parallel/
sharded.py``).

Design, as in the JAX package: the arena's **slot axis** is striped
round-robin over the mesh, so shard ``s`` holds local slot ``j`` = logical
slot ``j·N + s`` of *every* inverted list. Each shard scans exactly 1/N of
every probed list with the same hand-written kernels as one device (K1, K3,
K4 for IVF-Flat, K2 for IVF-PQ), passed ``slot_stride=N``,
``slot_offset=s`` and the logical ``global_capacity``, so positions come
back in logical space and the merge is a concatenation of the shards'
``[B, k]`` candidates plus one top-k.

Where the JAX package runs one ``shard_map`` program, the port runs one
process (``parallel/mesh.py``): the coarse probe on the leader device, each
shard's scan launched on its own device (profiler range ``sharded.scan``),
then the merge on the leader (``sharded.merge``). Shard ``s`` holds its
stripe as its own contiguous tensors on ``mesh.devices[s]``.

The k-means trainer is data-parallel: each shard reduces its partial
``onehot.T @ x`` sums, counts and distortion over its rows, the partials
are summed on the leader (the JAX ``psum``), and the reseeding runs once on
the leader over the gathered candidate pools.

Torch tensors are mutable where JAX arrays are not. A one-shard view
publishes the base arena itself (no copy: a copy would double a
card-filling arena), and the base arena's removal moves rows in place; so
a view with a base enqueues its scans under the base's ``_mutate_lock``,
and its own ``remove_ids`` holds the view's publish lock from the removal
through the re-publish, so no search pairs moved rows with the previous
id table.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
    _append_device,
    compute_append_slots,
    torch_dtype,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat import (
    IVFFlatIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq import (
    grouped_adc,
    rerank_depth,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.search import (
    PendingSearch,
    SearchParams,
    SearchSpans,
    flat_rerank_depth,
    resolve_nprobe,
    warm_up,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
    Metric,
    pairwise_distance,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.flat_scan import (
    check_scan_name,
    scan_flat,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.kmeans import (
    _lloyd_chunk,
    _reseed_step,
    kmeans_assign,
    kmeans_pp_init,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.normalize import (
    l2_normalize,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.pq import _mm
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
    topk_smallest,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    psum,
    replicate,
    stripe_slots,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.profiling import (
    trace,
)


def _prep_queries(queries, device: torch.device, dim: int) -> torch.Tensor:
    """The query batch as fp32 ``[B, D]`` on ``device``. A tensor stays
    where it is when it already lives there (no host round trip); the JAX
    package's bucket padding is not ported."""
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=device, dtype=torch.float32)
    else:
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            device)
    if q.dim() == 1:
        q = q[None]
    if q.shape[1] != dim:
        raise ValueError(f"query dim {q.shape[1]} != index dim {dim}")
    return q


def _striping_perm(capacity: int, n_shards: int) -> np.ndarray:
    """Physical slot → logical slot permutation for round-robin striping.

    Physical slot p lives on shard ``s = p // (cap/N)`` at local offset
    ``j = p % (cap/N)`` and holds logical slot ``j*N + s``."""
    local = capacity // n_shards
    p = np.arange(capacity)
    s, j = p // local, p % local
    return (j * n_shards + s).astype(np.int32)


def _stripe_scan_capacity(counts_max, global_cap: int,
                          n_shards: int) -> int | None:
    """Per-stripe occupied-prefix bound for the slot-striped kernels: a
    logical occupancy of ``counts_max`` slots fills at most
    ``ceil(counts_max / N)`` local slots on any shard. Rounded to the 128
    tile; None when it would not shrink the local scan."""
    if not counts_max:
        return None
    local_cap = global_cap // n_shards
    occ = -(-int(counts_max) // n_shards)
    occ = -(-max(occ, 1) // 128) * 128
    return occ if occ < local_cap else None


def _merge(mesh: Mesh, parts, k: int):
    """The JAX package's ``all_gather`` + replicated top-k: the shards'
    ``[B, ≥k]`` candidates (logical positions) concatenated on the leader
    and cut to the global top-k."""
    with trace("sharded.merge"):
        d_all = all_gather(mesh, [d for d, _ in parts])
        p_all = all_gather(mesh, [p for _, p in parts])
        return topk_smallest(d_all, k, idx=p_all)


def _merge_reranked(mesh: Mesh, parts, keep: int, k: int):
    """The merge of reranked shards (``parts`` of ``(scan distances,
    logical positions, exact distances)``, each ``[B, keep]``): the
    global top ``keep`` by scan distance, the single device's shortlist,
    then its top ``k`` by exact distance, as ``_exact_rerank`` cuts it."""
    with trace("sharded.merge"):
        d_all = all_gather(mesh, [d for d, _, _ in parts])
        p_all = all_gather(mesh, [p for _, p, _ in parts])
        e_all = all_gather(mesh, [e for _, _, e in parts])
        _, col = topk_smallest(d_all, keep)
        return topk_smallest(e_all.gather(1, col), k,
                             idx=p_all.gather(1, col))


def _storage_key(t: torch.Tensor):
    return t.device, t.untyped_storage().data_ptr()


def _sharded_search(mesh, q, centroids, arena_s, arena_sq_s, counts_s,
                    scale_s, anchors_s, nprobe, k, metric, global_cap,
                    scan_impl="auto", m_budget=None, scan_capacity=None,
                    lo_s=None, rerank_k=0):
    """Coarse probe on the leader, one striped scan per shard, merge:
    ``(dists [B, k], logical positions [B, k])`` on the leader. With
    ``rerank_k`` and the lo plane's stripes ``lo_s``, each shard keeps its
    top ``max(k, rerank_k)``, recomputes their distances in fp32 from its
    ``stored + lo`` rows, and the merge cuts the global shortlist by scan
    distance before it takes the top k by exact distance
    (:func:`_merge_reranked`): the single-device rerank's answer."""
    n = mesh.size
    rerank = rerank_k > 0 and lo_s is not None
    keep = max(k, rerank_k) if rerank else k
    with trace("sharded.coarse_probe"):
        qf = q.float()
        if metric == Metric.COSINE:
            qf = l2_normalize(qf)
        coarse = pairwise_distance(qf, centroids, metric)
        _, probe = topk_smallest(coarse, nprobe)
        probe = probe.int()
    parts = []
    for s, dev in enumerate(mesh.devices):
        with trace("sharded.scan"):
            q_s = qf.to(dev)
            scale = None if scale_s is None else scale_s[s]
            anchors = None if anchors_s is None else anchors_s[s]
            d, pos = scan_flat(
                scan_impl, q_s, arena_s[s], arena_sq_s[s],
                counts_s[s], probe.to(dev), keep, metric,
                arena_scale=scale, arena_anchors=anchors,
                m_budget=m_budget, scan_capacity=scan_capacity,
                slot_stride=n, slot_offset=s, global_capacity=global_cap,
            )
            part = (d[:, :keep], pos[:, :keep])
            if rerank:
                part += (_shard_rerank(q_s, part[1], arena_s[s], scale,
                                       anchors, s, n, global_cap, metric,
                                       lo_l=lo_s[s]),)
        parts.append(part)
    if rerank:
        return _merge_reranked(mesh, parts, keep, k)
    return _merge(mesh, parts, k)


def _pack_stripe(mesh, arena_s, sq_s, scale_s, anchors_s, x, lists, slots,
                 lo_s=None):
    """Write one chunk into the slot-striped arenas: each shard takes the
    rows whose logical slot lands on its stripe (``slot % N == s``) at
    local slot ``slot // N``, quantized by the single-device append path
    (``models/arena._append_device``: per-row scale ``max|x − anchor| /
    127``, codes ``round(res / scale)`` half to even; with ``lo_s`` the
    bf16 residual ``x − stored(x)`` into the lo plane's stripes)."""
    n = mesh.size
    for s, dev in enumerate(mesh.devices):
        mine = np.flatnonzero(slots % n == s)
        if mine.size == 0:
            continue
        rows = torch.from_numpy(mine).to(x.device)
        _append_device(
            arena_s[s], sq_s[s], None if scale_s is None else scale_s[s],
            None if anchors_s is None else anchors_s[s],
            torch.from_numpy(lists[mine]).to(dev),
            torch.from_numpy(slots[mine] // n).to(dev),
            x[rows].to(dev),
            arena_lo=None if lo_s is None else lo_s[s],
        )


class _ShardedServingSurface:
    """The server-facing index protocol over a sharded view.

    ``server.service.VdbEngine`` drives every live index through one
    duck-typed surface (``trained`` / ``ntotal`` / ``add`` /
    ``remove_ids`` / ``save`` / ``warmup_lists`` / ``memory_stats`` /
    ``calibrated_nprobe``), so a sharded index swaps in at epoch
    activation. Mutations delegate to the single-device base index, then
    ``refresh()`` re-publishes the stripes. A view built by
    ``build_on_mesh`` has no base and is read-only: its mutation path is
    the epoch rebuild.

    ``refresh`` stages every new tensor first and swaps the attributes
    under ``_publish_lock``, and a search snapshots them under the same
    lock, so a search never mixes two publications (see the module
    docstring for what the lock also covers)."""

    base = None
    SPANS = SearchSpans.of("sharded")   # the finalize's ranges

    def _setup(self, base, config, mesh: Mesh) -> None:
        self.base = base
        self.config = config
        self.mesh = mesh
        self.n_shards = mesh.size
        self.metric = config.metric
        self._publish_lock = threading.RLock()
        self._published = False

    def _require_base(self, op: str) -> None:
        if self.base is None:
            raise PermissionError(
                f"{op}: mesh-built sharded index has no base to mutate; "
                "rebuild an epoch instead (read-only serving view)"
            )

    @property
    def trained(self) -> bool:
        return bool(getattr(self, "_published", False))

    @property
    def read_only(self) -> bool:
        return self.base is None or getattr(self.base, "read_only", False)

    @property
    def ntotal(self) -> int:
        if self.base is not None:
            return self.base.ntotal
        return int(self.counts[0].sum().item())

    @property
    def calibrated_nprobe(self):
        return getattr(self.base, "calibrated_nprobe", None)

    @calibrated_nprobe.setter
    def calibrated_nprobe(self, value):
        self._require_base("calibrated_nprobe")
        self.base.calibrated_nprobe = value

    def add(self, vectors, ids=None) -> None:
        self._require_base("add")
        self.base.add(vectors, ids)
        self.refresh()

    def remove_ids(self, ids) -> int:
        self._require_base("remove_ids")
        # held from the removal through the re-publish: a one-shard view
        # aliases the base arena, whose removal moves rows in place
        with self._publish_lock:
            n = self.base.remove_ids(ids)
            if n:
                self.refresh()
        return n

    def save(self, path: str) -> None:
        self._require_base("save")
        self.base.save(path)

    def _base_lock(self):
        """The base index's mutation lock (a no-op context without a
        base): searches enqueue their scans under it."""
        if self.base is None:
            return contextlib.nullcontext()
        return self.base._mutate_lock

    def search(
        self, queries, params: SearchParams | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        return self.search_async(queries, params)()

    def search_async(self, queries,
                     params: SearchParams | None = None) -> PendingSearch:
        """Snapshot one publication, enqueue the sharded search under the
        publish lock and the base's (:meth:`_base_lock`), and return its
        :class:`PendingSearch` (spans ``sharded.finalize`` ⊃
        ``.fetch_wait``, ``.copy``, ``.id_map``; ``waits`` as a resident
        index's)."""
        t_enqueue = time.perf_counter()
        pending = self._enqueue(
            queries, params, lambda *out: PendingSearch(self.SPANS, *out))
        pending.waits["enqueue"] = (time.perf_counter() - t_enqueue) * 1e3
        return pending

    def _enqueue(self, queries, params, finish):
        """``finish(d_dev, pos_dev, ids_table)`` of the sharded search of
        ``queries``, dispatched (and ``finish`` run) under the locks."""
        params = params or SearchParams()
        nprobe = resolve_nprobe(params, self.calibrated_nprobe,
                                self.config.nlist)
        q = _prep_queries(queries, self.mesh.leader, self.config.dimension)
        with self._publish_lock, self._base_lock():
            return finish(*self._dispatch(q, params, nprobe))

    def _dispatch(self, q, params: SearchParams, nprobe: int):
        """Enqueue the sharded search of the leader's queries ``q`` over
        the current publication (its locks held); returns ``(d_dev,
        pos_dev, ids_table)``."""
        raise NotImplementedError

    def _warmup_params(self):
        return (SearchParams(),)

    def warmup_lists(self, list_ids=None, batch_sizes=(1, 8, 64),
                     nprobes=None) -> None:
        """Run one search per batch size × nprobe (× rerank variant on
        PQ; ``models/search.warm_up``), so first-use costs (the kernel
        build, allocator growth) are paid before serving. ``list_ids`` is
        accepted for signature parity: the stripes are device-resident,
        there is no per-list residency."""
        if self.trained:
            warm_up(self, batch_sizes, nprobes, self._warmup_params())

    def _device_arrays(self) -> dict:
        raise NotImplementedError

    def _base_tensors(self) -> tuple:
        """The base's device tensors that a publication may alias."""
        raise NotImplementedError

    def memory_stats(self) -> dict:
        """Mesh-wide device accounting. ``total_bytes`` sums the published
        stripes and replicated smalls over all shards, plus the retained
        base (held for mutation and persistence) when present. A storage is
        counted once however many shards share it, and not at all where it
        is the base's own: a one-shard view publishes the base arena with
        no copy, and a replica on the base's device is the base's tensor."""
        seen = set()
        if self.base is not None:
            seen = {_storage_key(t) for t in self._base_tensors()
                    if t is not None}
        striped = 0
        for ts in self._device_arrays().values():
            for t in (ts if isinstance(ts, list) else [ts]):
                if t is None or _storage_key(t) in seen:
                    continue
                seen.add(_storage_key(t))
                striped += int(t.numel() * t.element_size())
        base_bytes = (
            self.base.memory_stats()["total_bytes"]
            if self.base is not None else 0
        )
        return {
            "striped_bytes": striped,
            "base_bytes": base_bytes,
            "total_bytes": striped + base_bytes,
            "total_vectors": self.ntotal,
            "nlist": self.config.nlist,
            "n_shards": self.n_shards,
            "capacity_per_list": self.global_cap,
        }


class ShardedIVFFlatIndex(_ShardedServingSurface):
    """Sharded serving view over a trained :class:`IVFFlatIndex`.

    Build and ingest happen on the base index; ``refresh()`` (re)publishes
    its arena as slot stripes on the mesh. :meth:`build_on_mesh` instead
    trains AND packs on the mesh with no single-device base at all.

    With a lo plane (``store_residuals``) the view stripes it with the
    arena, and ``SearchParams.use_exact_rerank`` reranks as the
    single-device index does: each shard recomputes its top ``min(max(4k,
    k), 256)`` candidates in fp32 from ``stored + lo``, and the merge cuts
    the global shortlist by scan distance before it takes the top k by
    exact distance, so the answer is the single device's (the JAX
    package's view never stripes the lo plane and ignores the request). A
    view whose arena keeps no lo plane answers without rerank, as the
    single-device index does.
    """

    def __init__(self, base: IVFFlatIndex, mesh: Mesh,
                 scan_impl: str = "auto"):
        if not base.trained:
            raise RuntimeError("base index must be trained")
        self._setup(base, base.config, mesh)
        self._set_scan_impl(scan_impl)
        self.refresh()

    def _set_scan_impl(self, scan_impl: str) -> None:
        # resolved per shard and per search by ops/flat_scan (the device,
        # the depth k and a scaled arena choose the kernel)
        check_scan_name(scan_impl)
        self.scan_impl = scan_impl

    @classmethod
    def _from_stripes(cls, mesh: Mesh, config, scan_impl: str,
                      *published) -> "ShardedIVFFlatIndex":
        """A view with no base (read-only) publishing the given stripes:
        the arguments of :meth:`_publish`."""
        self = cls.__new__(cls)
        self._setup(None, config, mesh)
        self._set_scan_impl(scan_impl)
        self._publish(*published)
        return self

    @classmethod
    def build_on_mesh(
        cls,
        mesh: Mesh,
        config,
        x,
        ids: np.ndarray | None = None,
        generator: torch.Generator | None = None,
        centroids=None,
        chunk_rows: int = 250_000,
        scan_impl: str = "auto",
        train_iters: int | None = None,
    ) -> "ShardedIVFFlatIndex":
        """Train AND build on the mesh, with no single-device base index.
        Training is the data-parallel k-means (:func:`sharded_kmeans_fit`,
        seeded from ``generator`` on the leader, default
        ``config.seed``); packing writes each chunk onto the slot-striped
        arenas (:func:`_pack_stripe`). ``x`` is ``[n, D]``, numpy or a
        tensor on any device.

        The training sample is padded to a multiple of N with up to N − 1
        zero rows of weight 0: they take no part in Lloyd, and a real zero
        vector of the sample joins its cluster (the JAX package trains on
        the padding and drops every all-zero row). A config with
        ``store_residuals`` (int8 / bf16) also fills the lo plane's
        stripes. Kept for parity with the JAX package: each stripe is sized
        ``ceil((ceil(max_count / N) + 1) / 8) · 8`` slots, whose last slot
        was the JAX pack's TRASH slot (nothing is written there; it keeps
        ``global_cap``, and so every position, equal)."""
        check_scan_name(scan_impl)
        n_shards = mesh.size
        metric = config.metric
        leader = mesh.leader

        n, dim = x.shape
        if ids is None:
            ids = np.arange(n, dtype=np.uint64)

        def rows(i0, i1):
            xc = x[i0:i1]
            if not isinstance(xc, torch.Tensor):
                xc = torch.from_numpy(np.ascontiguousarray(xc, np.float32))
            xc = xc.to(device=leader, dtype=torch.float32)
            return l2_normalize(xc) if metric == Metric.COSINE else xc

        # ---- train (data-parallel over the mesh) --------------------- #
        if centroids is None:
            if generator is None:
                generator = torch.Generator(device=leader).manual_seed(
                    config.seed)
            cap_train = config.train_sample_per_list * config.nlist
            if n > cap_train:
                stride = n // cap_train
                sample = x[::stride][:cap_train]
            else:
                sample = x
            if not isinstance(sample, torch.Tensor):
                sample = torch.from_numpy(
                    np.ascontiguousarray(sample, np.float32))
            sample = sample.to(device=leader, dtype=torch.float32)
            if metric == Metric.COSINE:
                sample = l2_normalize(sample)
            pad = (-sample.shape[0]) % n_shards
            weight = torch.ones(sample.shape[0] + pad, device=leader)
            if pad:
                sample = torch.cat([sample, sample.new_zeros((pad, dim))])
                weight[-pad:] = 0.0
            centroids = sharded_kmeans_fit(
                mesh, generator, sample, config.nlist,
                iters=train_iters or config.train_iters, weight=weight,
            )
        if not isinstance(centroids, torch.Tensor):
            centroids = torch.from_numpy(np.array(centroids, np.float32))
        centroids = centroids.to(device=leader, dtype=torch.float32)

        # ---- assign (chunked) ------------------------------------------ #
        assign_metric = (
            Metric.INNER_PRODUCT if metric == Metric.INNER_PRODUCT
            else Metric.L2
        )
        assignments = np.concatenate([
            kmeans_assign(rows(i0, i0 + chunk_rows), centroids,
                          assign_metric).cpu().numpy()
            for i0 in range(0, n, chunk_rows)
        ]).astype(np.int64)
        nlist = config.nlist
        counts_h = np.bincount(assignments, minlength=nlist).astype(np.int64)
        # local capacity: the stripe share of the fullest list + 1 (the
        # JAX pack's TRASH slot), 8-aligned
        cap_l = -(-(-(-int(counts_h.max()) // n_shards) + 1) // 8) * 8
        cap_l = max(cap_l, 8)
        global_cap = cap_l * n_shards

        # ---- pack (chunked writes onto the striped arenas) ------------- #
        dtype = torch_dtype(config.dtype)
        quantize = dtype == torch.int8
        arena_s = [torch.zeros((nlist, cap_l, dim), dtype=dtype, device=d)
                   for d in mesh.devices]
        sq_s = [torch.zeros((nlist, cap_l), device=d) for d in mesh.devices]
        scale_s = ([torch.zeros((nlist, cap_l), device=d)
                    for d in mesh.devices] if quantize else None)
        # int8 always encodes residuals to the centroids here, as the JAX
        # package's mesh build does
        anchors_s = replicate(mesh, centroids) if quantize else None
        lo_s = ([torch.zeros((nlist, cap_l, dim), dtype=torch.bfloat16,
                             device=d) for d in mesh.devices]
                if config.store_residuals and dtype != torch.float32
                else None)
        running = np.zeros(nlist, np.int64)
        ids_table = np.full((nlist, global_cap), INVALID_ID, np.uint64)
        for i0 in range(0, n, chunk_rows):
            i1 = min(i0 + chunk_rows, n)
            a_c = assignments[i0:i1]
            slots = compute_append_slots(running, a_c)
            running += np.bincount(a_c, minlength=nlist)
            _pack_stripe(mesh, arena_s, sq_s, scale_s, anchors_s,
                         rows(i0, i1), a_c, slots, lo_s)
            ids_table[a_c, slots] = np.asarray(ids[i0:i1]).astype(np.uint64)
        return cls._from_stripes(
            mesh, config, scan_impl, arena_s, sq_s, scale_s, anchors_s,
            torch.from_numpy(counts_h.astype(np.int32)), centroids,
            ids_table, global_cap,
            int(counts_h.max()) if counts_h.size else 0, lo_s)

    def _publish(self, arena_s, sq_s, scale_s, anchors_s, counts,
                 centroids, ids_table, global_cap, counts_max,
                 lo_s=None) -> None:
        counts_s = replicate(self.mesh, counts)
        centroids = centroids.to(self.mesh.leader)
        with self._publish_lock:
            self.arena_s = arena_s
            self.arena_sq_s = sq_s
            self.arena_lo_s = lo_s
            self.arena_scale = scale_s
            self.arena_anchors = anchors_s
            self.has_scale = scale_s is not None
            self.has_anchor = anchors_s is not None
            self.counts = counts_s
            self._counts_max = counts_max
            self.centroids = centroids
            self._ids_table = ids_table
            self.global_cap = global_cap
            self._published = True

    def refresh(self) -> None:
        """Re-stripe the base arena (and its lo plane) over the mesh. The
        copies are enqueued under the base's mutation lock (one consistent
        arena state); a one-shard mesh on the base's device publishes the
        base tensors themselves (zero copy) with a copy of the small counts
        and ids."""
        base = self.base
        n = self.n_shards
        # stage under the base's lock, publish after it (a search takes
        # the publish lock first, then the base's)
        with base._mutate_lock:
            arena = base.arena
            cap = arena.capacity
            if cap % n:
                base.arena = arena = arena.grow(cap + n - cap % n)
                cap = arena.capacity
            staged = (
                stripe_slots(self.mesh, arena.arena, 1),
                stripe_slots(self.mesh, arena.arena_sq, 1),
                (stripe_slots(self.mesh, arena.arena_scale, 1)
                 if arena.arena_scale is not None else None),
                (replicate(self.mesh, arena.anchors)
                 if arena.anchors is not None else None),
                arena.counts.clone(), base.centroids, arena.ids.copy(), cap,
                arena.counts_max,
                (stripe_slots(self.mesh, arena.arena_lo, 1)
                 if arena.arena_lo is not None else None),
            )
        self._publish(*staged)

    def search_device(self, queries, params: SearchParams | None = None):
        """Dispatch the sharded search and return the device result tensors
        ``(distances, logical positions)`` on the leader: no host copy, no
        id mapping (the device-throughput hook)."""
        return self._enqueue(queries, params, lambda d, pos, _ids: (d, pos))

    def _dispatch(self, q, params, nprobe):
        d_dev, pos_dev = _sharded_search(
            self.mesh, q, self.centroids, self.arena_s, self.arena_sq_s,
            self.counts, self.arena_scale, self.arena_anchors, nprobe,
            params.k, self.metric, self.global_cap, self.scan_impl,
            self.config.m_budget,
            _stripe_scan_capacity(self._counts_max, self.global_cap,
                                  self.n_shards),
            self.arena_lo_s,
            flat_rerank_depth(params, self.arena_lo_s is not None, params.k),
        )
        return d_dev, pos_dev, self._ids_table

    def _base_tensors(self) -> tuple:
        arena = self.base.arena
        return (self.base.centroids, arena.arena, arena.arena_sq,
                arena.arena_scale, arena.anchors, arena.arena_lo)

    def _device_arrays(self) -> dict:
        return {
            "arena": self.arena_s,
            "arena_sq": self.arena_sq_s,
            "arena_lo": self.arena_lo_s,
            "scale": self.arena_scale,
            "centroids": self.centroids,
            "anchors": self.arena_anchors,
        }


def _shard_rerank(q0, pos, raw_l, raw_scale_l, raw_anchors_l, s, n,
                  global_cap, metric, lo_l=None):
    """Exact fp32 distances of one shard's candidates: logical positions
    map back to the shard's local rows (every candidate's slot is ≡ s mod
    N), rebuilt from the raw stripe (scale, anchor; IVF-Flat adds the lo
    plane's stripe ``lo_l``, as ``models/ivf_flat._exact_rerank`` adds the
    lo plane) in the original frame."""
    nlist, cap_l, dim = raw_l.shape
    safe = pos.clamp_min(0).long()
    lists = safe // global_cap
    slot_l = (safe % global_cap - s) // n
    flat = lists * cap_l + slot_l.clamp(0, cap_l - 1)
    cand = raw_l.reshape(nlist * cap_l, dim)[flat].float()
    if raw_scale_l is not None:
        cand = cand * raw_scale_l.reshape(-1)[flat][:, :, None]
    if raw_anchors_l is not None:
        cand = cand + raw_anchors_l[lists]
    if lo_l is not None:
        cand = cand + lo_l.reshape(nlist * cap_l, dim)[flat].float()
    dots = torch.bmm(cand, q0[:, :, None])[:, :, 0]
    if metric == Metric.INNER_PRODUCT:
        exact = -dots
    elif metric == Metric.COSINE:
        c_sq = (cand * cand).sum(-1)
        exact = 1.0 - dots * torch.rsqrt(c_sq.clamp_min(1e-12))
    else:
        q_sq = (q0 * q0).sum(-1)
        c_sq = (cand * cand).sum(-1)
        exact = (q_sq[:, None] - 2.0 * dots + c_sq).clamp_min(0.0)
    return torch.where(pos >= 0, exact, float("inf"))


def _sharded_pq_search(mesh, q0, opq_R, centroids_s, codebooks_s, codes_s,
                       code_sq_s, counts_s, raw_s, raw_scale_s, raw_anchors_s,
                       nprobe, k, metric, global_cap, rerank_k,
                       scan_capacity=None):
    """Sharded IVF-PQ search: per-shard grouped ADC (K2) over the striped
    code arena, an optional per-shard exact rerank against the striped raw
    rows, and the merge. Each shard reranks its own top-``rerank_k``, so
    the merged pool is the union of the shards' reranks: a superset of the
    single-device pool (recall ≥ the single device's)."""
    n = mesh.size
    with trace("sharded.coarse_probe"):
        q0 = q0.float()                       # the original frame (rerank's)
        if metric == Metric.COSINE:
            q0 = l2_normalize(q0)
        q = _mm(q0, opq_R) if opq_R is not None else q0
        coarse_metric = (Metric.INNER_PRODUCT
                         if metric == Metric.INNER_PRODUCT else Metric.L2)
        coarse = pairwise_distance(q, centroids_s[0], coarse_metric)
        _, probe = topk_smallest(coarse, nprobe)
        probe = probe.int()
    keep = max(k, rerank_k)
    parts = []
    for s, dev in enumerate(mesh.devices):
        with trace("sharded.scan"):
            d, pos = grouped_adc(
                q.to(dev), codes_s[s], code_sq_s[s], counts_s[s],
                centroids_s[s], codebooks_s[s], probe.to(dev), keep, metric,
                scan_capacity=scan_capacity, slot_stride=n, slot_offset=s,
                global_capacity=global_cap,
            )
            if rerank_k > 0 and raw_s is not None:
                d = _shard_rerank(
                    q0.to(dev), pos, raw_s[s],
                    None if raw_scale_s is None else raw_scale_s[s],
                    None if raw_anchors_s is None else raw_anchors_s[s],
                    s, n, global_cap, metric)
        parts.append((d, pos))
    out_d, out_p = _merge(mesh, parts, k)
    if metric == Metric.COSINE and rerank_k == 0:
        # ADC ran in L2 over unit vectors: ‖q − x‖² = 2(1 − cos) → halve
        out_d = torch.where(torch.isfinite(out_d), out_d * 0.5, out_d)
    return out_d, out_p


class ShardedIVFPQIndex(_ShardedServingSurface):
    """Sharded serving view over a trained :class:`IVFPQIndex`: the code
    arena's slot axis is striped over the mesh (each shard ADC-scans 1/N
    of every probed list with K2); codebooks, centroids and counts are
    replicated; with ``keep_raw`` the raw arena stripes the same way for a
    per-shard exact rerank (``SearchParams.use_exact_rerank``)."""

    def __init__(self, base, mesh: Mesh, scan_impl: str = "auto"):
        # ``scan_impl`` is accepted for signature parity only: the one
        # scan is the grouped ADC kernel (its plain version on CPU shards)
        if not base.trained:
            raise RuntimeError("base index must be trained")
        self._setup(base, base.config, mesh)
        self.refresh()

    def refresh(self) -> None:
        """(Re)stripe the base arenas over the mesh, under the base's
        mutation lock."""
        base = self.base
        mesh = self.mesh
        n = self.n_shards
        with base._mutate_lock:
            cap = base.capacity
            if cap % n:
                base._grow(cap + (n - cap % n))
                cap = base.capacity
            codes_s = stripe_slots(mesh, base.code_arena_t, 2)
            code_sq_s = stripe_slots(mesh, base.code_sq, 1)
            counts = base.counts.clone()
            counts_max = int(counts.max().item()) if counts.shape[0] else 0
            raw = base.raw
            if raw is not None:
                if raw.capacity < cap:
                    base.raw = raw = raw.grow(cap)
                raw_s = stripe_slots(mesh, raw.arena, 1)
                raw_scale_s = (stripe_slots(mesh, raw.arena_scale, 1)
                               if raw.arena_scale is not None else None)
                raw_anchors_s = (replicate(mesh, raw.anchors)
                                 if raw.anchors is not None else None)
            else:
                raw_s = raw_scale_s = raw_anchors_s = None
            staged = dict(
                codes_t_s=codes_s, code_sq_s=code_sq_s,
                counts=replicate(mesh, counts), _counts_max=counts_max,
                centroids=replicate(mesh, base.centroids),
                codebooks=replicate(mesh, base.codebooks),
                opq_R=(None if base.opq_R is None
                       else base.opq_R.to(mesh.leader)),
                has_raw=raw_s is not None, raw_s=raw_s,
                raw_scale_s=raw_scale_s, raw_anchors_s=raw_anchors_s,
                _ids_table=base.ids.copy(), global_cap=cap,
            )
        with self._publish_lock:
            for name, value in staged.items():
                setattr(self, name, value)
            self._published = True

    def _dispatch(self, q0, params, nprobe):
        scan_cap = _stripe_scan_capacity(
            self._counts_max, self.global_cap, self.n_shards)
        rerank_k = 0
        if params.use_exact_rerank and self.has_raw:
            # each shard reranks its own shortlist from its stripe
            rerank_k = rerank_depth(
                self.config.rerank_k, params.k,
                nprobe * (scan_cap or self.global_cap // self.n_shards))
        d_dev, pos_dev = _sharded_pq_search(
            self.mesh, q0, self.opq_R, self.centroids, self.codebooks,
            self.codes_t_s, self.code_sq_s, self.counts, self.raw_s,
            self.raw_scale_s, self.raw_anchors_s, nprobe, params.k,
            self.metric, self.global_cap, rerank_k, scan_cap,
        )
        return d_dev, pos_dev, self._ids_table

    def _warmup_params(self):
        if self.has_raw:
            return (SearchParams(), SearchParams(use_exact_rerank=True))
        return (SearchParams(),)

    def _base_tensors(self) -> tuple:
        base, raw = self.base, self.base.raw
        out = (base.code_arena_t, base.code_sq, base.centroids,
               base.codebooks, base.opq_R)
        if raw is None:
            return out
        return out + (raw.arena, raw.arena_scale, raw.anchors)

    def _device_arrays(self) -> dict:
        return {
            "codes": self.codes_t_s,
            "code_sq": self.code_sq_s,
            "raw": self.raw_s,
            "raw_scale": self.raw_scale_s,
            "centroids": self.centroids,
            "codebooks": self.codebooks,
        }


def _row_shards(mesh: Mesh, x) -> list[torch.Tensor]:
    """Rows sharded over the mesh, the JAX ``P(SHARD_AXIS, None)``: a list
    of one tensor per shard, or one ``[N, D]`` tensor (or array) whose rows
    split into equal contiguous blocks."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} row shards for {mesh.size} shards")
        return [torch.as_tensor(t).to(dev) for t, dev in zip(x, mesh.devices)]
    x = torch.as_tensor(x)
    if x.shape[0] % mesh.size:
        raise ValueError(
            f"{x.shape[0]} rows do not split over {mesh.size} shards")
    per = x.shape[0] // mesh.size
    return [x[s * per:(s + 1) * per].to(dev)
            for s, dev in enumerate(mesh.devices)]


def _lloyd_partial(x_l, w_l, centroids, cs, nc):
    """One shard's share of a Lloyd iteration: ``ops.kmeans._lloyd_chunk``
    over its rows in chunks of ``cs`` with their 0 / 1 weights ``w_l``
    (None: every row counts; the last chunk zero-padded and weighted out,
    as the JAX scan pads it), the partials summed and the candidate pools
    concatenated."""
    n_local, dim = x_l.shape
    sums = counts = d_tot = 0
    pools = ([], [], [], [])
    for c0 in range(0, n_local, cs):
        xc = x_l[c0:c0 + cs].float()
        w = torch.zeros(cs, device=xc.device)
        w[:xc.shape[0]] = 1.0 if w_l is None else w_l[c0:c0 + cs]
        if xc.shape[0] < cs:
            xc = torch.cat([xc, xc.new_zeros((cs - xc.shape[0], dim))])
        c_sums, c_counts, c_d, *cands, _ = _lloyd_chunk(xc, centroids, nc, w)
        sums, counts, d_tot = sums + c_sums, counts + c_counts, d_tot + c_d
        for pool, c in zip(pools, cands):
            pool.append(c)
    return (sums, counts, d_tot, *(torch.cat(p) for p in pools))


def sharded_kmeans_fit(
    mesh: Mesh,
    generator: torch.Generator,
    x_sharded,
    k: int,
    iters: int = 10,
    chunk_size: int = 16384,
    n_cand: int = 32,
    seed_per_chip: int = 8192,
    weight=None,
) -> torch.Tensor:
    """Data-parallel k-means over the mesh: the twin of
    ``ops.kmeans.kmeans_fit`` (the same Lloyd-as-matmuls update and the
    same twin / orphan / overfull reseeding, ``_reseed_step``).

    ``x_sharded`` is ``[N, D]`` split into equal row blocks, or one tensor
    per shard; ``weight`` (the same split, or None: every row counts) is a
    0 / 1 row weight that marks padding rows with 0: they join no
    cluster, add no distortion and are never drawn as a seed or as a
    high-distortion reseed candidate, whatever their values. Per
    iteration each shard
    reduces its partial sums, counts, distortion and candidate pool on its
    device; the partials are summed and the pools gathered on the leader
    (the JAX ``psum`` / ``all_gather``), where the reseed update runs once.
    Seeding is k-means++ on a gathered stratified per-shard sample. Every
    random draw comes from ``generator`` (on the leader). Returns fp32
    centroids ``[k, D]`` on the leader."""
    shards = _row_shards(mesh, x_sharded)
    weights = (_row_shards(mesh, weight) if weight is not None
               else [None] * mesh.size)
    n_local, dim = shards[0].shape
    n = (n_local * mesh.size if weight is None
         else int(sum(float(w.sum()) for w in weights)))
    cs = min(chunk_size, max(n_local, 1))
    nc = min(n_cand, cs)
    take = min(seed_per_chip, n_local)
    stride = max(n_local // max(take, 1), 1)
    seed_pool = all_gather(
        mesh, [(x_l if w_l is None else x_l[w_l > 0])[::stride][:take]
               .float() for x_l, w_l in zip(shards, weights)], dim=0)
    centroids = kmeans_pp_init(seed_pool, k, generator)
    for it in range(iters):
        partials = [
            _lloyd_partial(x_l, w_l, c_l, cs, nc)
            for x_l, w_l, c_l in zip(shards, weights,
                                     replicate(mesh, centroids))
        ]
        sums, counts, d_tot = (psum(mesh, [p[i] for p in partials])
                               for i in range(3))
        new_centroids = torch.where(
            (counts > 0)[:, None], sums / counts.clamp_min(1.0)[:, None],
            centroids,
        )
        pools = [all_gather(mesh, [p[i] for p in partials], dim=0)
                 for i in range(3, 7)]
        centroids = _reseed_step(new_centroids, counts, *pools, d_tot, n,
                                 it, iters, generator, k)
    return centroids


def sharded_kmeans_lloyd_step(mesh: Mesh, x_sharded, centroids,
                              k: int, weight=None) -> torch.Tensor:
    """One data-parallel Lloyd iteration: local assign and partial
    centroid sums per shard, summed on the leader, then the update.
    ``weight`` (split as ``x_sharded``; None: every row counts) is a 0 / 1
    row weight: a row of weight 0 is padding and joins no cluster. Rows
    are never taken for padding by their values, so a real all-zero row
    joins its cluster (the JAX package drops every all-zero row)."""
    if not isinstance(centroids, torch.Tensor):
        centroids = torch.from_numpy(np.array(centroids, np.float32))
    c = centroids.to(device=mesh.leader, dtype=torch.float32)
    weights = (_row_shards(mesh, weight) if weight is not None
               else [None] * mesh.size)
    parts = []
    for x_l, w_l, c_l in zip(_row_shards(mesh, x_sharded), weights,
                             replicate(mesh, c)):
        xf = x_l.float()
        a = pairwise_distance(xf, c_l, Metric.L2).argmin(-1)
        onehot = (a[:, None] == torch.arange(k, device=xf.device)[None, :]
                  ).float()
        if w_l is not None:
            onehot = onehot * w_l.float()[:, None]
        parts.append((onehot.T @ xf, onehot.sum(0)))
    sums = psum(mesh, [p[0] for p in parts])
    cnts = psum(mesh, [p[1] for p in parts])
    return torch.where((cnts > 0)[:, None],
                       sums / cnts.clamp_min(1.0)[:, None], c)
