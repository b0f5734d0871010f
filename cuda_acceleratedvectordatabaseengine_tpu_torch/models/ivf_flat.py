"""IVF-Flat index on torch tensors (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/models/ivf_flat.py``).

k-means coarse quantizer + packed inverted-list arena. A search batch runs
on the index's device as: coarse ``[B, nlist]`` fp32 distance matmul +
top-nprobe, then the probed-list scan, then the host maps positions to user
ids. The scan is chosen by ``IVFFlatConfig.scan_impl`` and routed by
``ops/flat_scan.py``: the grouped kernel K1 (``"auto"`` on CUDA), the
sorted full-row kernel K3 (``"pallas_sorted"``, and every search deeper
than K1's ``KMAX``), the pair kernel K4 (``"pallas"`` on a bf16 / fp32
arena; an int8 arena goes to K3 as in the JAX package), K3 again for
``"ragged"``, or the gather scan (``"auto"`` on the CPU). On the CPU each
kernel name takes its kernel's plain PyTorch version. With
``store_residuals`` the arena keeps a bf16 lo plane, and
``SearchParams(use_exact_rerank=True)`` recomputes the scan's shortlist
in full fp32 from ``stored + lo`` (range ``ivf_flat.rerank``).

Lifecycle: ``remove_ids`` compacts lists in place (``models/arena.py``),
``save`` / ``load`` write and read the JAX package's snapshot format
(``storage/snapshot.py``). The relay-era knobs ``stage_bf16`` and
``query_upload_dtype="bfloat16"`` are not ported; setting one raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# _balance_assignments and _choose_capacity are also imported from here
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
    PackedListArena,
    _append_device,
    _balance_assignments,
    _choose_capacity,
    torch_dtype,
)
# SearchParams, FLT_MAX and ListHeat are also imported from here
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.search import (
    FLT_MAX,
    IVFIndexBase,
    ListHeat,
    SearchParams,
    SearchSpans,
    flat_rerank_depth,
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
    kmeans_assign,
    kmeans_assign_topk,
    kmeans_assign_topk_vals,
    kmeans_fit,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.normalize import (
    l2_normalize,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
    topk_smallest,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.profiling import (
    trace,
)


@dataclasses.dataclass
class IVFFlatConfig:
    """The JAX package's ``IVFFlatConfig``: same fields, same defaults (see
    that class for the measurements behind each default)."""

    dimension: int = 768
    nlist: int = 1024
    metric: Metric = Metric.L2
    dtype: str = "bfloat16"          # arena dtype: bfloat16 | int8 | float32
    train_iters: int = 40            # Lloyd iterations
    train_sample_per_list: int = 128 # train on min(n, nlist * this) rows
    split_threshold: float = 1.5     # overfull-list clone trigger (× mean)
    assign_choices: int = 4          # balanced-assignment spill depth
    seed: int = 42                   # k-means / subsample seed
    max_capacity_factor: float = 8.0 # bulk-build capacity clamp (× mean)
    scan_impl: str = "auto"          # "auto": the grouped kernel on CUDA,
                                     # the gather scan on the CPU; or
                                     # "grouped" (alias "pallas_grouped",
                                     # K1) | "pallas_sorted" (aliases
                                     # "sorted", "ragged": K3) | "pallas"
                                     # (K4) | "gather"
    m_budget: int | None = None      # grouped scan: queries per list-row
                                     # (None = auto from batch and nlist)
    approx_topk: bool = False        # accepted; selection is always exact
    stage_bf16: bool = False         # not ported (must stay False)
    store_residuals: bool = False    # keep the bf16 lo plane (exact rerank)
    int8_residual: bool = True       # int8: encode x − centroid[l]
    multi_assign_eps: float = 0.0    # >0: second copy of rows whose 2nd
                                     # centroid passes d2 ≤ (1+ε)²·d1
    multi_assign_budget: float = 1.0 # replicas per append ≤ this × rows
    query_upload_dtype: str = "float32"  # only float32 is ported

    def __post_init__(self):
        if isinstance(self.metric, str):
            self.metric = Metric.parse(self.metric)
        torch_dtype(self.dtype)
        check_scan_name(self.scan_impl)
        if self.stage_bf16:
            raise NotImplementedError("stage_bf16 is not ported")
        if self.query_upload_dtype != "float32":
            raise NotImplementedError(
                "only query_upload_dtype='float32' is ported"
            )


def dedup_topk(
    d: np.ndarray, ids: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Keep the first (nearest) occurrence of each id of an ascending
    top-k2 result and truncate to ``k``; short rows pad with
    FLT_MAX/INVALID_ID (copied from the JAX package)."""
    b, k2 = ids.shape
    earlier = np.tril(np.ones((k2, k2), bool), -1)
    is_dup = ((ids[:, :, None] == ids[:, None, :]) & earlier).any(-1)
    order = np.argsort(is_dup, axis=1, kind="stable")
    d2 = np.take_along_axis(d, order, 1)[:, :k].copy()
    i2 = np.take_along_axis(ids, order, 1)[:, :k].copy()
    tail = np.arange(k)[None, :] >= (k2 - is_dup.sum(1))[:, None]
    d2[tail] = FLT_MAX
    i2[tail] = INVALID_ID
    return d2, i2


def _bulk_pack_device(x, assignments, nlist: int, cap: int, dtype,
                      anchors=None, store_lo: bool = False):
    """Pack a whole corpus into a fresh arena on the device: per-list rank
    by a stable sort, then the append path's quantize-and-scatter. Returns
    ``(arena, arena_sq, counts, slots, arena_scale, arena_lo)``."""
    dev = x.device
    n = x.shape[0]
    a = assignments.to(device=dev, dtype=torch.long)
    counts = torch.bincount(a, minlength=nlist)
    order = torch.argsort(a, stable=True)
    start = torch.cumsum(counts, 0) - counts
    slots = torch.empty_like(a)
    slots[order] = torch.arange(n, device=dev) - start[a[order]]
    dtype = torch_dtype(dtype)
    arena = torch.zeros((nlist, cap, x.shape[1]), dtype=dtype, device=dev)
    arena_sq = torch.zeros((nlist, cap), dtype=torch.float32, device=dev)
    scale = (
        torch.zeros((nlist, cap), dtype=torch.float32, device=dev)
        if dtype == torch.int8 else None
    )
    lo = (
        torch.zeros((nlist, cap, x.shape[1]), dtype=torch.bfloat16,
                    device=dev)
        if store_lo else None
    )
    step = PackedListArena.APPEND_DEVICE_ROWS
    for s0 in range(0, n, step):
        _append_device(arena, arena_sq, scale, anchors, a[s0:s0 + step],
                       slots[s0:s0 + step], x[s0:s0 + step].float(), lo)
    return arena, arena_sq, counts.int(), slots, scale, lo


def _ivf_search_device(
    queries, centroids, arena, arena_sq, counts, nprobe, k, metric,
    scan_impl="gather", arena_scale=None, arena_anchors=None, m_budget=None,
    scan_capacity=None, rerank_k=0, arena_lo=None,
):
    """The device half of a search: ``(dists [B, k], pos [B, k],
    probe_ids [B, nprobe])``. ``scan_impl`` is any ``IVFFlatConfig``
    name, routed by ``ops/flat_scan.scan_flat`` (K1, K3, K4 or the gather
    scan; K3 where K1 would be asked for more than ``KMAX``). The probe
    set rides along so the host's hotness accounting counts lists that
    were probed. With ``rerank_k`` > 0 and a lo plane the scan keeps
    ``max(k, rerank_k)`` candidates and :func:`_exact_rerank` picks the k.
    Each stage runs in a named ``torch.profiler`` range
    (``ivf_flat.coarse_probe``, ``grouped_scan.*``, ``sorted_scan.*``,
    ``pair_scan.*``, ``ivf_flat.rerank``) so a trace attributes device
    time to it."""
    with trace("ivf_flat.coarse_probe"):
        q = queries.float()
        if metric == Metric.COSINE:
            q = l2_normalize(q)
        coarse = pairwise_distance(q, centroids, metric)      # [B, nlist]
        _, probe_ids = topk_smallest(coarse, nprobe)
        probe_ids = probe_ids.int()
    keep = max(k, rerank_k)
    d, pos = scan_flat(
        scan_impl, q, arena, arena_sq, counts, probe_ids, keep, metric,
        arena_scale=arena_scale, arena_anchors=arena_anchors,
        m_budget=m_budget, scan_capacity=scan_capacity,
    )
    if rerank_k > 0 and arena_lo is not None:
        with trace("ivf_flat.rerank"):
            d, pos = _exact_rerank(q, pos[:, :keep], arena, arena_lo,
                                   arena_scale, arena_anchors, k, metric)
        return d, pos, probe_ids
    return d[:, :k], pos[:, :k], probe_ids


def _exact_rerank(q, pos, arena, arena_lo, arena_scale, arena_anchors, k,
                  metric):
    """The top ``k`` of the candidates ``pos [B, keep]`` by distances
    recomputed in full fp32 (TF32 is off package-wide) from the rebuilt
    rows ``stored + lo``, as the JAX package's rerank stage computes them
    at ``Precision.HIGHEST``: a small batched product outside any
    kernel."""
    nlist, cap, dim = arena.shape
    safe = pos.clamp_min(0).long()
    cand = arena.view(nlist * cap, dim)[safe].float()          # [B, keep, D]
    if arena_scale is not None:
        cand = cand * arena_scale.reshape(-1)[safe][:, :, None]
    if arena_anchors is not None:
        cand = cand + arena_anchors[safe // cap]
    cand = cand + arena_lo.view(nlist * cap, dim)[safe].float()
    dots = torch.bmm(cand, q[:, :, None])[:, :, 0]
    c_sq = (cand * cand).sum(-1)
    if metric == Metric.INNER_PRODUCT:
        exact = -dots
    elif metric == Metric.COSINE:
        exact = 1.0 - dots * torch.rsqrt(c_sq.clamp_min(1e-12))
    else:
        q_sq = (q * q).sum(-1)
        exact = (q_sq[:, None] - 2.0 * dots + c_sq).clamp_min(0.0)
    exact = torch.where(pos >= 0, exact, float("inf"))
    return topk_smallest(exact, k, idx=pos)


class IVFFlatIndex(IVFIndexBase):
    """IVF-Flat ANN index on one device: ``"cuda"`` unless the caller names
    another (``"cpu"``, ``"cuda:1"``, ...). Its search cycle is
    ``models/search.IVFIndexBase``'s (spans ``ivf_flat.*``)."""

    SPANS = SearchSpans.of("ivf_flat")

    def __init__(self, config: IVFFlatConfig,
                 device: torch.device | str | None = "cuda"):
        super().__init__(config, device)
        self.arena = PackedListArena.create(
            config.nlist, config.dimension, dtype=torch_dtype(config.dtype),
            store_residuals=config.store_residuals, device=self.device,
        )
        self.centroids: torch.Tensor | None = None  # [nlist, dim] fp32

    # ------------------------------------------------------------------ #
    # build
    # ------------------------------------------------------------------ #

    def _quant_anchors(self) -> torch.Tensor | None:
        """Residual anchors for int8 encoding (the coarse centroids), or
        ``None`` when raw-value quantization is configured."""
        if (
            self.arena.dtype == torch.int8
            and self.config.int8_residual
            and self.centroids is not None
        ):
            return self.centroids
        return None

    def _publish_anchors(self) -> None:
        """Bind the centroids to the (still empty) arena as residual
        anchors. Never rebinds once rows exist: stored codes decode only
        with the anchors they were encoded against."""
        anchors = self._quant_anchors()
        if anchors is not None and self.arena.total_vectors == 0:
            self.arena = dataclasses.replace(self.arena, anchors=anchors)

    def _fit(self, sample: torch.Tensor, generator: torch.Generator) -> None:
        cfg = self.config
        self.centroids, _ = kmeans_fit(
            sample, cfg.nlist, iters=cfg.train_iters,
            split_thresh=cfg.split_threshold, generator=generator,
        )
        self.trained = True
        self._publish_anchors()

    def train(self, vectors: np.ndarray) -> None:
        """k-means++ + Lloyd iterations on a uniform subsample of
        ``train_sample_per_list * nlist`` host rows."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        n = vectors.shape[0]
        cfg = self.config
        if n < cfg.nlist:
            raise ValueError(
                f"need at least nlist={cfg.nlist} training vectors, got {n}"
            )
        cap = cfg.train_sample_per_list * cfg.nlist
        if n > cap:
            rng = np.random.default_rng(cfg.seed)
            vectors = vectors[rng.choice(n, cap, replace=False)]
        sample = self._to_device(vectors)
        if self.metric == Metric.COSINE:
            sample = l2_normalize(sample)
        self._fit(sample, self._generator())

    def train_from_device(self, x_dev: torch.Tensor) -> None:
        """Train from a device-resident corpus (subsampled before the fp32
        cast, so a bf16 corpus is never copied whole to fp32)."""
        self._fit(*self._device_sample(x_dev))

    def add(self, vectors: np.ndarray, ids: np.ndarray | None = None) -> None:
        """Assign each row to its nearest list and append it (the arena
        grows when a list fills)."""
        if not self.trained:
            raise RuntimeError("index must be trained before add()")
        vectors = np.ascontiguousarray(vectors, np.float32)
        n = vectors.shape[0]
        if n == 0:
            return
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + n, dtype=np.uint64)
        vec_d = self._to_device(vectors)
        if self.metric == Metric.COSINE:
            vec_d = l2_normalize(vec_d)
        assignments = kmeans_assign(
            vec_d, self.centroids, self._assign_metric()
        ).cpu().numpy()
        with self._mutate_lock:
            self.arena = self.arena.append(vec_d, np.asarray(ids),
                                           assignments)

    def build_from_device(
        self, x_dev: torch.Tensor, ids: np.ndarray | None = None
    ) -> None:
        """One-shot bulk build of a fresh arena from a device-resident
        corpus: balanced assignment with the capacity clamped near the p99
        list size (overflow spills to next-nearest lists), then one device
        pack. Replaces any existing lists."""
        if not self.trained:
            raise RuntimeError("index must be trained before build")
        cfg = self.config
        x_dev = self._to_device(x_dev)
        n = x_dev.shape[0]
        if self.metric == Metric.COSINE:
            x_dev = l2_normalize(x_dev)
        choices = kmeans_assign_topk(
            x_dev, self.centroids, cfg.assign_choices, self._assign_metric()
        ).cpu().numpy()
        counts0 = np.bincount(choices[:, 0], minlength=cfg.nlist)
        cap = _choose_capacity(
            counts0, PackedListArena.SLOT_ALIGN,
            max_factor=cfg.max_capacity_factor,
        )
        assignments_np = _balance_assignments(choices, cap, cfg.nlist)
        anchors = self._quant_anchors()
        arena, arena_sq, counts_d, slots, scale, lo = _bulk_pack_device(
            x_dev, torch.from_numpy(assignments_np), cfg.nlist, cap,
            cfg.dtype, anchors,
            store_lo=cfg.store_residuals
            and torch_dtype(cfg.dtype) != torch.float32,
        )
        if ids is None:
            ids = np.arange(n, dtype=np.uint64)
        ids_table = np.full((cfg.nlist, cap), INVALID_ID, np.uint64)
        ids_table[assignments_np, slots.cpu().numpy()] = ids
        with self._mutate_lock:
            self.arena = PackedListArena(
                nlist=cfg.nlist, dim=cfg.dimension, dtype=arena.dtype,
                capacity=cap, arena=arena, arena_sq=arena_sq,
                counts=counts_d, ids=ids_table, arena_scale=scale,
                anchors=anchors, arena_lo=lo,
                counts_max=int(
                    np.bincount(assignments_np, minlength=cfg.nlist).max()
                ),
            )

    def remove_ids(self, ids: np.ndarray) -> int:
        """Delete vectors by user id; returns how many were removed.
        Locates ``(list, slot)`` through the host id table, then compacts
        the affected lists in place (``PackedListArena.remove``), so no
        rebuild and no tombstones. Unknown ids are ignored (idempotent).
        A ``StreamingIVFFlatIndex`` built from this index holds its own
        host copy and does not see the removal."""
        ids = np.unique(np.asarray(ids, np.uint64))
        ids = ids[ids != INVALID_ID]
        if ids.size == 0 or self.ntotal == 0:
            return 0
        with self._mutate_lock:
            lists, slots = np.nonzero(np.isin(self.arena.ids, ids))
            if lists.size == 0:
                return 0
            self.arena, n_removed = self.arena.remove(lists, slots)
        return n_removed

    def append_balanced(
        self,
        x_dev: torch.Tensor,
        ids: np.ndarray | None = None,
        capacity: int | None = None,
    ) -> None:
        """Chunked-build ingest: capacity-respecting append of a chunk. The
        caller fixes ``capacity`` up front; rows that would overflow a full
        list spill to their next-nearest lists, so the arena never
        reallocates mid-build.

        With ``config.multi_assign_eps > 0``, rows whose 2nd-nearest
        centroid passes d2 ≤ (1+ε)²·d1 (squared L2) also get a second copy
        in that list (at most ``multi_assign_budget × n`` copies, tightest
        ratios first); search dedups by id."""
        if not self.trained:
            raise RuntimeError("index must be trained before append")
        cfg = self.config
        x_dev = self._to_device(x_dev)
        n = x_dev.shape[0]
        if self.metric == Metric.COSINE:
            x_dev = l2_normalize(x_dev)
        eps = float(cfg.multi_assign_eps or 0.0)
        t = max(cfg.assign_choices, 2 if eps > 0 else 1)
        vals_d, choices_d = kmeans_assign_topk_vals(
            x_dev, self.centroids, t, self._assign_metric()
        )
        choices = choices_d.cpu().numpy()
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + n, dtype=np.uint64)
        ids = np.asarray(ids)
        with self._mutate_lock:
            if capacity is not None and capacity > self.arena.capacity:
                self.arena = self.arena.grow(capacity)
            cap = self.arena.capacity
            assignments = _balance_assignments(
                choices, cap, cfg.nlist,
                initial_counts=self.arena.counts.cpu().numpy(),
            )
            self.arena = self.arena.append(x_dev, ids, assignments)
            if eps <= 0:
                return
            # Replica pass: placement ranks from the 2nd choice on.
            vals = vals_d.cpu().numpy()
            ratio = vals[:, 1] / np.maximum(vals[:, 0], 1e-12)
            rep = np.flatnonzero(ratio <= (1.0 + eps) ** 2)
            budget = int(n * max(cfg.multi_assign_budget, 0.0))
            if rep.size > budget:
                rep = np.sort(
                    rep[np.argsort(ratio[rep], kind="stable")[:budget]]
                )
            if rep.size:
                rep_assign = _balance_assignments(
                    choices[rep, 1:], cap, cfg.nlist,
                    initial_counts=self.arena.counts.cpu().numpy(),
                )
                x_rep = x_dev[torch.from_numpy(rep).to(self.device)]
                self.arena = self.arena.append(x_rep, ids[rep], rep_assign)

    # ------------------------------------------------------------------ #
    # search
    # ------------------------------------------------------------------ #

    @property
    def ntotal(self) -> int:
        return self.arena.total_vectors

    def _enqueue(self, q_dev, queries, params, nprobe):
        # Multi-assignment indices scan a doubled shortlist, so the host
        # dedup can still hand back k unique ids.
        k = params.k
        k_dev = 2 * k if self.config.multi_assign_eps > 0 else k
        arena = self.arena
        d_dev, pos_dev, probes_dev = _ivf_search_device(
            q_dev, self.centroids, arena.arena,
            arena.arena_sq, arena.counts, nprobe, k_dev, self.metric,
            self.config.scan_impl, arena.arena_scale, arena.anchors,
            self.config.m_budget, arena.scan_capacity_hint(),
            flat_rerank_depth(params, arena.arena_lo is not None, k_dev),
            arena.arena_lo,
        )
        self._heat.add_probes(probes_dev)
        post = None if k_dev == k else (
            lambda d, ids, waits, counts: dedup_topk(d, ids, k))
        return d_dev, pos_dev, arena.ids, post

    def calibrate_nprobe(
        self,
        queries: np.ndarray | None = None,
        target_coverage: float = 0.99,
        k: int = 10,
        candidates: tuple = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128),
        sample: int = 512,
        seed: int = 0,
    ) -> dict:
        """Measure probe coverage on this index and pick the smallest
        ``nprobe`` meeting ``target_coverage`` (against an exact full-probe
        search). Sets ``self.calibrated_nprobe`` and returns ``{"nprobe",
        "coverage", "curve", "target", ...}``. Without ``queries`` it
        samples stored rows, which over-estimates coverage slightly."""
        if not self.trained:
            raise RuntimeError("index must be trained before calibration")
        from cuda_acceleratedvectordatabaseengine_tpu_torch.models.calibrate \
            import probe_coverage_calibrate, sample_stored_rows

        if queries is None:
            queries = sample_stored_rows(self.arena, sample, seed)
        result = probe_coverage_calibrate(
            centroids=self.centroids,
            metric=self.metric,
            ids_table=self.arena.ids,
            queries=queries,
            exact_search_fn=lambda q, kk: self.search(
                q, SearchParams(nprobe=self.config.nlist, k=kk)
            ),
            target_coverage=target_coverage,
            k=k,
            candidates=candidates,
        )
        self.calibrated_nprobe = result["nprobe"]
        return result

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #

    def state_arrays(self) -> dict:
        """Packed arrays (dequantized fp32 arena without the lo plane,
        counts, ids), as the JAX package's ``state_arrays``."""
        host = self.arena.to_host()
        return {
            "centroids": self.centroids.cpu().numpy(),
            "arena": host["arena"],
            "counts": host["counts"],
            "ids": host["ids"],
        }

    def save(self, path: str) -> None:
        """Write a snapshot directory (``storage/snapshot.save_ivf_flat``)
        under the mutation lock: one consistent arena state."""
        from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.snapshot \
            import save_ivf_flat

        with self._mutate_lock:
            save_ivf_flat(path, self)

    @classmethod
    def load(cls, path: str,
             device: torch.device | str | None = "cuda") -> "IVFFlatIndex":
        """Read a snapshot written by either package onto ``device``."""
        from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.snapshot \
            import load_ivf_flat

        return load_ivf_flat(path, device=device)

    @classmethod
    def from_state(
        cls,
        config: IVFFlatConfig,
        centroids: np.ndarray,
        arena: np.ndarray,
        counts: np.ndarray,
        ids: np.ndarray,
        device: torch.device | str | None = "cuda",
    ) -> "IVFFlatIndex":
        idx = cls(config, device=device)
        idx.centroids = torch.from_numpy(
            np.ascontiguousarray(centroids, np.float32)
        ).to(idx.device)
        anchors = (
            centroids.astype(np.float32)
            if torch_dtype(config.dtype) == torch.int8 and config.int8_residual
            else None
        )
        idx.arena = PackedListArena.from_host(
            arena, counts, ids, config.dtype, anchors=anchors,
            device=idx.device,
        )
        idx.trained = True
        return idx

    def memory_stats(self) -> dict:
        """Device-memory accounting of the index."""
        centroid_bytes = (
            0 if self.centroids is None else self.centroids.numel() * 4
        )
        arena_bytes = self.arena.nbytes_device()
        return {
            "arena_bytes": arena_bytes,
            "centroid_bytes": centroid_bytes,
            "total_bytes": arena_bytes + centroid_bytes,
            "total_vectors": self.ntotal,
            "nlist": self.config.nlist,
            "capacity_per_list": self.arena.capacity,
        }
