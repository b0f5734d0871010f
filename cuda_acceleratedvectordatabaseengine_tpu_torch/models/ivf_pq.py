"""IVF-PQ index on torch tensors (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/models/ivf_pq.py``).

Coarse quantizer + 8-bit product-quantized *residual* codes (``x − coarse
centroid``), with an optional raw-row arena for an exact rerank. A search
batch runs on the index's device as:

  query (→ OPQ frame) → coarse ``[B, nlist]`` fp32 distances + top-nprobe
  → ADC scan of the probed lists' codes (the hand-written grouped kernel K2
    on CUDA, the gather ADC on the CPU)
  → optional exact fp32 rerank of the top ``rerank_k`` over the raw rows
  → the host maps positions to user ids.

On CUDA, from the second search of a shape on, the device half is replayed
from two captured CUDA graphs (``_SearchGraph``: the shortlist, then the
rerank), one launch each where the eager search makes some forty.

Two frames under OPQ: codes and centroids live in the rotated frame, raw
rerank rows in the original one, so the rerank pairs the stored rows with
the unrotated query (the JAX package's round-5 fix). Every rotation and the
rerank run in full fp32 (TF32 is off package-wide).

Mutation rule (``models/arena.py``): an append writes codes only into
slots past the published counts, growth allocates new tensors, and a
removal moves surviving tail rows into holes in place; each publishes new
counts and a copied id table. A search takes one consistent snapshot of
codes, ``code_sq``, the raw handle, counts and ids and enqueues its device
work under the same lock as the mutations, so device work runs in lock
order on the one stream.

``save`` / ``load`` write and read the JAX package's snapshot format
(``storage/snapshot.py``). Past the device memory wall the index keeps no
raw rows (``keep_raw=False``) and ``attach_host_rerank`` reranks the ADC
shortlist from an int8 row store in host RAM (``io_host/host_rerank.py``):
the capacity tier, loaded by ``storage.load_ivf_pq_capacity``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
    PackedListArena,
    _balance_assignments,
    _choose_capacity,
    _remove_device,
    apply_removal_to_ids,
    compute_append_slots,
    plan_removals,
    torch_dtype,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.search import (
    IVFIndexBase,
    SearchParams,
    SearchSpans,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
    Metric,
    pairwise_distance,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import grouped_pq_scan
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.grouped_pq_scan import (
    scan_probed_codes_grouped,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.kmeans import (
    kmeans_assign,
    kmeans_assign_topk,
    kmeans_fit,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.normalize import (
    l2_normalize,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.pq import (
    _mm,
    opq_fit,
    pq_adc_lookup,
    pq_decode,
    pq_distance_tables,
    pq_encode,
    train_product_quantizer,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
    topk_smallest,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.batching import (
    BUCKETS,
    bucket_size,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.profiling import (
    trace,
)

# scan_impl names this package runs; "xla" and "pallas" are the JAX
# package's names for the gather ADC and the grouped kernel.
_SCAN_IMPLS = {
    "auto": "auto", "xla": "gather", "gather": "gather",
    "pallas": "grouped", "grouped": "grouped",
}
# Bound on the emit_full row transient of one probe chunk (bytes).
_FULL_ROWS_BYTES = 2 << 30
# Nearest lists ranked for each row of a bulk build (IVFFlatConfig's
# assign_choices): a row past a full list falls to the next of them.
BULK_ASSIGN_CHOICES = 4
# Bound on the fp32 candidate-row transient of the exact rerank (bytes): a
# deep shortlist goes through in query chunks ([B, R, D] fp32 is 805 MB at
# B 64, R 4096, D 768).
_RERANK_ROWS_BYTES = 256 << 20


@dataclasses.dataclass
class IVFPQConfig:
    """The JAX package's ``IVFPQConfig``: same fields, same defaults, and
    ``rerank_k``, the upstream ``IVFPQIndex``'s exact-rerank depth: the ADC
    candidates per query that a ``use_exact_rerank`` search reranks from
    the resident raw rows (:func:`rerank_depth`; 0: ``min(4k, 256)``)."""

    dimension: int = 768
    nlist: int = 1024
    m: int = 96                 # subquantizers; dimension % m == 0
    nbits: int = 8              # codebook bits (ks = 2^nbits); only 8
    metric: Metric = Metric.L2
    keep_raw: bool = True       # retain raw rows for the exact rerank
    raw_dtype: str = "bfloat16"
    train_iters: int = 40
    train_sample_per_list: int = 128
    pq_train_sample: int = 65536
    seed: int = 42
    scan_impl: str = "auto"     # "auto": the grouped kernel on CUDA, the
                                # gather ADC on the CPU; or "pallas" (alias
                                # "grouped") | "xla" (alias "gather")
    opq: bool = False           # learn an OPQ rotation (ops/pq.opq_fit)
    opq_iters: int = 6          # OPQ alternations (Procrustes + Lloyd)
    query_upload_dtype: str = "float32"  # only float32 is ported
    rerank_k: int = 0           # resident exact-rerank depth; 0: min(4k, 256)

    def __post_init__(self):
        if isinstance(self.metric, str):
            self.metric = Metric.parse(self.metric)
        if self.rerank_k < 0:
            raise ValueError(f"rerank_k {self.rerank_k} < 0")
        if self.dimension % self.m:
            raise ValueError(f"dimension {self.dimension} % m {self.m} != 0")
        if self.nbits != 8:
            raise ValueError("only nbits=8 (uint8 codes) is supported")
        if self.scan_impl not in _SCAN_IMPLS:
            raise ValueError(
                f"scan_impl {self.scan_impl!r} is not available in this "
                f"package; expected one of {sorted(_SCAN_IMPLS)}"
            )
        if self.query_upload_dtype != "float32":
            raise NotImplementedError(
                "only query_upload_dtype='float32' is ported"
            )

    @property
    def ks(self) -> int:
        return 1 << self.nbits


def rerank_depth(rerank_k: int, k: int, candidates: int) -> int:
    """ADC candidates per query that the resident exact rerank reads: the
    index's ``rerank_k`` where set (at least ``k``), else ``min(4k, 256)``;
    never more than ``candidates``, the slots the search's probed lists
    offer (``nprobe`` · the scanned capacity)."""
    depth = max(rerank_k, k) if rerank_k > 0 else min(max(4 * k, k), 256)
    return max(min(depth, candidates), 1)


def _gather_adc(q, centroids, codebooks, code_arena_t, counts, probe_ids,
                keep, metric):
    """Gather ADC over the probed lists, one probe column at a time, merged
    into a running top-``keep`` (the JAX package's XLA path)."""
    b, dim = q.shape
    nlist, m, cap = code_arena_t.shape
    dev = q.device
    slot = torch.arange(cap, device=dev)
    best_d = torch.full((b, keep), float("inf"), device=dev)
    best_p = torch.full((b, keep), -1, dtype=torch.int32, device=dev)
    for lists in probe_ids.T:
        safe = lists.clamp_min(0).long()
        c = centroids[safe]                                       # [B, D]
        if metric == Metric.INNER_PRODUCT:
            # d = −(q·x) = −(q·c) − (q·r): table term from q, bias from c
            tables = -torch.einsum("bmd,mkd->bmk",
                                   q.reshape(b, m, dim // m), codebooks)
            bias = -(q * c).sum(-1)
        else:
            # L2 (and cosine as L2): ‖q − (c + r̂)‖² over residual tables
            tables = pq_distance_tables(q - c, codebooks)
            bias = torch.zeros((b,), device=dev)
        d = pq_adc_lookup(tables, code_arena_t[safe]) + bias[:, None]
        valid = (slot[None, :] < counts[safe].long()[:, None]) & (
            lists >= 0)[:, None]
        d = torch.where(valid, d, float("inf"))
        pos = torch.where(valid, safe[:, None] * cap + slot[None, :],
                          -1).int()
        best_d, best_p = topk_smallest(torch.cat([best_d, d], 1), keep,
                                       idx=torch.cat([best_p, pos], 1))
    return best_d, best_p


def grouped_adc(q, code_arena_t, code_sq, counts, centroids, codebooks,
                probe_ids, keep, metric, k_inner=0, scan_capacity=None,
                slot_stride=1, slot_offset=0, global_capacity=None):
    """The top-``keep`` ADC candidates of the probed lists through the
    grouped kernel K2 (``ops/grouped_pq_scan.py``): ``(dists [B, keep],
    pos [B, keep])``. Deep shortlists (a rerank feed) skip the in-kernel
    top-k, whose cost grows with its depth: full distance rows + one
    top-keep, unless the caller chose per-list ``k_inner`` truncation.
    The row transient is bounded by chunking the probe axis (chunks cover
    disjoint lists, so the merge is exact). ``q`` is in the codes' frame
    (rotated under OPQ, unit for cosine); the striping arguments describe
    one shard of a slot-striped code arena (``parallel/sharded.py``)."""
    b = q.shape[0]
    nprobe = probe_ids.shape[1]
    cap = code_arena_t.shape[2]
    emit_full = keep > 32 and not k_inner
    step_p = nprobe
    if emit_full:
        cap_b = cap
        if scan_capacity is not None:
            cap_b = min(cap_b, -(-scan_capacity // 128) * 128)
        n_chunks = 1
        while b * step_p * cap_b * 4 > _FULL_ROWS_BYTES and step_p > 1:
            n_chunks += 1
            step_p = -(-nprobe // n_chunks)
    kernel_metric = (Metric.INNER_PRODUCT
                     if metric == Metric.INNER_PRODUCT else Metric.L2)
    parts = [
        scan_probed_codes_grouped(
            q, code_arena_t, code_sq, counts, centroids, codebooks,
            probe_ids[:, s:s + step_p].contiguous(), keep, kernel_metric,
            k_inner=(k_inner or None), emit_full=emit_full,
            scan_capacity=scan_capacity, slot_stride=slot_stride,
            slot_offset=slot_offset, global_capacity=global_capacity,
        )
        for s in range(0, nprobe, step_p)
    ]
    if len(parts) == 1:
        return parts[0]
    with trace("grouped_pq_scan.select" if emit_full
               else "grouped_pq_scan.epilogue"):
        return topk_smallest(
            torch.cat([p[0] for p in parts], 1), keep,
            idx=torch.cat([p[1] for p in parts], 1),
        )


def _exact_rerank(q0, q_sq, best_p, raw_arena, raw_sq, raw_scale,
                  raw_anchors, k, metric):
    """Exact fp32 distances of the shortlist ``best_p [B, R]`` (global
    positions, -1 for none) against the raw rows, which live in the
    ORIGINAL frame: paired with the unrotated ``q0``; the top-``k``. The
    gathered rows go through in query chunks of at most
    :data:`_RERANK_ROWS_BYTES` of fp32, each query's products as one."""
    nlist, cap, dim = raw_arena.shape
    b, keep = best_p.shape
    rows = raw_arena.reshape(nlist * cap, dim)
    safe_p = best_p.clamp_min(0).long()
    step = max(1, _RERANK_ROWS_BYTES // max(keep * dim * 4, 1))
    dots = []
    for b0 in range(0, b, step):
        p = safe_p[b0:b0 + step]
        cand = rows[p].float()
        if raw_scale is not None:
            cand = cand * raw_scale.reshape(-1)[p][:, :, None]
        if raw_anchors is not None:
            cand = cand + raw_anchors[p // cap]
        dots.append(torch.bmm(cand, q0[b0:b0 + step, :, None])[:, :, 0])
        del cand
    dots = dots[0] if len(dots) == 1 else torch.cat(dots)     # [B, R]
    if metric == Metric.INNER_PRODUCT:
        exact = -dots
    elif metric == Metric.COSINE:
        exact = 1.0 - dots
    else:
        exact = (q_sq[:, None] - 2.0 * dots
                 + raw_sq.reshape(-1)[safe_p]).clamp_min(0.0)
    exact = torch.where(best_p >= 0, exact, float("inf"))
    return topk_smallest(exact, k, idx=best_p)


def _ivf_pq_shortlist(queries, centroids, codebooks, code_arena_t, code_sq,
                      counts, nprobe, keep, metric, scan_impl, opq_R=None,
                      k_inner=0, scan_capacity=None):
    """The shortlist half of a search: the coarse probe and the top-``keep``
    ADC candidates of the probed lists; ``(q0, q_sq, probe_ids, best_d,
    best_p)``, ``q0`` the query in the original frame (the rerank's) and
    ``q_sq`` the squared norm of the query in the codes' frame.
    ``scan_impl`` is ``"grouped"`` or ``"gather"``."""
    with trace("ivf_pq.coarse_probe"):
        q0 = queries.float()               # the ORIGINAL frame (rerank's)
        if metric == Metric.COSINE:
            q0 = l2_normalize(q0)
        q = _mm(q0, opq_R) if opq_R is not None else q0
        q_sq = (q * q).sum(-1)
        # For cosine the stored rows are unit vectors, so L2 order over the
        # centroids is cosine order; report-space conversion comes last.
        coarse_metric = (Metric.INNER_PRODUCT
                         if metric == Metric.INNER_PRODUCT else Metric.L2)
        coarse = pairwise_distance(q, centroids, coarse_metric)
        _, probe_ids = topk_smallest(coarse, nprobe)
        probe_ids = probe_ids.int()
    if scan_impl == "grouped":
        best_d, best_p = grouped_adc(
            q, code_arena_t, code_sq, counts, centroids, codebooks,
            probe_ids, keep, metric, k_inner=k_inner,
            scan_capacity=scan_capacity)
    else:
        with trace("ivf_pq.gather_adc"):
            best_d, best_p = _gather_adc(q, centroids, codebooks,
                                         code_arena_t, counts, probe_ids,
                                         keep, metric)
    return q0, q_sq, probe_ids, best_d, best_p


def _ivf_pq_finish(short, raw_arena, raw_sq, raw_scale, raw_anchors, k,
                   metric, rerank_k):
    """The finish of a search from its :func:`_ivf_pq_shortlist`: the exact
    rerank of the shortlist where ``rerank_k`` > 0 and raw rows are kept,
    else its first ``k``; ``(dists [B, k], pos [B, k])``."""
    q0, q_sq, _, best_d, best_p = short
    if rerank_k > 0 and raw_arena is not None:
        return _exact_rerank(q0, q_sq, best_p, raw_arena, raw_sq, raw_scale,
                             raw_anchors, k, metric)
    best_d, best_p = best_d[:, :k], best_p[:, :k]
    if metric == Metric.COSINE:
        # ADC ran in L2 over unit vectors: ‖q − x‖² = 2(1 − cos) → halve
        best_d = torch.where(torch.isfinite(best_d), best_d * 0.5, best_d)
    return best_d, best_p


def _resolve_scan_impl(scan_impl, is_cuda):
    if scan_impl not in _SCAN_IMPLS:
        raise ValueError(f"scan_impl {scan_impl!r} is not available in this "
                         f"package; expected one of {sorted(_SCAN_IMPLS)}")
    scan_impl = _SCAN_IMPLS[scan_impl]
    if scan_impl == "auto":
        scan_impl = "grouped" if is_cuda else "gather"
    return scan_impl


def _check_raw_capacity(raw_arena, code_arena_t, rerank_k):
    if rerank_k > 0 and raw_arena is not None and (
            raw_arena.shape[1] != code_arena_t.shape[2]):
        raise AssertionError(
            f"raw capacity {raw_arena.shape[1]} != code capacity "
            f"{code_arena_t.shape[2]}: positions would map to the wrong rows"
        )


def _rerank_marks(rerank_stats, best_p, reranks):
    """Fill ``rerank_stats`` (where given and the rerank runs) with the
    shortlist's real candidates summed over the queries (``rows``, a
    device tensor) and, on CUDA, two timing events (``events``), returned
    for the caller to record around the rerank."""
    if rerank_stats is None or not reranks:
        return None
    rerank_stats["rows"] = (best_p >= 0).sum()
    if not best_p.is_cuda:
        return None
    events = rerank_stats["events"] = (
        torch.cuda.Event(enable_timing=True),
        torch.cuda.Event(enable_timing=True))
    return events


def _rerank_readings(stats, d, ids, waits, counts):
    """The post-step of a resident rerank, after the search's wait: its
    device ms (``rerank``, from :func:`_rerank_marks`' events; 0.0 on the
    CPU) and its mean candidates a query (``rerank_rows``)."""
    ev = stats.get("events")
    waits["rerank"] = ev[0].elapsed_time(ev[1]) if ev else 0.0
    counts["rerank_rows"] = int(stats["rows"]) / d.shape[0]
    return d, ids


def _ivf_pq_search_device(
    queries, centroids, codebooks, code_arena_t, code_sq, counts, raw_arena,
    raw_sq, raw_scale, raw_anchors, nprobe, k, metric, rerank_k,
    scan_impl="gather", opq_R=None, k_inner=0, scan_capacity=None,
    heat=None, rerank_stats=None,
):
    """The device half of a search: ``(dists [B, k], pos [B, k])``.
    ``rerank_k`` 0 means no rerank, else the shortlist depth (at most the
    probed slots: :func:`rerank_depth`); ``k_inner`` > 0 selects the
    kernel's per-list shortlist mode; ``heat`` (a ``ListHeat``) counts the
    probes. ``rerank_stats`` (a dict), where the rerank runs, receives
    ``rows``, the device tensor of the shortlist's real candidates summed
    over the queries, and on CUDA ``events``, two timing events recorded
    on the current stream around the rerank. ``scan_impl`` takes every
    name of ``_SCAN_IMPLS`` (the JAX package's ``"pallas"`` is K2,
    ``"auto"`` K2 on CUDA and the gather ADC elsewhere) and raises on any
    other. Each stage runs in a named ``torch.profiler`` range
    (``ivf_pq.coarse_probe``, ``grouped_pq_scan.*`` or
    ``ivf_pq.gather_adc``, ``ivf_pq.rerank``)."""
    scan_impl = _resolve_scan_impl(scan_impl, queries.is_cuda)
    _check_raw_capacity(raw_arena, code_arena_t, rerank_k)
    short = _ivf_pq_shortlist(
        queries, centroids, codebooks, code_arena_t, code_sq, counts, nprobe,
        max(k, rerank_k), metric, scan_impl, opq_R, k_inner, scan_capacity)
    if heat is not None:
        heat.add_probes(short[2])
    reranks = rerank_k > 0 and raw_arena is not None
    if not reranks:
        return _ivf_pq_finish(short, raw_arena, raw_sq, raw_scale,
                              raw_anchors, k, metric, rerank_k)
    events = _rerank_marks(rerank_stats, short[4], reranks)
    with trace("ivf_pq.rerank"):
        if events is not None:
            events[0].record()
        out = _ivf_pq_finish(short, raw_arena, raw_sq, raw_scale,
                             raw_anchors, k, metric, rerank_k)
        if events is not None:
            events[1].record()
        return out


class _SearchGraph:
    """The device half of one search shape as two CUDA graphs, captured
    once and replayed on the current stream: the shortlist
    (:func:`_ivf_pq_shortlist`: coarse probe, K2, top-R) and its finish
    (:func:`_ivf_pq_finish`: the exact rerank), one launch each in place
    of some forty launches and the host work between them. The queries
    are copied into a static buffer of ``rows`` queries, a batch bucket
    (``utils/batching.BUCKETS``): the rows past a batch hold earlier
    queries, and their answers are dropped. The answers are copied out of
    the static outputs, which the next replay overwrites in the stream's
    order. Nothing in the captured work reads the host or waits for the
    card."""

    def __init__(self, rows, dim, device, shortlist, finish):
        self.q = torch.zeros((rows, dim), dtype=torch.float32, device=device)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):  # first use outside the capture
            finish(shortlist(self.q))
        launches0 = grouped_pq_scan.LAUNCHES
        self.shortlist = torch.cuda.CUDAGraph()
        self.finish = torch.cuda.CUDAGraph()
        # thread_local: the finalize thread copies earlier answers back
        # while this thread captures
        with torch.cuda.graph(self.shortlist, stream=stream,
                              capture_error_mode="thread_local"):
            self.short = shortlist(self.q)
        with torch.cuda.graph(self.finish, pool=self.shortlist.pool(),
                              stream=stream,
                              capture_error_mode="thread_local"):
            self.out = finish(self.short)
        # K2 launches a replay makes (grouped_pq_scan.LAUNCHES counts them)
        self.launches = grouped_pq_scan.LAUNCHES - launches0

    def run(self, q, heat, rerank_stats, reranks):
        """Replay for the queries ``q [B, D]`` (B ≤ the buffer's rows):
        ``(dists [B, k], pos [B, k])``, new tensors; ``heat`` and
        ``rerank_stats`` as :func:`_ivf_pq_search_device` takes them."""
        b = q.shape[0]
        with trace("ivf_pq.shortlist"):
            self.q[:b].copy_(q)
            self.shortlist.replay()
            grouped_pq_scan.LAUNCHES += self.launches
            best_p = self.short[4][:b]
            if heat is not None:
                heat.add_probes(self.short[2][:b])
        events = _rerank_marks(rerank_stats, best_p, reranks)
        with trace("ivf_pq.rerank" if reranks else "ivf_pq.finish"):
            if events is not None:
                events[0].record()
            self.finish.replay()
            if events is not None:
                events[1].record()
            return self.out[0][:b].clone(), self.out[1][:b].clone()


class IVFPQIndex(IVFIndexBase):
    """IVF index with 8-bit product-quantized residual codes on one
    device: ``"cuda"`` unless the caller names another (``"cpu"``,
    ``"cuda:1"``, ...). Its search cycle is ``models/search.IVFIndexBase``'s
    (spans ``ivf_pq.*``)."""

    SPANS = SearchSpans.of("ivf_pq")

    # set by storage.load_ivf_pq_capacity: the serving engine routes adds
    # and removals of such an index to the next epoch build
    read_only = False
    # rows build_from_device encodes and writes at a time (its fp32 slice
    # and the encoder's transients: about 3 GB at D 768)
    BUILD_SLICE_ROWS = 262_144
    # A resident search on CUDA replays its device half from CUDA graphs
    # (_SearchGraph), at most GRAPH_SHAPES shapes kept, the least recently
    # used dropped first.
    graph_searches = True
    GRAPH_SHAPES = 8

    def __init__(self, config: IVFPQConfig,
                 device: torch.device | str | None = "cuda"):
        super().__init__(config, device)
        self.centroids: torch.Tensor | None = None   # [nlist, D] fp32
        self.codebooks: torch.Tensor | None = None   # [m, ks, dsub] fp32
        self.opq_R: torch.Tensor | None = None       # [D, D] or None
        cap = PackedListArena.SLOT_ALIGN
        # Codes live transposed ([nlist, m, cap]) so the kernel reads one
        # subspace's codes for consecutive slots as consecutive bytes; the
        # public ``code_arena`` property presents [nlist, cap, m].
        self.code_arena_t = torch.zeros((config.nlist, config.m, cap),
                                        dtype=torch.uint8, device=self.device)
        # ‖c_l + r̂‖² of each decoded point (the kernel's norms input)
        self.code_sq = torch.zeros((config.nlist, cap), dtype=torch.float32,
                                   device=self.device)
        self.raw: PackedListArena | None = (
            PackedListArena.create(
                config.nlist, config.dimension,
                dtype=torch_dtype(config.raw_dtype), device=self.device,
            )
            if config.keep_raw else None
        )
        # Without raw rows the counts and ids live here.
        self._counts = torch.zeros((config.nlist,), dtype=torch.int32,
                                   device=self.device)
        self._ids = np.full((config.nlist, cap), INVALID_ID, np.uint64)
        # (counts tensor, occupied-prefix hint): one max() per counts version
        self._scan_cap_cache = (None, None)
        # search shapes captured as CUDA graphs (key → _SearchGraph, oldest
        # use first) and those searched once, eagerly (see _device_search)
        self._graphs: dict = {}
        self._graph_seen: set = set()
        # Host-store exact rerank (keep_raw=False, the capacity tier): see
        # attach_host_rerank. The device keeps only codes.
        self._host_rr = None
        self.host_rerank_k = 128
        # > 0: per-(query, list) in-kernel shortlist depth instead of the
        # exact emit_full rows (see attach_host_rerank)
        self.host_rerank_k_inner = 0
        self.host_rerank_margin = 0.0
        self.last_rerank_kept = None   # mean candidates kept by the margin

    # ------------------------------------------------------------------ #

    @property
    def capacity(self) -> int:
        return self.code_arena_t.shape[2]

    @property
    def code_arena(self) -> torch.Tensor:
        """[nlist, cap, m] view (storage is transposed, see __init__)."""
        return self.code_arena_t.transpose(1, 2)

    @code_arena.setter
    def code_arena(self, value) -> None:
        self.code_arena_t = torch.as_tensor(value).to(
            self.device).transpose(1, 2).contiguous()
        self._refresh_code_sq()

    def _refresh_code_sq(self) -> None:
        """Recompute the decoded-point norms of the whole arena (needs
        codebooks and centroids). Chunked over lists so the decoded fp32
        intermediate stays near 128 MB."""
        if self.codebooks is None or self.centroids is None:
            return
        nlist, m, cap = self.code_arena_t.shape
        dim = self.config.dimension
        step = max(1, (128 << 20) // max(cap * dim * 4, 1))
        out = []
        for s in range(0, nlist, step):
            block = self.code_arena_t[s:s + step]               # [S, m, cap]
            codes = block.transpose(1, 2).reshape(-1, m)
            deq = pq_decode(codes, self.codebooks).reshape(
                block.shape[0], cap, dim) + self.centroids[s:s + step, None]
            out.append((deq * deq).sum(-1))
        self.code_sq = torch.cat(out)

    @property
    def counts(self) -> torch.Tensor:
        return self.raw.counts if self.raw is not None else self._counts

    @property
    def ids(self) -> np.ndarray:
        return self.raw.ids if self.raw is not None else self._ids

    @property
    def ntotal(self) -> int:
        return int(self.counts.sum().item())

    def _scan_capacity_hint(self) -> int | None:
        """Occupied-prefix bound for the ADC kernel: max(counts) rounded to
        the slot tile, None when the arena is filled to capacity. Cached
        per counts tensor, so the device sync runs once per ingest."""
        c = self.counts
        cached_for, val = self._scan_cap_cache
        if cached_for is not c:
            mx = int(c.max().item()) if c.shape[0] else 0
            align = PackedListArena.SLOT_ALIGN
            occ = -(-max(mx, 1) // align) * align
            val = occ if occ < self.capacity else None
            self._scan_cap_cache = (c, val)
        return val

    # ------------------------------------------------------------------ #
    # build
    # ------------------------------------------------------------------ #

    def train(self, vectors: np.ndarray) -> None:
        """Coarse k-means on a host subsample of ``train_sample_per_list ·
        nlist`` rows, then residual PQ codebooks (and with ``config.opq``
        an OPQ rotation) on up to ``pq_train_sample`` of them."""
        cfg = self.config
        vectors = np.ascontiguousarray(vectors, np.float32)
        n = vectors.shape[0]
        if n < cfg.nlist:
            raise ValueError(f"need ≥ nlist={cfg.nlist} training vectors")
        rng = np.random.default_rng(cfg.seed)
        cap = cfg.train_sample_per_list * cfg.nlist
        sample = vectors if n <= cap else vectors[
            rng.choice(n, cap, replace=False)
        ]
        sample_d = self._to_device(sample)
        if self.metric == Metric.COSINE:
            sample_d = l2_normalize(sample_d)
        gen = self._generator()
        self.centroids, assign = kmeans_fit(
            sample_d, cfg.nlist, iters=cfg.train_iters, generator=gen
        )
        nsub = min(sample.shape[0], cfg.pq_train_sample)
        sub = torch.from_numpy(
            rng.choice(sample.shape[0], nsub, replace=False)
        ).to(self.device)
        self._train_pq(gen, sample_d[sub] - self.centroids[assign[sub].long()])
        self.trained = True

    def train_from_device(self, x_dev: torch.Tensor) -> None:
        """Train from a device-resident corpus (subsampled on the device
        before the fp32 cast, so a bf16 corpus is never copied whole)."""
        cfg = self.config
        sample, gen = self._device_sample(x_dev)
        self.centroids, assign = kmeans_fit(
            sample, cfg.nlist, iters=cfg.train_iters, generator=gen
        )
        nsamp = sample.shape[0]
        nsub = min(nsamp, cfg.pq_train_sample)
        sub = torch.randperm(nsamp, generator=gen, device=self.device)[:nsub]
        self._train_pq(gen, sample[sub] - self.centroids[assign[sub].long()])
        self.trained = True

    def _train_pq(self, gen: torch.Generator, residuals: torch.Tensor) -> None:
        """PQ codebooks from a residual sample; with ``config.opq`` also an
        OPQ rotation, after which the centroids (and, through :meth:`_rot`,
        ingest and queries) live in the rotated basis. Rotation is an
        isometry: distances are unchanged, only the subspace split moves."""
        cfg = self.config
        if cfg.opq:
            self.opq_R, self.codebooks = opq_fit(
                residuals, cfg.m, cfg.ks, iters=cfg.train_iters,
                opq_iters=cfg.opq_iters, generator=gen,
            )
            self.centroids = _mm(self.centroids, self.opq_R)
        else:
            self.codebooks = train_product_quantizer(
                residuals, cfg.m, cfg.ks, iters=cfg.train_iters,
                generator=gen,
            )

    def _rot(self, x: torch.Tensor) -> torch.Tensor:
        """Change of basis into the OPQ frame (no-op without OPQ)."""
        return x if self.opq_R is None else _mm(x.float(), self.opq_R)

    def add(self, vectors: np.ndarray, ids: np.ndarray | None = None) -> None:
        """Assign → residual-encode → write codes (and raw rows)."""
        if not self.trained:
            raise RuntimeError("index must be trained before add()")
        self._guard_host_rerank_mutation()
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.shape[0] == 0:
            return
        self._add_device(self._to_device(vectors), ids)

    def add_from_device(
        self, x_dev: torch.Tensor, ids: np.ndarray | None = None
    ) -> None:
        """:meth:`add` for a device-resident batch (no host round trip)."""
        if not self.trained:
            raise RuntimeError("index must be trained before add()")
        self._guard_host_rerank_mutation()
        if x_dev.shape[0] == 0:
            return
        self._add_device(x_dev.to(self.device).float(), ids)

    def build_from_device(
        self, x_dev: torch.Tensor, ids: np.ndarray | None = None
    ) -> None:
        """One-shot bulk build of an empty trained index from a
        device-resident corpus, placed as ``IVFFlatIndex.build_from_device``
        places its rows: each row ranked against its
        :data:`BULK_ASSIGN_CHOICES` nearest lists, the capacity clamped
        near the p99 list size and at least 1.5× the mean
        (``_choose_capacity``), a row past a full list placed in its next
        nearest (``_balance_assignments``). The arenas are sized once, then
        every :data:`BUILD_SLICE_ROWS` rows are encoded and written as one
        add, so a bf16 corpus is never widened to fp32 whole (10M × 768
        would be 31 GB)."""
        if not self.trained:
            raise RuntimeError("index must be trained before build")
        if self.ntotal:
            raise ValueError("build_from_device builds an empty index; "
                             "add_from_device adds to a filled one")
        self._guard_host_rerank_mutation()
        n = x_dev.shape[0]
        if n == 0:
            return
        ids = (np.arange(n, dtype=np.uint64) if ids is None
               else np.asarray(ids))
        step = self.BUILD_SLICE_ROWS

        def rows(s0):
            x = x_dev[s0:s0 + step].to(self.device).float()
            return l2_normalize(x) if self.metric == Metric.COSINE else x

        nlist = self.config.nlist
        choices = torch.cat([
            kmeans_assign_topk(self._rot(rows(s0)), self.centroids,
                               BULK_ASSIGN_CHOICES, self._assign_metric())
            for s0 in range(0, n, step)]).cpu().numpy()
        cap = _choose_capacity(
            np.bincount(choices[:, 0], minlength=nlist),
            PackedListArena.SLOT_ALIGN)
        assignments = _balance_assignments(choices, cap, nlist)
        self.reserve(cap)
        for s0 in range(0, n, step):
            x = rows(s0)
            self._ingest(self._rot(x), ids[s0:s0 + step],
                         assignments[s0:s0 + step], vec_orig=x)

    def _add_device(self, x: torch.Tensor, ids) -> None:
        n = x.shape[0]
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + n, dtype=np.uint64)
        if self.metric == Metric.COSINE:
            x = l2_normalize(x)
        x_rot = self._rot(x)
        assignments = kmeans_assign(
            x_rot, self.centroids, self._assign_metric()
        ).cpu().numpy()
        self._ingest(x_rot, ids, assignments, vec_orig=x)

    def _ingest(self, vec_d, ids, assignments: np.ndarray,
                vec_orig) -> None:
        """Encode + write. ``vec_d`` is in the index's (possibly rotated)
        frame for the codes; ``vec_orig`` is the original-frame copy the
        raw rerank arena stores. The grow → slot plan → write → publish
        sequence holds the mutation lock."""
        cfg = self.config
        a_d = torch.from_numpy(assignments.astype(np.int64)).to(self.device)
        cen = self.centroids[a_d]
        codes = pq_encode(vec_d - cen, self.codebooks)
        deq = pq_decode(codes, self.codebooks) + cen
        sq_rows = (deq * deq).sum(-1)
        del cen, deq
        with self._mutate_lock:
            counts_h = self.counts.cpu().numpy().astype(np.int64)
            per_list = np.bincount(assignments, minlength=cfg.nlist)
            max_needed = int((counts_h + per_list).max())
            if max_needed > self.capacity:
                align = PackedListArena.SLOT_ALIGN
                new_cap = max(max_needed, int(self.capacity * 1.5))
                self._grow(-(-new_cap // align) * align)
            slots = compute_append_slots(counts_h, assignments)
            s_d = torch.from_numpy(slots).to(self.device)
            self.code_arena_t[a_d, :, s_d] = codes
            self.code_sq[a_d, s_d] = sq_rows
            if self.raw is not None:
                self.raw = self.raw.append(vec_orig, np.asarray(ids),
                                           assignments)
            else:
                new_ids = self._ids.copy()      # copy-on-write for readers
                new_ids[assignments, slots] = np.asarray(ids, np.uint64)
                self._ids = new_ids
                self._counts = torch.from_numpy(
                    (counts_h + per_list).astype(np.int32)
                ).to(self.device)

    def reserve(self, capacity: int) -> None:
        """Pre-size the arenas for a bulk build: one allocation instead of
        repeated 1.5× growth steps (each holds old and new arenas)."""
        align = PackedListArena.SLOT_ALIGN
        cap = -(-capacity // align) * align
        if cap > self.capacity:
            with self._mutate_lock:
                if cap > self.capacity:
                    self._grow(cap)

    def _grow(self, new_cap: int) -> None:
        """New, larger code and raw arenas (same capacity for both, or
        positions would map to the wrong ids); old handles stay valid."""
        cap = self.capacity
        codes = self.code_arena_t.new_zeros(
            self.code_arena_t.shape[:2] + (new_cap,))
        codes[:, :, :cap] = self.code_arena_t
        code_sq = self.code_sq.new_zeros((self.code_sq.shape[0], new_cap))
        code_sq[:, :cap] = self.code_sq
        self.code_arena_t, self.code_sq = codes, code_sq
        if self.raw is None:
            ids = np.full((self.config.nlist, new_cap), INVALID_ID, np.uint64)
            ids[:, : self._ids.shape[1]] = self._ids
            self._ids = ids
        elif self.raw.capacity < new_cap:
            self.raw = self.raw.grow(new_cap)

    def remove_ids(self, ids: np.ndarray) -> int:
        """Delete vectors by user id; returns how many were removed
        (unknown ids are ignored). One swap-from-tail plan
        (``models/arena.plan_removals``) drives every plane: the
        transposed codes and ``code_sq`` move here, and the raw arena
        (``keep_raw``) replays the same deterministic plan inside
        ``PackedListArena.remove``, so code and raw slots stay aligned."""
        ids = np.unique(np.asarray(ids, np.uint64))
        ids = ids[ids != INVALID_ID]
        if ids.size == 0 or self.ntotal == 0:
            return 0
        with self._mutate_lock:
            lists, slots = np.nonzero(np.isin(self.ids, ids))
            if lists.size == 0:
                return 0
            counts_h = self.counts.cpu().numpy().astype(np.int64)
            move_l, src_s, dst_s, new_counts = plan_removals(
                counts_h, lists.astype(np.int64), slots.astype(np.int64)
            )
            n_removed = int((counts_h - new_counts).sum())
            if n_removed == 0:
                return 0
            if move_l.size:
                dev = self.device
                ml = torch.from_numpy(move_l).to(dev)
                src = torch.from_numpy(src_s).to(dev)
                dst = torch.from_numpy(dst_s).to(dev)
                # codes are [nlist, m, cap]: move the (list, :, slot) columns
                self.code_arena_t[ml, :, dst] = self.code_arena_t[ml, :, src]
                _remove_device((self.code_sq.view(-1),),
                               ml * self.capacity + src,
                               ml * self.capacity + dst)
            if self.raw is not None:
                self.raw, _ = self.raw.remove(lists, slots)
            else:
                self._ids = apply_removal_to_ids(
                    self._ids, move_l, src_s, dst_s, new_counts, counts_h
                )
                self._counts = torch.from_numpy(
                    new_counts.astype(np.int32)).to(self.device)
        return n_removed

    # ------------------------------------------------------------------ #
    # search
    # ------------------------------------------------------------------ #

    def _enqueue(self, q_dev, queries, params, nprobe):
        """The device half of a search and its snapshot; ``use_exact_rerank``
        reranks the top :func:`rerank_depth` ADC candidates exactly where
        raw rows are kept, and on the host from an attached store where
        they are not (the device then returns a top-``host_rerank_k`` ADC
        shortlist)."""
        host_rr = (params.use_exact_rerank and self.raw is None
                   and self._host_rr is not None)
        k_dev = params.k
        if host_rr:
            k_dev = min(max(self.host_rerank_k, params.k),
                        self.capacity * nprobe)
        raw = self.raw
        scan_cap = self._scan_capacity_hint()
        rerank_k = 0
        if params.use_exact_rerank and raw is not None:
            rerank_k = rerank_depth(self.config.rerank_k, params.k,
                                    nprobe * (scan_cap or self.capacity))
        stats = {} if rerank_k else None
        d, pos = self._device_search(
            q_dev, raw, nprobe, k_dev, rerank_k,
            self.host_rerank_k_inner if host_rr else 0, scan_cap, stats)
        post = None
        if stats:
            if d.is_cuda:
                # the row count comes back in the stream's order, so the
                # post-step reads it after the search's one wait
                rows = torch.empty((), dtype=torch.int64, pin_memory=True)
                stats["rows"] = rows.copy_(stats["rows"], non_blocking=True)
            post = functools.partial(_rerank_readings, stats)
        elif host_rr:
            post = functools.partial(self._host_rerank, queries, params)
        return d, pos, self.ids, post

    def _device_search(self, q, raw, nprobe, k, rerank_k, k_inner, scan_cap,
                       stats):
        """The device half of a search (:func:`_ivf_pq_search_device`),
        replayed from a :class:`_SearchGraph` where :meth:`_search_graph`
        gives one."""
        raws = ((raw.arena, raw.arena_sq, raw.arena_scale, raw.anchors)
                if raw is not None else (None,) * 4)
        scan_impl = _resolve_scan_impl(self.config.scan_impl, q.is_cuda)
        tensors = (self.centroids, self.codebooks, self.code_arena_t,
                   self.code_sq, self.counts)
        _check_raw_capacity(raws[0], self.code_arena_t, rerank_k)
        graph = None
        if self._graphable(q) and not k_inner:
            graph = self._search_graph(q, tensors, raws, nprobe, k, rerank_k,
                                       scan_impl, scan_cap)
        if graph is None:
            return _ivf_pq_search_device(
                q, *tensors, *raws, nprobe, k, self.metric, rerank_k,
                scan_impl, opq_R=self.opq_R, k_inner=k_inner,
                scan_capacity=scan_cap, heat=self._heat, rerank_stats=stats)
        return graph.run(q, self._heat, stats,
                         rerank_k > 0 and raw is not None)

    def _graphable(self, q) -> bool:
        return (self.graph_searches and q.is_cuda
                and q.shape[0] <= BUCKETS[-1])

    def _search_graph(self, q, tensors, raws, nprobe, k, rerank_k, scan_impl,
                      scan_cap):
        """The :class:`_SearchGraph` of this search's shape (its batch
        bucket, depths, scan width and the index's tensors, by address),
        or None the first time the shape is searched, which runs eagerly;
        the second captures it. A mutation that publishes new tensors
        makes a new shape."""
        rows = bucket_size(q.shape[0])
        key = (rows, nprobe, k, rerank_k, scan_cap, scan_impl) + tuple(
            None if t is None else (t.data_ptr(), tuple(t.shape), t.dtype)
            for t in (*tensors, *raws, self.opq_R))
        graph = self._graphs.pop(key, None)
        if graph is None:
            if key not in self._graph_seen:
                if len(self._graph_seen) >= 8 * self.GRAPH_SHAPES:
                    self._graph_seen.clear()
                self._graph_seen.add(key)
                return None
            self._graph_seen.discard(key)
            opq_R, metric = self.opq_R, self.metric
            graph = _SearchGraph(
                rows, q.shape[1], q.device,
                lambda qs: _ivf_pq_shortlist(
                    qs, *tensors, nprobe, max(k, rerank_k), metric,
                    scan_impl, opq_R, 0, scan_cap),
                lambda short: _ivf_pq_finish(short, *raws, k, metric,
                                             rerank_k))
            while len(self._graphs) >= self.GRAPH_SHAPES:
                self._graphs.pop(next(iter(self._graphs)))
        self._graphs[key] = graph          # the newest use last
        return graph

    def _host_rerank(self, queries, params, d, ids, waits, counts):
        """The post-step of a search reranked from the attached host
        store: the exact top-k of the ADC shortlist ``(d, ids)``."""
        with trace("ivf_pq.host_rerank"):
            q_rr = queries
            if self.metric == Metric.COSINE:
                nrm = np.linalg.norm(q_rr, axis=1, keepdims=True)
                q_rr = q_rr / np.maximum(nrm, 1e-12)
            if self.host_rerank_margin > 0 and d.shape[1] > params.k:
                # Adaptive depth: a candidate whose ADC distance exceeds
                # the query's k-th by more than margin × |k-th| cannot
                # plausibly enter the exact top-k; its id becomes
                # INVALID_ID, which the host stage skips.
                dk = d[:, params.k - 1: params.k]
                keep = d <= dk + self.host_rerank_margin * np.abs(dk)
                self.last_rerank_kept = float(keep.sum(1).mean())
                ids = np.where(keep, ids, INVALID_ID)
            return self._host_rr.rerank(q_rr, ids, self.metric, params.k)

    def search_batches_pipelined(
        self, batches, params: SearchParams | None = None
    ):
        """Dispatch batch i+1 before finalizing batch i, so the device scan
        of one batch overlaps the host stage of the previous. Yields
        ``(dists, ids)`` per input batch, in order."""
        pending = None
        for q in batches:
            nxt = self.search_async(q, params)
            if pending is not None:
                yield pending()
            pending = nxt
        if pending is not None:
            yield pending()

    # ------------------------------------------------------------------ #
    # residency surface (parity with IVFFlatIndex)
    # ------------------------------------------------------------------ #

    def _warmup_params(self) -> tuple:
        # the exact rerank is another device call (a deeper shortlist):
        # warm it too where there is one (raw rows or a host store)
        if self.raw is None and self._host_rr is None:
            return (SearchParams(),)
        return (SearchParams(), SearchParams(use_exact_rerank=True))

    def _guard_host_rerank_mutation(self) -> None:
        """Rows the host store lacks would be dropped by the exact rerank
        (an unknown id maps to no row): no adds while a store is attached.
        Removal stays allowed, as in the JAX package: a removed id never
        reaches the host stage."""
        if self._host_rr is not None:
            raise RuntimeError(
                "index is serving with an attached host-rerank store "
                "(read-only); rebuild the epoch to add vectors"
            )

    def attach_host_rerank(self, store, rerank_k: int = 128,
                           k_inner: int = 0, margin: float = 0.0) -> None:
        """Exact rerank from a host-RAM :class:`HostListStore` (or a built
        :class:`HostReranker`) for a ``keep_raw=False`` index: afterwards a
        ``use_exact_rerank`` search takes a top-``rerank_k`` ADC shortlist
        from the device and reranks it on the host.

        ``k_inner=0`` serves the shortlist through the exact emit_full scan
        (full distance rows and one top-``rerank_k``); > 0 selects the
        kernel's per-list truncation. ``margin > 0`` reranks only the
        candidates whose ADC distance lies within ``(1 + margin)`` of the
        query's k-th (``last_rerank_kept`` records the mean kept)."""
        from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.host_rerank \
            import HostReranker

        if self.raw is not None:
            raise ValueError(
                "host rerank is the keep_raw=False path; a resident raw "
                "arena already reranks on the device"
            )
        self._host_rr = (
            store if isinstance(store, HostReranker) else HostReranker(store)
        )
        self.host_rerank_k = int(rerank_k)
        self.host_rerank_k_inner = int(k_inner)
        self.host_rerank_margin = float(margin)

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #

    def state_arrays(self) -> dict:
        """Host arrays of the index (raw rows dequantized to fp32)."""
        out = {
            "centroids": self.centroids.cpu().numpy(),
            "codebooks": self.codebooks.cpu().numpy(),
            "codes": self.code_arena.contiguous().cpu().numpy(),
            "counts": self.counts.cpu().numpy(),
            "ids": self.ids,
        }
        if self.opq_R is not None:
            out["opq_R"] = self.opq_R.cpu().numpy()
        if self.raw is not None:
            out["arena"] = self.raw.to_host()["arena"]
        return out

    def calibrate_nprobe(
        self,
        queries: np.ndarray | None = None,
        target_coverage: float = 0.99,
        k: int = 10,
        candidates: tuple = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128),
        sample: int = 512,
        seed: int = 0,
    ) -> dict:
        """Measured-coverage nprobe calibration (``models/calibrate.py``).
        The ground truth is the full-probe search on the index's stored
        representation, with the exact rerank when raw rows are kept.
        Under OPQ the coarse ranking happens in the rotated frame. Sets
        ``self.calibrated_nprobe`` (used by ``SearchParams(nprobe=0)``)."""
        if not self.trained:
            raise RuntimeError("index must be trained before calibration")
        from cuda_acceleratedvectordatabaseengine_tpu_torch.models.calibrate \
            import probe_coverage_calibrate, sample_stored_rows

        if queries is None:
            if self.raw is None:
                raise ValueError(
                    "keep_raw=False index has no stored rows to sample; "
                    "pass held-out queries"
                )
            # raw rows live in the original frame: usable as queries as is
            queries = sample_stored_rows(self.raw, sample, seed)
        result = probe_coverage_calibrate(
            centroids=self.centroids,
            metric=self.metric,
            ids_table=self.ids,
            queries=queries,
            exact_search_fn=lambda q, kk: self.search(
                q, SearchParams(nprobe=self.config.nlist, k=kk,
                                use_exact_rerank=self.raw is not None)
            ),
            target_coverage=target_coverage,
            k=k,
            candidates=candidates,
            query_transform=self._rot if self.opq_R is not None else None,
        )
        self.calibrated_nprobe = result["nprobe"]
        return result

    def save(self, path: str) -> None:
        """Write a snapshot directory (``storage/snapshot.save_ivf_pq``)
        under the mutation lock: one consistent state."""
        from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.snapshot \
            import save_ivf_pq

        with self._mutate_lock:
            save_ivf_pq(path, self)

    @classmethod
    def load(cls, path: str,
             device: torch.device | str | None = "cuda") -> "IVFPQIndex":
        """Read a snapshot written by either package onto ``device``."""
        from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.snapshot \
            import load_ivf_pq

        return load_ivf_pq(path, device=device)

    def memory_stats(self) -> dict:
        """Device-memory accounting of the index (bytes)."""
        code_bytes = self.code_arena_t.numel()
        raw_bytes = self.raw.nbytes_device() if self.raw is not None else 0
        cb_bytes = 0 if self.codebooks is None else self.codebooks.numel() * 4
        cent_bytes = (0 if self.centroids is None
                      else self.centroids.numel() * 4)
        return {
            "code_bytes": code_bytes,
            "raw_bytes": raw_bytes,
            "total_bytes": code_bytes + raw_bytes + cb_bytes + cent_bytes,
            "total_vectors": self.ntotal,
            "nlist": self.config.nlist,
            "capacity_per_list": self.capacity,
        }
