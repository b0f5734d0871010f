"""Sorted full-row scan: the port of the TPU kernel K3.

Counterpart of ``scan_probed_lists_pallas_sorted`` in
``cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py``. Every
(query, probe) pair gets a full distance row over the list's scanned slot
prefix (``[B·P, cap_s]`` fp32, +inf for empty slots and ``-1`` probes), and
the top-k is taken outside the kernel, as the TPU version left it to XLA.
Unlike K1 (``ops/grouped_scan.py``) there is no per-(query, list) depth
cap, so this scan answers any ``k``.

The pairs are sorted by list and packed into list-rows of up to M
same-list pairs (K1's packing); one kernel step per list-row writes the
rows of its pairs straight to their ``(b, p)`` places. Two implementations
of the step sit side by side:

- :func:`_sorted_rows_cuda` launches the hand-written Hopper kernel in
  ``csrc/full_row_scan.cu`` and adds one to :data:`LAUNCHES` per launch;
  it passes the query's three bf16 planes
  (``grouped_scan.split_query_bf16x3``), which the kernel multiplies with
  the stored values on the tensor cores (exact products, fp32 sums; an
  fp32 arena's values are split the same way inside the kernel);
- :func:`_sorted_rows_reference` is the plain PyTorch version.

:func:`scan_probed_lists_sorted` takes the plain version for CPU tensors and
the kernel for CUDA tensors (it raises rather than fall back);
:func:`scan_probed_lists_sorted_reference` always takes the plain version.
The ``[B, P·cap_s]`` row transient is bounded by running the probe axis in
chunks under :data:`FULL_ROW_BYTES` and merging the chunks' top-k, which is
exact because probe chunks are disjoint lists. Packing with the kernel runs
in the ``torch.profiler`` range ``sorted_scan.rows``, the top-k in
``sorted_scan.topk``.
"""

from __future__ import annotations

import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.grouped_scan import (
    _DTYPE_IDS,
    _METRIC_IDS,
    _REFERENCE_CHUNK_BYTES,
    _effective_cap,
    _local_counts,
    _n_rows_bound,
    _pack_pairs_into_rows,
    auto_m_budget,
    check_list_row_args,
    query_planes,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import merge_topk
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.profiling import (
    trace,
)

# Kernel launches made by _sorted_rows_cuda since the process started (or
# since a caller last reset it): lets a run show it went through the kernel.
LAUNCHES = 0

# Bound on the fp32 full-row transient [B, P_chunk, cap_s] of one probe chunk
# (bytes). B 1024, cap 1408 fits 46 probes a chunk.
FULL_ROW_BYTES = 1 << 28


def probe_chunk(batch: int, nprobe: int, cap_s: int) -> int:
    """Probes per chunk so that one chunk's rows fit ``FULL_ROW_BYTES``."""
    return max(1, min(nprobe, FULL_ROW_BYTES // max(batch * cap_s * 4, 1)))


def full_row_topk(rows, probe_ids, k, cap_s, global_cap, slot_stride,
                  slot_offset):
    """Top-k over full rows ``[B·P, cap_s]`` in ``(b, p)`` order: ``(dists
    [B, k] ascending, pos [B, k] int32)``. A column's position is its list
    times ``global_cap`` plus its logical slot (``slot · stride + offset``);
    rows mark invalid slots +inf, which map to -1. Fewer than k columns pad
    with (+inf, -1)."""
    batch, nprobe = probe_ids.shape
    d = rows.reshape(batch, nprobe * cap_s)
    kk = min(k, d.shape[1])
    vals, cols = torch.topk(d, kk, dim=-1, largest=False, sorted=True)
    lists = torch.gather(probe_ids.long(), 1, cols // cap_s)
    pos = lists * global_cap + (cols % cap_s) * slot_stride + slot_offset
    pos = torch.where(torch.isfinite(vals), pos, -1).int()
    if kk < k:
        vals = torch.cat([vals, vals.new_full((batch, k - kk), float("inf"))],
                         1)
        pos = torch.cat([pos, pos.new_full((batch, k - kk), -1)], 1)
    return vals, pos


def scan_full_rows(rows_fn, probe_ids, k, cap_s, global_cap, slot_stride,
                   slot_offset, range_name):
    """Run ``rows_fn(probe_chunk) -> [B·Pc, cap_s]`` over probe chunks under
    :data:`FULL_ROW_BYTES` and merge their top-k (exact: the chunks scan
    disjoint lists)."""
    batch, nprobe = probe_ids.shape
    step = probe_chunk(batch, nprobe, cap_s)
    best = None
    for p0 in range(0, nprobe, step):
        probe = probe_ids[:, p0:p0 + step].contiguous()
        with trace(f"{range_name}.rows"):
            rows = rows_fn(probe)
        with trace(f"{range_name}.topk"):
            part = full_row_topk(rows, probe, k, cap_s, global_cap,
                                 slot_stride, slot_offset)
            best = part if best is None else merge_topk(*best, *part, k)
    return best


def _sorted_rows_reference(q, arena, arena_sq, counts, row_list, pair_table,
                           nprobe, n_pairs, metric, cap_s, arena_scale=None,
                           arena_anchors=None):
    """Plain PyTorch version of the kernel: rows ``[n_pairs, cap_s]``, row
    ``b·nprobe + p`` holding the distances of query b to the first ``cap_s``
    slots of its probed list, +inf for slots at or past the list's
    ``counts`` and for pairs in sentinel rows (probe -1). Works in list-row
    chunks to bound the fp32 block transient."""
    n_rows, m = pair_table.shape
    nlist, _, dim = arena.shape
    dev = q.device
    out = torch.full((n_pairs, cap_s), float("inf"), device=dev)
    chunk = max(1, _REFERENCE_CHUNK_BYTES // (4 * cap_s * dim))
    slot = torch.arange(cap_s, device=dev)
    for r0 in range(0, n_rows, chunk):
        rl = row_list[r0:r0 + chunk].long()
        pi = pair_table[r0:r0 + chunk].long()
        live_row = (rl >= 0) & (rl < nlist)
        lists = rl.clamp(0, nlist - 1)
        qr = q[torch.where(pi >= 0, pi // nprobe, 0)]              # [R, m, D]
        blocks = arena[lists, :cap_s].float()                      # [R, c, D]
        qx = torch.bmm(qr, blocks.transpose(1, 2))                 # [R, m, c]
        if arena_scale is not None:
            qx = qx * arena_scale[lists, :cap_s][:, None, :]
        if arena_anchors is not None:
            qx = qx + (qr * arena_anchors[lists][:, None, :]).sum(
                -1, keepdim=True)
        if metric == Metric.L2:
            q_sq = (qr * qr).sum(-1, keepdim=True)
            d = (q_sq - 2.0 * qx + arena_sq[lists, :cap_s][:, None, :])
            d = d.clamp_min(0.0)
        elif metric == Metric.INNER_PRODUCT:
            d = -qx
        else:
            d = 1.0 - qx
        valid = (
            (slot[None, :] < counts[lists].long()[:, None])[:, None, :]
            & live_row[:, None, None]
        )
        d = torch.where(valid, d, float("inf"))
        listed = pi >= 0
        out[pi[listed]] = d[listed]
    return out


def kernel_max_m(dim: int, arena_dtype: torch.dtype) -> int:
    """Widest list-row the CUDA kernel takes at this dimension and arena
    dtype: 64 on int8, bf16 and fp32 arenas (tensor cores, D staged in
    chunks). Builds the kernel library if needed."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops._build import (
        load_library,
    )

    if arena_dtype not in _DTYPE_IDS:
        raise ValueError(f"the kernel takes no {arena_dtype} arena")
    return int(load_library().vdb_sorted_scan_max_m(
        int(dim), _DTYPE_IDS[arena_dtype]
    ))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sorted-scan kernel: {msg}")


def _sorted_rows_cuda(q, arena, arena_sq, counts, row_list, pair_table,
                      nprobe, n_pairs, metric, cap_s, arena_scale=None,
                      arena_anchors=None):
    """Launch the hand-written kernel (same contract as
    :func:`_sorted_rows_reference`) on the current CUDA stream. Checks
    device, dtype, shape and contiguity and raises on anything the kernel
    does not take; raises if the launch is refused."""
    global LAUNCHES
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops._build import (
        load_library,
    )

    _check(arena.dim() == 3, "arena must be [nlist, cap, D]")
    check_list_row_args(_check, q, arena, arena_sq, counts, row_list,
                        pair_table, cap_s, metric,
                        kernel_max_m(arena.shape[2], arena.dtype),
                        arena_scale, arena_anchors)
    _check(q.shape[0] * nprobe == n_pairs,
           f"q holds {q.shape[0]} queries, not n_pairs / nprobe")
    dev = arena.device
    nlist, cap, dim = arena.shape
    n_rows, m = pair_table.shape

    out = torch.empty((n_pairs, cap_s), dtype=torch.float32, device=dev)
    planes = query_planes(q, arena.dtype)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = load_library().vdb_sorted_scan(
            ptr(q), ptr(planes), ptr(arena), ptr(arena_sq), ptr(arena_scale),
            ptr(arena_anchors), ptr(counts), ptr(row_list), ptr(pair_table),
            ptr(out), n_rows, q.shape[0], m, dim, nlist, cap, cap_s, nprobe,
            _METRIC_IDS[metric], _DTYPE_IDS[arena.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"sorted-scan kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _pair_table(probe_ids: torch.Tensor, nlist: int, m: int):
    """Sort the pairs by list and pack them into list-rows: ``(row_list
    [n_rows] int32, pair_table [n_rows, m] int32)``, each entry the pair's
    flat index ``b·P + p`` (-1 = empty). Pairs of probe -1 land in sentinel
    rows (list id ``nlist``)."""
    n_pairs = probe_ids.numel()
    pack = _pack_pairs_into_rows(probe_ids, nlist, m,
                                 _n_rows_bound(n_pairs, nlist, m))
    table = torch.full_like(pack.qrow_table, -1)
    table[pack.row_of_pair, pack.m_of_pair] = pack.order.int()
    return pack.row_list, table


def _scan_sorted(rows_fn, queries, arena, arena_sq, counts, probe_ids, k,
                 metric, m_budget, arena_scale, arena_anchors, slot_stride,
                 slot_offset, global_capacity, scan_capacity, m_limit=None):
    batch, _ = probe_ids.shape
    nlist, cap, _ = arena.shape
    global_cap = global_capacity if global_capacity is not None else cap
    cap_s = _effective_cap(cap, scan_capacity)
    kernel_counts = _local_counts(counts, cap, slot_stride, slot_offset)
    q = queries.float().contiguous()
    anchors = (arena_anchors.float().contiguous()
               if arena_anchors is not None else None)

    def rows(probe):
        n_pairs = probe.numel()
        m = m_budget or auto_m_budget(n_pairs, nlist)
        if m_limit is not None:
            m = min(m, m_limit)
        row_list, table = _pair_table(probe, nlist, m)
        return rows_fn(q, arena, arena_sq, kernel_counts, row_list, table,
                       probe.shape[1], n_pairs, metric, cap_s,
                       arena_scale=arena_scale, arena_anchors=anchors)

    return scan_full_rows(rows, probe_ids, k, cap_s, global_cap, slot_stride,
                          slot_offset, "sorted_scan")


def scan_probed_lists_sorted(
    queries: torch.Tensor,
    arena: torch.Tensor,
    arena_sq: torch.Tensor,
    counts: torch.Tensor,
    probe_ids: torch.Tensor,
    k: int,
    metric: Metric = Metric.L2,
    m_budget: int | None = None,
    arena_scale: torch.Tensor | None = None,
    arena_anchors: torch.Tensor | None = None,
    slot_stride: int = 1,
    slot_offset: int = 0,
    global_capacity: int | None = None,
    scan_capacity: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted full-row scan of each query's probed lists; returns ``(dists
    [B, k] ascending, pos [B, k] int32 global positions, -1 for empty)``,
    the contract of ``ops/scan.scan_probed_lists``, for any ``k``.

    On CUDA tensors the row step is the hand-written kernel (list-row width
    clamped to what its shared memory holds); on CPU tensors it is the
    plain version. ``m_budget`` is the list-row width (None =
    ``auto_m_budget``); ``scan_capacity`` bounds the scanned slot prefix
    (exact while ≥ max(counts)); the striping arguments are those of
    ``scan_probed_lists``.
    """
    if arena.is_cuda:
        rows_fn = _sorted_rows_cuda
        m_limit = kernel_max_m(arena.shape[-1], arena.dtype)
    else:
        rows_fn, m_limit = _sorted_rows_reference, None
    return _scan_sorted(
        rows_fn, queries, arena, arena_sq, counts, probe_ids, k, metric,
        m_budget, arena_scale, arena_anchors, slot_stride, slot_offset,
        global_capacity, scan_capacity, m_limit,
    )


def scan_probed_lists_sorted_reference(
    queries: torch.Tensor,
    arena: torch.Tensor,
    arena_sq: torch.Tensor,
    counts: torch.Tensor,
    probe_ids: torch.Tensor,
    k: int,
    metric: Metric = Metric.L2,
    m_budget: int | None = None,
    arena_scale: torch.Tensor | None = None,
    arena_anchors: torch.Tensor | None = None,
    slot_stride: int = 1,
    slot_offset: int = 0,
    global_capacity: int | None = None,
    scan_capacity: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`scan_probed_lists_sorted` with the plain PyTorch row step on
    any device (no kernel, no launch count)."""
    return _scan_sorted(
        _sorted_rows_reference, queries, arena, arena_sq, counts, probe_ids,
        k, metric, m_budget, arena_scale, arena_anchors, slot_stride,
        slot_offset, global_capacity, scan_capacity,
    )
