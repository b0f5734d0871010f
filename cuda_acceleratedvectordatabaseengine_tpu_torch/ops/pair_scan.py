"""Pair full-row scan: the port of the TPU kernel K4.

Counterpart of ``scan_probed_lists_pallas`` in
``cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py``. Every
(query, probe) pair gets a full distance row over the list's scanned slot
prefix (``[B·P, cap_s]`` fp32, +inf for empty slots and ``-1`` probes),
and the top-k is taken outside the kernel. Unlike K1 and K3, the rows come
from the stored block alone: each slot's norm is recomputed from the
stored values (``arena_sq`` is accepted and ignored, as the TPU kernel
``del``-ed it), and there is no per-row scale and no anchor, so an int8
arena is scanned as raw code values.

The TPU grid had one step per pair, each reading its list's block again.
On Hopper that re-reading is what bounds a pair-per-CTA kernel (L2
bandwidth: handed the pairs out of list order it took twice as long; on
fp32 arenas the CUDA-core pair-per-CTA kernel of the first versions took
9.8× its bound), so the pairs are sorted by list and packed into list-rows
of up to M same-list pairs, K3's packing (``ops/sorted_scan._pair_table``),
and one CTA reads the list once for all pairs of its row, on every arena
dtype. The kernel is K3's tensor-core kernel (``csrc/full_row_scan.cu`` on
``csrc/tc_scan.cuh``: three exact bf16 query planes, and on fp32 arenas
three planes of each value split in registers, six products; ``cp.async``
ring, ``mma.sync``) in its block-norm variant, which forms each slot's
``|x|²`` once per tile from the values it stages anyway: int8 exactly in
int32, bf16 as fp32 sums of exact products, fp32 from the fp32 values
(not their hi plane) as an fp32 partial a 32-wide chunk, the partials
added in fp64. IP and cosine form no norms. What bounds it then: the
bytes (the probed lists once, the rows out), as for K3.

Two implementations of the row step sit side by side:

- :func:`_pair_rows_cuda` packs the pairs and launches the hand-written
  kernel (:func:`_pair_list_rows_cuda`), adding one to :data:`LAUNCHES`
  per launch;
- :func:`_pair_rows_reference` is the plain PyTorch version, pair by pair
  (:func:`_pair_list_rows_reference` is the plain version of the packed
  step alone).

:func:`scan_probed_lists_pairs` takes the plain version for CPU tensors and
the kernel for CUDA tensors (it raises rather than fall back). The row
transient is bounded by probe chunks, as in ``ops/sorted_scan.py``; packing
and kernel run in the ``torch.profiler`` range ``pair_scan.rows``, the
top-k in ``pair_scan.topk``.
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
    auto_m_budget,
    query_planes,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.sorted_scan import (
    _pair_table,
    _sorted_rows_reference,
    kernel_max_m,
    scan_full_rows,
)

# Kernel launches made by _pair_list_rows_cuda since the process started (or
# since a caller last reset it): lets a run show it went through the kernel.
LAUNCHES = 0


def _pair_rows_reference(q, arena, counts, probe, metric, cap_s):
    """Plain PyTorch version of the kernel: rows ``[B·P, cap_s]``, row
    ``b·P + p`` holding the distances of query b to the first ``cap_s``
    stored slots of list ``probe[b, p]`` with norms from the stored block,
    +inf at or past the list's ``counts`` and for probe -1. Works in pair
    chunks to bound the fp32 block transient."""
    batch, nprobe = probe.shape
    nlist, _, dim = arena.shape
    dev = q.device
    flat = probe.reshape(-1).long()
    out = torch.empty((flat.numel(), cap_s), dtype=torch.float32, device=dev)
    chunk = max(1, _REFERENCE_CHUNK_BYTES // (4 * cap_s * dim))
    slot = torch.arange(cap_s, device=dev)
    pair_b = torch.arange(flat.numel(), device=dev) // nprobe
    for p0 in range(0, flat.numel(), chunk):
        lists = flat[p0:p0 + chunk]
        safe = lists.clamp_min(0)
        qr = q[pair_b[p0:p0 + chunk]]                               # [R, D]
        blocks = arena[safe, :cap_s].float()                        # [R, c, D]
        dots = torch.bmm(blocks, qr[:, :, None])[..., 0]            # [R, c]
        if metric == Metric.L2:
            q_sq = (qr * qr).sum(-1, keepdim=True)
            blk_sq = (blocks * blocks).sum(-1)
            d = (q_sq - 2.0 * dots + blk_sq).clamp_min(0.0)
        elif metric == Metric.INNER_PRODUCT:
            d = -dots
        else:
            d = 1.0 - dots
        valid = (slot[None, :] < counts[safe].long()[:, None]) & (
            lists >= 0)[:, None]
        out[p0:p0 + chunk] = torch.where(valid, d, float("inf"))
    return out


def _pair_list_rows_reference(q, arena, counts, row_list, pair_table, nprobe,
                              n_pairs, metric, cap_s):
    """Plain PyTorch version of the packed step the kernel runs: the rows of
    :func:`_pair_rows_reference` computed list-row by list-row (``row_list
    [n_rows]``, ``pair_table [n_rows, m]`` of pair indices ``b·P + p``, -1 =
    empty, as ``ops/sorted_scan._pair_table`` makes them), each list's norms
    taken once from its stored block. For small inputs: it forms the whole
    arena's norms."""
    x = arena[:, :cap_s].float()
    block_sq = torch.zeros(arena.shape[:2], dtype=torch.float32,
                           device=arena.device)
    block_sq[:, :cap_s] = (x * x).sum(-1)
    return _sorted_rows_reference(q, arena, block_sq, counts, row_list,
                                  pair_table, nprobe, n_pairs, metric, cap_s)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pair-scan kernel: {msg}")


def _pair_list_rows_cuda(q, arena, counts, row_list, pair_table, nprobe,
                         n_pairs, metric, cap_s):
    """Launch the hand-written list-row kernel on packed list-rows (same
    contract as :func:`_pair_list_rows_reference`) on the current CUDA
    stream, passing the query's three bf16 planes. Checks device, dtype,
    shape and contiguity and raises on anything the kernel does not take;
    raises if the launch is refused."""
    global LAUNCHES
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops._build import (
        load_library,
    )

    dev = arena.device
    _check(dev.type == "cuda", f"arena is on {dev}, not a CUDA device")
    for name, t in {"q": q, "arena": arena, "counts": counts,
                    "row_list": row_list, "pair_table": pair_table}.items():
        _check(t.device == dev, f"{name} is on {t.device}, arena on {dev}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
        _check(name in ("q", "arena") or t.dtype == torch.int32,
               f"{name} must be int32")
    _check(arena.dim() == 3 and arena.dtype in _DTYPE_IDS,
           f"arena must be [nlist, cap, D] int8/bf16/f32, got "
           f"{tuple(arena.shape)} {arena.dtype}")
    nlist, cap, dim = arena.shape
    _check(q.dtype == torch.float32 and q.dim() == 2 and q.shape[1] == dim
           and q.shape[0] * nprobe == n_pairs,
           f"q must be [n_pairs / nprobe, {dim}] float32")
    _check(tuple(counts.shape) == (nlist,), "counts must be [nlist] int32")
    _check(1 <= cap_s <= cap, f"cap_s={cap_s} outside 1..{cap}")
    _check(metric in _METRIC_IDS, f"unknown metric {metric}")
    n_rows, m = pair_table.shape
    _check(tuple(row_list.shape) == (n_rows,), "row_list must be [n_rows]")
    m_max = kernel_max_m(dim, arena.dtype)
    _check(1 <= m <= m_max, f"list-row width m={m} outside 1..{m_max}")

    out = torch.empty((n_pairs, cap_s), dtype=torch.float32,
                      device=arena.device)
    planes = query_planes(q, arena.dtype)
    with torch.cuda.device(arena.device):
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        err = load_library().vdb_pair_scan(
            q.data_ptr(), planes.data_ptr(), arena.data_ptr(),
            counts.data_ptr(), row_list.data_ptr(), pair_table.data_ptr(),
            out.data_ptr(), n_rows, q.shape[0], m, dim, nlist, cap, cap_s,
            nprobe, _METRIC_IDS[metric], _DTYPE_IDS[arena.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"pair-scan kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _pair_rows_cuda(q, arena, counts, probe, metric, cap_s):
    """The kernel path of the row step (same contract as
    :func:`_pair_rows_reference`) on every arena dtype: sort the pairs by
    list, pack them into list-rows of the width ``auto_m_budget`` gives
    (clamped to what the kernel's shared memory holds) and launch the
    tensor-core list-row kernel."""
    _check(arena.dim() == 3 and arena.dtype in _DTYPE_IDS,
           f"arena must be [nlist, cap, D] int8/bf16/f32, got "
           f"{tuple(arena.shape)} {arena.dtype}")
    nlist, _, dim = arena.shape
    n_pairs = probe.numel()
    m = min(auto_m_budget(n_pairs, nlist), kernel_max_m(dim, arena.dtype))
    row_list, table = _pair_table(probe, nlist, m)
    return _pair_list_rows_cuda(q, arena, counts, row_list, table,
                                probe.shape[1], n_pairs, metric, cap_s)


def _scan_pairs(rows_fn, queries, arena, counts, probe_ids, k, metric,
                slot_stride, slot_offset, global_capacity, scan_capacity):
    nlist, cap, _ = arena.shape
    global_cap = global_capacity if global_capacity is not None else cap
    cap_s = _effective_cap(cap, scan_capacity)
    kernel_counts = _local_counts(counts, cap, slot_stride, slot_offset)
    q = queries.float().contiguous()
    return scan_full_rows(
        lambda probe: rows_fn(q, arena, kernel_counts, probe, metric, cap_s),
        probe_ids, k, cap_s, global_cap, slot_stride, slot_offset,
        "pair_scan",
    )


def scan_probed_lists_pairs(
    queries: torch.Tensor,
    arena: torch.Tensor,
    arena_sq: torch.Tensor,
    counts: torch.Tensor,
    probe_ids: torch.Tensor,
    k: int,
    metric: Metric = Metric.L2,
    slot_stride: int = 1,
    slot_offset: int = 0,
    global_capacity: int | None = None,
    scan_capacity: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pair full-row scan of each query's probed lists; returns ``(dists
    [B, k] ascending, pos [B, k] int32 global positions, -1 for empty)``
    for any ``k``. ``arena_sq`` is ignored: norms come from the stored
    block. On CUDA tensors the row step is the hand-written kernel; on CPU
    tensors it is the plain version. ``scan_capacity`` and the striping
    arguments are those of ``ops/scan.scan_probed_lists``."""
    del arena_sq  # norms are recomputed from the stored block
    rows_fn = _pair_rows_cuda if arena.is_cuda else _pair_rows_reference
    return _scan_pairs(rows_fn, queries, arena, counts, probe_ids, k, metric,
                       slot_stride, slot_offset, global_capacity,
                       scan_capacity)


def scan_probed_lists_pairs_reference(
    queries: torch.Tensor,
    arena: torch.Tensor,
    arena_sq: torch.Tensor,
    counts: torch.Tensor,
    probe_ids: torch.Tensor,
    k: int,
    metric: Metric = Metric.L2,
    slot_stride: int = 1,
    slot_offset: int = 0,
    global_capacity: int | None = None,
    scan_capacity: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`scan_probed_lists_pairs` with the plain PyTorch row step on
    any device (no kernel, no launch count)."""
    del arena_sq
    return _scan_pairs(_pair_rows_reference, queries, arena, counts,
                       probe_ids, k, metric, slot_stride, slot_offset,
                       global_capacity, scan_capacity)
