"""Pair full-row scan: the port of the TPU kernel K4.

Counterpart of ``scan_probed_lists_pallas`` in
``cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py``. Every
(query, probe) pair gets a full distance row over the list's scanned slot
prefix (``[B·P, cap_s]`` fp32, +inf for empty slots and ``-1`` probes),
and the top-k is taken outside the kernel. Unlike K1 and K3, the rows come
from the stored block alone: each slot's norm is recomputed in fp32 from
the stored values (``arena_sq`` is accepted and ignored, as the TPU kernel
``del``-ed it), and there is no per-row scale and no anchor, so an int8
arena is scanned as raw code values.

Two implementations of the row step sit side by side:

- :func:`_pair_rows_cuda` launches the hand-written Hopper kernel in
  ``csrc/full_row_scan.cu`` (one CTA per pair, no dedup, pairs handed over
  in list order) and adds one to :data:`LAUNCHES` per launch;
- :func:`_pair_rows_reference` is the plain PyTorch version.

:func:`scan_probed_lists_pairs` takes the plain version for CPU tensors and
the kernel for CUDA tensors (it raises rather than fall back). The row
transient is bounded by probe chunks, as in ``ops/sorted_scan.py``; the
kernel runs in the ``torch.profiler`` range ``pair_scan.rows``, the top-k
in ``pair_scan.topk``.
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
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.sorted_scan import (
    scan_full_rows,
)

# Kernel launches made by _pair_rows_cuda since the process started (or
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


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pair-scan kernel: {msg}")


def _pair_rows_cuda(q, arena, counts, probe, metric, cap_s):
    """Launch the hand-written kernel (same contract as
    :func:`_pair_rows_reference`) on the current CUDA stream, one CTA per
    pair with the pairs in list order. Checks device, dtype, shape and
    contiguity and raises on anything the kernel does not take; raises if
    the launch is refused."""
    global LAUNCHES
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops._build import (
        load_library,
    )

    dev = arena.device
    _check(dev.type == "cuda", f"arena is on {dev}, not a CUDA device")
    for name, t in {"q": q, "arena": arena, "counts": counts,
                    "probe": probe}.items():
        _check(t.device == dev, f"{name} is on {t.device}, arena on {dev}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(arena.dim() == 3 and arena.dtype in _DTYPE_IDS,
           f"arena must be [nlist, cap, D] int8/bf16/f32, got "
           f"{tuple(arena.shape)} {arena.dtype}")
    nlist, cap, dim = arena.shape
    batch, nprobe = probe.shape
    _check(q.dtype == torch.float32 and tuple(q.shape) == (batch, dim),
           f"q must be [{batch}, {dim}] float32")
    _check(counts.dtype == torch.int32 and tuple(counts.shape) == (nlist,),
           "counts must be [nlist] int32")
    _check(probe.dtype == torch.int32, "probe must be int32")
    _check(1 <= cap_s <= cap, f"cap_s={cap_s} outside 1..{cap}")
    _check(metric in _METRIC_IDS, f"unknown metric {metric}")

    flat = probe.reshape(-1)
    n_pairs = flat.numel()
    # list order: CTAs that run together read the same list (from L2)
    order = torch.argsort(torch.where(flat >= 0, flat, nlist),
                          stable=True).int()
    out = torch.empty((n_pairs, cap_s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = load_library().vdb_pair_scan(
            q.data_ptr(), arena.data_ptr(), counts.data_ptr(),
            flat.data_ptr(), order.data_ptr(), out.data_ptr(), n_pairs,
            nprobe, dim, nlist, cap, cap_s, _METRIC_IDS[metric],
            _DTYPE_IDS[arena.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"pair-scan kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


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
