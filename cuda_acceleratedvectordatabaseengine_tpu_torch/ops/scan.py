"""Gather scan + top-k over probed lists (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/ops/scan.py::scan_probed_lists``),
and the flat index's brute-force scan (:func:`scan_all`, the port of that
module's ``scan_flat``).

The port's CPU search path and its in-package correctness reference: every
other scan (the grouped plain version and the hand-written kernel in
``ops/grouped_scan.py``) is held against it. One probe step at a time, it
gathers each query's probed list block, contracts it against the query in
fp32 and merges the result into a running top-k.

Candidate identity is an int32 global arena position
``list_id * capacity + slot``; ``-1`` marks invalid slots.
"""

from __future__ import annotations

import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import merge_topk


def _block_distances(q, block, block_sq, q_sq, metric, dots_scale=None,
                     dots_bias=None):
    """Per-query distances to a gathered block ``[B, L, D]``: ``[B, L]``
    fp32. int8 codes and bf16 rows are widened to fp32; ``q·x̂`` is
    ``dots_bias + dots_scale ⊙ (q·code)``."""
    dots = torch.bmm(block.float(), q[:, :, None])[:, :, 0]
    if dots_scale is not None:
        dots = dots * dots_scale
    if dots_bias is not None:
        dots = dots + dots_bias[:, None]
    if metric == Metric.L2:
        return (q_sq[:, None] - 2.0 * dots + block_sq).clamp_min(0.0)
    elif metric == Metric.INNER_PRODUCT:
        return -dots
    elif metric == Metric.COSINE:
        # queries and stored rows are pre-normalized at entry / ingest
        return 1.0 - dots
    raise ValueError(f"unknown metric: {metric}")


def scan_probed_lists(
    queries: torch.Tensor,      # [B, D] fp32 (pre-normalized if cosine)
    arena: torch.Tensor,        # [nlist, L, D] (L = local capacity)
    arena_sq: torch.Tensor,     # [nlist, L] fp32
    counts: torch.Tensor,       # [nlist] int32 live rows (GLOBAL counts)
    probe_ids: torch.Tensor,    # [B, P] int32, -1 = no probe
    k: int,
    metric: Metric = Metric.L2,
    slot_stride: int = 1,
    slot_offset: int = 0,
    global_capacity: int | None = None,
    arena_scale: torch.Tensor | None = None,    # [nlist, L] fp32, int8
    arena_anchors: torch.Tensor | None = None,  # [nlist, D] fp32 anchors
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan each query's ``P`` probed lists with a running top-k merge.

    Returns ``(dists [B, k] fp32 ascending, pos [B, k] int32 global
    positions, -1 for empty)``.

    ``slot_stride``/``slot_offset``/``global_capacity`` describe a slot axis
    striped round-robin across shards (local slot ``j`` holds logical slot
    ``j * stride + offset``): validity and positions are in logical space.
    """
    batch = queries.shape[0]
    nlist, cap, _ = arena.shape
    global_cap = global_capacity if global_capacity is not None else cap
    dev = queries.device
    q = queries.float()
    q_sq = (q * q).sum(-1)
    slot_logical = (
        torch.arange(cap, dtype=torch.int32, device=dev) * slot_stride
        + slot_offset
    )
    best_d = torch.full((batch, k), float("inf"), device=dev)
    best_p = torch.full((batch, k), -1, dtype=torch.int32, device=dev)
    # q·anchor for every (query, list) once up front.
    qa_all = q @ arena_anchors.float().T if arena_anchors is not None else None
    rows = torch.arange(batch, device=dev)
    for lists in probe_ids.T:
        safe = lists.clamp_min(0).long()
        scale = arena_scale[safe] if arena_scale is not None else None
        bias = qa_all[rows, safe] if qa_all is not None else None
        d = _block_distances(
            q, arena[safe], arena_sq[safe], q_sq, metric, scale, bias
        )
        valid = (slot_logical[None, :] < counts[safe][:, None]) & (
            lists >= 0
        )[:, None]
        d = torch.where(valid, d, float("inf"))
        pos = torch.where(
            valid, (safe[:, None] * global_cap + slot_logical[None, :]).int(),
            -1,
        )
        best_d, best_p = merge_topk(best_d, best_p, d, pos, k)
    return best_d, best_p


def scan_all(
    queries: torch.Tensor,      # [B, D] fp32 (pre-normalized if cosine)
    data: torch.Tensor,         # [N_pad, D] corpus dtype
    data_sq: torch.Tensor,      # [N_pad] fp32
    n_valid: int,
    k: int,
    metric: Metric = Metric.L2,
    chunk_size: int = 65536,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force scan of the first ``n_valid`` rows with a running
    top-k (the port of the JAX package's ``ops/scan.py::scan_flat``, the
    flat index's search; named apart from ``ops/flat_scan.scan_flat``, the
    probed-list router). Chunked over rows so each step is one
    ``[B, D] × [D, C]`` product, run in fp32 on the widened rows (TF32 is
    off package-wide): exact products of the fp32 query and the stored
    values, added in fp32. The JAX version rounds the query to the corpus
    dtype first, for the TPU's bf16 matrix unit; the port keeps it fp32,
    so its distances are fp32-exact distances to the stored rows. Returns
    ``(dists [B, k] ascending, pos [B, k] row numbers, -1 for empty)``."""
    q = queries.float()
    q_sq = (q * q).sum(-1)
    batch = q.shape[0]
    best_d = torch.full((batch, k), float("inf"), device=q.device)
    best_p = torch.full((batch, k), -1, dtype=torch.int32, device=q.device)
    for c0 in range(0, max(n_valid, 1), chunk_size):
        c1 = min(c0 + chunk_size, n_valid)
        if c1 <= c0:
            break
        dots = q @ data[c0:c1].float().T
        if metric == Metric.L2:
            d = (q_sq[:, None] - 2.0 * dots + data_sq[None, c0:c1]).clamp_min(
                0.0)
        elif metric == Metric.INNER_PRODUCT:
            d = -dots
        else:
            d = 1.0 - dots
        pos = torch.arange(c0, c1, dtype=torch.int32,
                           device=q.device).expand(batch, -1)
        best_d, best_p = merge_topk(best_d, best_p, d, pos, k)
    return best_d, best_p
