"""List-centric grouped scan: the port of the TPU kernel K1.

Counterpart of the grouped part of
``cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py``
(``scan_probed_lists_pallas_grouped`` and its glue). The (query, probed
list) pairs of a batch are sorted by list and packed into *list-rows* of at
most M same-list queries; one kernel step per list-row computes the
distances of its queries to the list's occupied slots and keeps the k
smallest per (query, list); an epilogue takes the final top-k over
``nprobe · k`` candidates per query.

Two implementations of the per-row step sit side by side:

- :func:`_grouped_rows_cuda` launches the hand-written Hopper kernel in
  ``csrc/grouped_scan.cu`` and adds one to :data:`LAUNCHES` per launch; it
  first splits the fp32 queries into three bf16 planes
  (:func:`split_query_bf16x3`), which the kernel multiplies with the
  stored values on the tensor cores (exact products, fp32 sums; an fp32
  arena's values are split the same way inside the kernel);
- :func:`_grouped_rows_reference` is the plain PyTorch version of the same
  function.

:func:`scan_probed_lists_grouped` takes the plain version for CPU tensors
and the kernel for CUDA tensors (it raises rather than fall back);
:func:`scan_probed_lists_grouped_reference` always takes the plain version.
Packing and epilogue are shared torch code that runs on the tensors' device.
Packing, the per-row step and the epilogue run in the ``torch.profiler``
ranges ``grouped_scan.pack``, ``grouped_scan.rows`` and
``grouped_scan.epilogue``.
"""

from __future__ import annotations

import typing

import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
    topk_smallest,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.profiling import (
    trace,
)

# Kernel launches made by _grouped_rows_cuda since the process started (or
# since a caller last reset it): lets a run show it went through the kernel.
LAUNCHES = 0

KMAX = 64  # deepest per-(query, list) top-k the kernel keeps
_DTYPE_IDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_METRIC_IDS = {Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2}
# Bound on the fp32 gathered-block transient of the plain version (bytes).
_REFERENCE_CHUNK_BYTES = 1 << 28


class Pack(typing.NamedTuple):
    """(query, probe) pairs packed into list-rows (``_pack_pairs_into_rows``)."""

    order: torch.Tensor        # [n_pairs] pair index in list-sorted order
    key_sorted: torch.Tensor   # [n_pairs] list id (nlist = invalid probe)
    row_of_pair: torch.Tensor  # [n_pairs] list-row of each sorted pair
    m_of_pair: torch.Tensor    # [n_pairs] position inside the list-row
    row_list: torch.Tensor     # [n_rows] int32 list id, nlist = unused row
    qrow_table: torch.Tensor   # [n_rows, m] int32 query index, -1 = empty


def auto_m_budget(n_pairs: int, nlist: int) -> int:
    """List-row width law of the JAX package: m ≈ 8·√(mean pairs per
    list), snapped to {8, 16, 32, 48, 64}."""
    mean_ppl = n_pairs / max(nlist, 1)
    raw = min(64.0, max(8.0, 8.0 * mean_ppl ** 0.5))
    return min((8, 16, 32, 48, 64), key=lambda w: (abs(w - raw), w))


def _effective_cap(cap: int, scan_capacity: int | None) -> int:
    """Slot-prefix width actually scanned: ``scan_capacity`` (a bound on
    max(counts)) rounded up to 128 slots, never above the allocation."""
    if scan_capacity is None or scan_capacity >= cap:
        return cap
    return min(cap, max(128, -(-scan_capacity // 128) * 128))


def _local_counts(counts, cap: int, slot_stride: int, slot_offset: int):
    """Valid local slots per list when the slot axis is striped round-robin
    over ``slot_stride`` shards (this shard holds ``j*stride + offset``)."""
    if slot_stride == 1:
        return counts
    lc = (counts - slot_offset + slot_stride - 1) // slot_stride
    return lc.clamp(0, cap).to(counts.dtype)


def _n_rows_bound(n_pairs: int, nlist: int, m: int) -> int:
    """Static bound on the list-rows: full rows + one partial row per list
    (+ the invalid-probe group), and never more rows than pairs."""
    return max(min(n_pairs // m + nlist + 1, n_pairs), 1)


def _group_counts(key_sorted: torch.Tensor, n: int) -> torch.Tensor:
    """Pairs of each key ``0..n-1``: ``torch.bincount(key_sorted,
    minlength=n)`` for keys below ``n``, with no read-back (CUDA's
    ``bincount`` reads the keys' min and max to the host to size its
    output, a wait for the card)."""
    return torch.zeros(n, dtype=torch.long, device=key_sorted.device
                       ).index_add_(0, key_sorted,
                                    torch.ones_like(key_sorted))


def _pack_pairs_into_rows(probe_ids: torch.Tensor, nlist: int, m: int,
                          n_rows: int) -> Pack:
    """Sort (query, probe) pairs by list id and pack them into list-rows of
    up to ``m`` same-list queries, on the probe ids' device, reading
    nothing back to the host."""
    batch, nprobe = probe_ids.shape
    dev = probe_ids.device
    n_pairs = batch * nprobe
    flat = probe_ids.reshape(-1).long()
    pair_b = torch.arange(n_pairs, device=dev) // nprobe
    key = torch.where(flat >= 0, flat, nlist)
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    gcounts = _group_counts(key_sorted, nlist + 1)
    gstart = torch.cumsum(gcounts, 0) - gcounts
    r_in_list = torch.arange(n_pairs, device=dev) - gstart[key_sorted]
    rows_per_list = (gcounts + m - 1) // m
    row_offset = torch.cumsum(rows_per_list, 0) - rows_per_list
    row_of_pair = row_offset[key_sorted] + r_in_list // m
    m_of_pair = r_in_list % m
    row_list = torch.full((n_rows,), nlist, dtype=torch.int32, device=dev)
    row_list[row_of_pair] = key_sorted.int()
    qrow_table = torch.full((n_rows, m), -1, dtype=torch.int32, device=dev)
    qrow_table[row_of_pair, m_of_pair] = torch.where(
        flat[order] >= 0, pair_b[order], -1
    ).int()
    return Pack(order, key_sorted, row_of_pair, m_of_pair, row_list,
                qrow_table)


def _grouped_epilogue(out_d, out_s, pack: Pack, batch, nprobe, k, nlist,
                      global_cap, slot_stride, slot_offset, k_inner=None):
    """Per-pair candidate rows back to (b, p) order, then the final top-k
    over ``nprobe · k_inner`` candidates per query. ``k_inner`` is the
    per-pair depth the rows hold: ``k`` (the default) for exact scans,
    smaller in shortlist mode. Local slots map to logical ones under
    striping; invalid candidates become (+inf, -1)."""
    ki = k if k_inner is None else k_inner
    pair_d = out_d[pack.row_of_pair, pack.m_of_pair]         # [BP, ki] sorted
    pair_s = out_s[pack.row_of_pair, pack.m_of_pair].long()
    real = (
        (pair_s >= 0) & (pack.key_sorted[:, None] < nlist)
        & torch.isfinite(pair_d)
    )
    pair_d = torch.where(real, pair_d, float("inf"))
    pair_pos = torch.where(
        real,
        pack.key_sorted[:, None] * global_cap
        + pair_s * slot_stride + slot_offset,
        -1,
    ).int()
    d = torch.empty_like(pair_d)
    pos = torch.empty_like(pair_pos)
    d[pack.order] = pair_d
    pos[pack.order] = pair_pos
    return topk_smallest(
        d.reshape(batch, nprobe * ki), k, idx=pos.reshape(batch, nprobe * ki)
    )


def _grouped_rows_reference(q, arena, arena_sq, counts, row_list, qrow_table,
                            k, metric, cap_s, arena_scale=None,
                            arena_anchors=None):
    """Plain PyTorch version of the kernel: ``(out_d, out_s)`` of shape
    ``[n_rows, m, k]``, the k smallest ``(distance, slot)`` pairs of each
    (list-row, query slot) in ascending lexicographic order (ties go to the
    smaller slot), with (+inf, -1) for empty slots, sentinel rows and lists
    shorter than k. Works in row chunks to bound the fp32 block transient."""
    n_rows, m = qrow_table.shape
    nlist, _, dim = arena.shape
    dev = q.device
    out_d = torch.full((n_rows, m, k), float("inf"), device=dev)
    out_s = torch.full((n_rows, m, k), -1, dtype=torch.int32, device=dev)
    chunk = max(1, _REFERENCE_CHUNK_BYTES // (4 * cap_s * dim))
    slot = torch.arange(cap_s, device=dev)
    for r0 in range(0, n_rows, chunk):
        rl = row_list[r0:r0 + chunk].long()
        qi = qrow_table[r0:r0 + chunk].long()
        live_row = rl < nlist
        lists = rl.clamp(0, nlist - 1)
        qr = q[qi.clamp_min(0)]                                   # [R, m, D]
        blocks = arena[lists, :cap_s].float()                     # [R, c, D]
        qx = torch.bmm(qr, blocks.transpose(1, 2))                # [R, m, c]
        if arena_scale is not None:
            qx = qx * arena_scale[lists, :cap_s][:, None, :]
        if arena_anchors is not None:
            qx = qx + (qr * arena_anchors[lists][:, None, :]).sum(-1,
                                                                  keepdim=True)
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
            & live_row[:, None, None] & (qi >= 0)[:, :, None]
        )
        d = torch.where(valid, d, float("inf"))
        kk = min(k, cap_s)
        vals, cols = torch.sort(d, dim=-1, stable=True)
        vals, cols = vals[..., :kk], cols[..., :kk]
        out_d[r0:r0 + chunk, :, :kk] = vals
        out_s[r0:r0 + chunk, :, :kk] = torch.where(
            torch.isfinite(vals), cols, -1
        ).int()
    return out_d, out_s


def split_query_bf16x3(q: torch.Tensor) -> torch.Tensor:
    """The query's three bf16 planes ``[3, B, D]``: hi = bf16(q), mid =
    bf16(q - hi), lo = bf16(q - hi - mid). Both differences are exact in
    fp32 and hi + mid + lo == q exactly (three 8-bit significands cover
    fp32's 24), unless the lo plane falls below bf16's smallest subnormal
    2⁻¹³³ (|q| < 2⁻¹¹⁰, where the sum is off by at most 2⁻¹³⁴). So the three
    bf16 products with an int8 or bf16 code are exact and their fp32 sum
    is the dot up to fp32 accumulation: what the tensor-core scans (K1, K3,
    K4) compute. The kernels split an fp32 arena's values the same way, in
    registers, and sum six of the nine plane products (hh, hm, mh, hl, lh,
    mm; ``csrc/tc_scan.cuh``)."""
    q = q.float()
    hi = q.to(torch.bfloat16)
    r = q - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def kernel_max_m(dim: int, arena_dtype: torch.dtype) -> int:
    """Widest list-row the CUDA kernel takes at this dimension and arena
    dtype: 64 on int8, bf16 and fp32 arenas (the tensor-core kernel stages
    D in chunks, so the width does not depend on D). Builds the kernel
    library if needed."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops._build import (
        load_library,
    )

    if arena_dtype not in _DTYPE_IDS:
        raise ValueError(f"the kernel takes no {arena_dtype} arena")
    return int(load_library().vdb_grouped_scan_max_m(
        int(dim), _DTYPE_IDS[arena_dtype]
    ))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"grouped-scan kernel: {msg}")


def check_list_row_args(check, q, arena, arena_sq, counts, row_list, table,
                        cap_s, metric, m_max, arena_scale=None,
                        arena_anchors=None) -> None:
    """The checks a list-row kernel over a flat arena (K1, K3) makes
    before launch: device, dtype, shape and contiguity of every input, the
    scanned prefix, the metric and the list-row width against ``m_max``
    (its shared-memory bound). ``check(cond, msg)`` raises."""
    dev = arena.device
    check(dev.type == "cuda", f"arena is on {dev}, not a CUDA device")
    tensors = {
        "q": q, "arena": arena, "arena_sq": arena_sq, "counts": counts,
        "row_list": row_list, "table": table,
        "arena_scale": arena_scale, "arena_anchors": arena_anchors,
    }
    for name, t in tensors.items():
        if t is None:
            continue
        check(t.device == dev, f"{name} is on {t.device}, arena on {dev}")
        check(t.is_contiguous(), f"{name} is not contiguous")
    check(arena.dim() == 3 and arena.dtype in _DTYPE_IDS,
          f"arena must be [nlist, cap, D] int8/bf16/f32, got "
          f"{tuple(arena.shape)} {arena.dtype}")
    nlist, cap, dim = arena.shape
    n_rows, m = table.shape
    check(q.dtype == torch.float32 and q.dim() == 2 and q.shape[1] == dim,
          f"q must be [B, {dim}] float32")
    check(arena_sq.dtype == torch.float32
          and tuple(arena_sq.shape) == (nlist, cap),
          "arena_sq must be [nlist, cap] float32")
    check(counts.dtype == torch.int32 and tuple(counts.shape) == (nlist,),
          "counts must be [nlist] int32")
    check(row_list.dtype == torch.int32 and table.dtype == torch.int32
          and tuple(row_list.shape) == (n_rows,),
          "row_list [n_rows] and the row table [n_rows, m] must be int32")
    if arena_scale is not None:
        check(arena_scale.dtype == torch.float32
              and tuple(arena_scale.shape) == (nlist, cap),
              "arena_scale must be [nlist, cap] float32")
    if arena_anchors is not None:
        check(arena_anchors.dtype == torch.float32
              and tuple(arena_anchors.shape) == (nlist, dim),
              "arena_anchors must be [nlist, D] float32")
    check(1 <= cap_s <= cap, f"cap_s={cap_s} outside 1..{cap}")
    check(metric in _METRIC_IDS, f"unknown metric {metric}")
    check(1 <= m <= m_max,
          f"list-row width m={m} outside 1..{m_max}, the shared-memory "
          f"bound at D={dim}, {arena.dtype}")


def query_planes(q: torch.Tensor, arena_dtype: torch.dtype) -> torch.Tensor:
    """The contiguous ``[3, B, D]`` bf16 planes the tensor-core kernels
    read beside an arena of ``arena_dtype`` (int8, bf16 or fp32; raises on
    another)."""
    if arena_dtype not in _DTYPE_IDS:
        raise ValueError(f"the kernels take no {arena_dtype} arena")
    return split_query_bf16x3(q).contiguous()


def _grouped_rows_cuda(q, arena, arena_sq, counts, row_list, qrow_table, k,
                       metric, cap_s, arena_scale=None, arena_anchors=None):
    """Launch the hand-written kernel (same contract as
    :func:`_grouped_rows_reference`) on the current CUDA stream. Checks
    device, dtype, shape and contiguity and raises on anything the kernel
    does not take; raises if the launch is refused."""
    global LAUNCHES
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops._build import (
        load_library,
    )

    _check(arena.dim() == 3, "arena must be [nlist, cap, D]")
    check_list_row_args(_check, q, arena, arena_sq, counts, row_list,
                        qrow_table, cap_s, metric,
                        kernel_max_m(arena.shape[2], arena.dtype),
                        arena_scale, arena_anchors)
    _check(1 <= k <= KMAX, f"k={k} outside 1..{KMAX}")
    dev = arena.device
    nlist, cap, dim = arena.shape
    n_rows, m = qrow_table.shape

    out_d = torch.empty((n_rows, m, k), dtype=torch.float32, device=dev)
    out_s = torch.empty((n_rows, m, k), dtype=torch.int32, device=dev)
    planes = query_planes(q, arena.dtype)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = load_library().vdb_grouped_scan(
            ptr(q), ptr(planes), ptr(arena), ptr(arena_sq), ptr(arena_scale),
            ptr(arena_anchors), ptr(counts), ptr(row_list), ptr(qrow_table),
            ptr(out_d), ptr(out_s), n_rows, q.shape[0], m, dim, nlist, cap,
            cap_s, k, _METRIC_IDS[metric], _DTYPE_IDS[arena.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped-scan kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out_d, out_s


def _scan_grouped(rows_fn, queries, arena, arena_sq, counts, probe_ids, k,
                  metric, m_budget, arena_scale, arena_anchors, slot_stride,
                  slot_offset, global_capacity, scan_capacity, m_limit=None):
    batch, nprobe = probe_ids.shape
    nlist, cap, _ = arena.shape
    global_cap = global_capacity if global_capacity is not None else cap
    cap_s = _effective_cap(cap, scan_capacity)
    kernel_counts = _local_counts(counts, cap, slot_stride, slot_offset)
    n_pairs = batch * nprobe
    m = m_budget or auto_m_budget(n_pairs, nlist)
    if m_limit is not None:
        m = min(m, m_limit)
    with trace("grouped_scan.pack"):
        pack = _pack_pairs_into_rows(probe_ids, nlist, m,
                                     _n_rows_bound(n_pairs, nlist, m))
    with trace("grouped_scan.rows"):
        out_d, out_s = rows_fn(
            queries.float().contiguous(), arena, arena_sq, kernel_counts,
            pack.row_list, pack.qrow_table, k, metric, cap_s,
            arena_scale=arena_scale, arena_anchors=(
                arena_anchors.float().contiguous()
                if arena_anchors is not None else None
            ),
        )
    with trace("grouped_scan.epilogue"):
        return _grouped_epilogue(out_d, out_s, pack, batch, nprobe, k, nlist,
                                 global_cap, slot_stride, slot_offset)


def scan_probed_lists_grouped(
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
    """Grouped scan of each query's probed lists; returns ``(dists [B, k]
    ascending, pos [B, k] int32 global positions, -1 for empty)``, the
    contract of ``ops/scan.scan_probed_lists``.

    On CUDA tensors the per-row step is the hand-written kernel (list-row
    width clamped to what its shared memory holds; k ≤ 64); on CPU tensors
    it is the plain version. ``m_budget`` is the list-row width (None =
    :func:`auto_m_budget`); ``scan_capacity`` bounds the scanned slot
    prefix (exact while ≥ max(counts)); the striping arguments are those of
    ``scan_probed_lists``.
    """
    if arena.is_cuda:
        _check(1 <= k <= KMAX, f"k={k} outside 1..{KMAX}")
        rows_fn = _grouped_rows_cuda
        m_limit = kernel_max_m(arena.shape[-1], arena.dtype)
    else:
        rows_fn, m_limit = _grouped_rows_reference, None
    return _scan_grouped(
        rows_fn, queries, arena, arena_sq, counts, probe_ids, k, metric,
        m_budget, arena_scale, arena_anchors, slot_stride, slot_offset,
        global_capacity, scan_capacity, m_limit,
    )


def scan_probed_lists_grouped_reference(
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
    """:func:`scan_probed_lists_grouped` with the plain PyTorch per-row step
    on any device (no kernel, no launch count)."""
    return _scan_grouped(
        _grouped_rows_reference, queries, arena, arena_sq, counts, probe_ids,
        k, metric, m_budget, arena_scale, arena_anchors, slot_stride,
        slot_offset, global_capacity, scan_capacity,
    )
