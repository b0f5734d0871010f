"""List-centric grouped ADC scan over PQ codes: the port of the TPU kernel
K2.

Counterpart of ``scan_probed_codes_pallas_grouped`` in
``cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py``. The
(query, probed list) pairs of a batch are packed into list-rows exactly as
for the flat grouped scan (``ops/grouped_scan.py``); one kernel step per
list-row decodes the list's residual codes against the codebooks and
computes, for each of its queries and each occupied slot,
``qx = q·c_l + q·r̂_s`` and the distance (L2 ``max(‖q‖² − 2·qx +
code_sq, 0)``, IP ``−qx``). Three output modes:

- top-k: the k smallest per pair, then the epilogue over ``nprobe · k``;
- ``k_inner``: each pair keeps ``min(max(k_inner, ⌈k/nprobe⌉), cap_s, k)``
  and the epilogue runs over ``nprobe`` times that (a shortlist that an
  exact rerank absorbs);
- ``emit_full``: the masked full ``[n_rows, M, cap_s]`` rows, then one
  top-k over the ``nprobe · cap_s`` union (exact at any depth).

Two implementations of the per-row step sit side by side:
:func:`_grouped_pq_rows_cuda` launches the hand-written Hopper kernel in
``csrc/grouped_pq_scan.cu`` and adds one to :data:`LAUNCHES` per launch;
:func:`_grouped_pq_rows_reference` is the plain PyTorch version.
:func:`scan_probed_codes_grouped` takes the plain version for CPU tensors
and the kernel for CUDA tensors (it raises rather than fall back);
:func:`scan_probed_codes_grouped_reference` always takes the plain version.
Packing, the per-row step and the epilogue run in the ``torch.profiler``
ranges ``grouped_pq_scan.pack``, ``grouped_pq_scan.rows`` and
``grouped_pq_scan.epilogue``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.grouped_scan import (
    KMAX,
    Pack,
    _effective_cap,
    _grouped_epilogue,
    _local_counts,
    _n_rows_bound,
    _pack_pairs_into_rows,
    auto_m_budget,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
    topk_smallest,
)

# Kernel launches made by _grouped_pq_rows_cuda since the process started
# (or since a caller last reset it): lets a run show it went through K2.
LAUNCHES = 0

KS = 256  # codewords per subspace: the kernel takes 8-bit codes
_METRIC_IDS = {Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2}
# Bound on the fp32 decoded-block transient of the plain version (bytes).
_REFERENCE_CHUNK_BYTES = 1 << 28


def _grouped_pq_rows_reference(q, codes_t, code_sq, counts, centroids,
                               codebooks, row_list, qrow_table, k, metric,
                               cap_s, emit_full=False):
    """Plain PyTorch version of the kernel. Top-k mode: ``(out_d, out_s)``
    of shape ``[n_rows, m, k]``, the k smallest ``(distance, slot)`` pairs
    of each (list-row, query slot), ascending, ties to the smaller slot,
    (+inf, -1) for empty slots, sentinel rows and lists shorter than k.
    ``emit_full``: ``(out_d [n_rows, m, cap_s], None)``, the masked rows.
    Decodes each row's list with a codebook gather and computes the
    kernel's ``qx = q·c_l + q·r̂`` (not the residual-table ADC). Works in
    row chunks to bound the fp32 decoded-block transient."""
    n_rows, m = qrow_table.shape
    nlist, msub, _ = codes_t.shape
    dsub = codebooks.shape[2]
    dim = msub * dsub
    dev = q.device
    width = cap_s if emit_full else k
    out_d = torch.full((n_rows, m, width), float("inf"), device=dev)
    out_s = (None if emit_full else
             torch.full((n_rows, m, k), -1, dtype=torch.int32, device=dev))
    chunk = max(1, _REFERENCE_CHUNK_BYTES // (4 * cap_s * dim))
    slot = torch.arange(cap_s, device=dev)
    sub = torch.arange(msub, device=dev)[None, :, None]
    cb = codebooks.float()
    for r0 in range(0, n_rows, chunk):
        rl = row_list[r0:r0 + chunk].long()
        qi = qrow_table[r0:r0 + chunk].long()
        live_row = rl < nlist
        lists = rl.clamp(0, nlist - 1)
        qr = q[qi.clamp_min(0)]                                   # [R, m, D]
        codes = codes_t[lists, :, :cap_s].long()                  # [R, j, c]
        dec = cb[sub, codes]                                      # [R, j, c, s]
        dec = dec.permute(0, 2, 1, 3).reshape(lists.shape[0], cap_s, dim)
        qx = torch.bmm(qr, dec.transpose(1, 2))                   # [R, m, c]
        qx = qx + (qr * centroids[lists][:, None, :]).sum(-1, keepdim=True)
        if metric == Metric.L2:
            q_sq = (qr * qr).sum(-1, keepdim=True)
            d = (q_sq - 2.0 * qx + code_sq[lists, :cap_s][:, None, :])
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
        if emit_full:
            out_d[r0:r0 + chunk] = d
            continue
        kk = min(k, cap_s)
        vals, cols = torch.sort(d, dim=-1, stable=True)
        vals, cols = vals[..., :kk], cols[..., :kk]
        out_d[r0:r0 + chunk, :, :kk] = vals
        out_s[r0:r0 + chunk, :, :kk] = torch.where(
            torch.isfinite(vals), cols, -1
        ).int()
    return out_d, out_s


def kernel_max_m(dim: int) -> int:
    """Widest list-row the CUDA kernel takes at this dimension: its M
    queries and one decoded fp32 slot tile must fit the 227 KB of shared
    memory of one CTA. Builds the kernel library if needed."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops._build import (
        load_library,
    )

    return int(load_library().vdb_grouped_pq_scan_max_m(int(dim)))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"grouped PQ scan kernel: {msg}")


def _grouped_pq_rows_cuda(q, codes_t, code_sq, counts, centroids, codebooks,
                          row_list, qrow_table, k, metric, cap_s,
                          emit_full=False):
    """Launch the hand-written kernel (same contract as
    :func:`_grouped_pq_rows_reference`) on the current CUDA stream. Checks
    device, dtype, shape and contiguity and raises on anything the kernel
    does not take; raises if the launch is refused."""
    global LAUNCHES
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops._build import (
        load_library,
    )

    dev = codes_t.device
    _check(dev.type == "cuda", f"codes are on {dev}, not a CUDA device")
    tensors = {
        "q": q, "codes_t": codes_t, "code_sq": code_sq, "counts": counts,
        "centroids": centroids, "codebooks": codebooks, "row_list": row_list,
        "qrow_table": qrow_table,
    }
    for name, t in tensors.items():
        _check(t.device == dev, f"{name} is on {t.device}, codes on {dev}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(codes_t.dim() == 3 and codes_t.dtype == torch.uint8,
           f"codes_t must be [nlist, m, cap] uint8, got "
           f"{tuple(codes_t.shape)} {codes_t.dtype}")
    nlist, msub, cap = codes_t.shape
    _check(codebooks.dtype == torch.float32 and codebooks.dim() == 3
           and tuple(codebooks.shape[:2]) == (msub, KS),
           f"codebooks must be [{msub}, {KS}, dsub] float32, got "
           f"{tuple(codebooks.shape)} {codebooks.dtype}")
    dim = msub * codebooks.shape[2]
    n_rows, m = qrow_table.shape
    _check(q.dtype == torch.float32 and q.dim() == 2 and q.shape[1] == dim,
           f"q must be [B, {dim}] float32")
    _check(code_sq.dtype == torch.float32
           and tuple(code_sq.shape) == (nlist, cap),
           "code_sq must be [nlist, cap] float32")
    _check(counts.dtype == torch.int32 and tuple(counts.shape) == (nlist,),
           "counts must be [nlist] int32")
    _check(centroids.dtype == torch.float32
           and tuple(centroids.shape) == (nlist, dim),
           f"centroids must be [nlist, {dim}] float32")
    _check(row_list.dtype == torch.int32 and qrow_table.dtype == torch.int32
           and tuple(row_list.shape) == (n_rows,),
           "row_list [n_rows] and qrow_table [n_rows, m] must be int32")
    _check(emit_full or 1 <= k <= KMAX, f"k={k} outside 1..{KMAX}")
    _check(1 <= cap_s <= cap, f"cap_s={cap_s} outside 1..{cap}")
    _check(metric in _METRIC_IDS, f"unknown metric {metric}")
    m_max = kernel_max_m(dim)
    _check(1 <= m <= m_max,
           f"list-row width m={m} outside 1..{m_max}, the shared-memory "
           f"bound at D={dim}")

    width = cap_s if emit_full else k
    out_d = torch.empty((n_rows, m, width), dtype=torch.float32, device=dev)
    out_s = (None if emit_full else
             torch.empty((n_rows, m, k), dtype=torch.int32, device=dev))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = load_library().vdb_grouped_pq_scan(
            ptr(q), ptr(codes_t), ptr(code_sq), ptr(counts), ptr(centroids),
            ptr(codebooks), ptr(row_list), ptr(qrow_table), ptr(out_d),
            ptr(out_s), n_rows, m, dim, msub, KS, nlist, cap, cap_s,
            0 if emit_full else k, int(emit_full), _METRIC_IDS[metric],
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"grouped PQ scan kernel launch failed: cudaError {err}"
        )
    LAUNCHES += 1
    return out_d, out_s


def _full_row_epilogue(out_d, pack: Pack, batch, nprobe, k, nlist,
                       global_cap, slot_stride, slot_offset):
    """``emit_full``: each pair's full distance row back to (b, p) order,
    (list, slot) mapped to global positions, one top-k over the
    ``nprobe · cap_s`` union per query."""
    cap_s = out_d.shape[2]
    pair_d = out_d[pack.row_of_pair, pack.m_of_pair]          # [BP, cap_s]
    real = (pack.key_sorted[:, None] < nlist) & torch.isfinite(pair_d)
    pair_d = torch.where(real, pair_d, float("inf"))
    slot_logical = (
        torch.arange(cap_s, device=out_d.device) * slot_stride + slot_offset
    )
    pair_pos = torch.where(
        real, pack.key_sorted[:, None] * global_cap + slot_logical[None, :],
        -1,
    ).int()
    d = torch.empty_like(pair_d)
    pos = torch.empty_like(pair_pos)
    d[pack.order] = pair_d
    pos[pack.order] = pair_pos
    return topk_smallest(d.reshape(batch, nprobe * cap_s), k,
                         idx=pos.reshape(batch, nprobe * cap_s))


def _scan_codes_grouped(rows_fn, queries, codes_t, code_sq, counts,
                        centroids, codebooks, probe_ids, k, metric, m_budget,
                        slot_stride, slot_offset, global_capacity, k_inner,
                        emit_full, scan_capacity, m_limit=None):
    batch, nprobe = probe_ids.shape
    nlist, _, cap = codes_t.shape
    cap_s = _effective_cap(cap, scan_capacity)
    # Per-pair depth: the final top-k needs k candidates over nprobe lists,
    # and more than cap_s per list means nothing.
    ki = k if k_inner is None or emit_full else min(
        max(k_inner, -(-k // nprobe)), cap_s, k)
    global_cap = global_capacity if global_capacity is not None else cap
    kernel_counts = _local_counts(counts, cap, slot_stride, slot_offset)
    n_pairs = batch * nprobe
    m = m_budget or auto_m_budget(n_pairs, nlist)
    if m_limit is not None:
        m = min(m, m_limit)
    with record_function("grouped_pq_scan.pack"):
        pack = _pack_pairs_into_rows(probe_ids, nlist, m,
                                     _n_rows_bound(n_pairs, nlist, m))
    with record_function("grouped_pq_scan.rows"):
        out_d, out_s = rows_fn(
            queries.float().contiguous(), codes_t, code_sq, kernel_counts,
            centroids.float().contiguous(), codebooks.float().contiguous(),
            pack.row_list, pack.qrow_table, ki, metric, cap_s,
            emit_full=emit_full,
        )
    with record_function("grouped_pq_scan.epilogue"):
        if emit_full:
            return _full_row_epilogue(out_d, pack, batch, nprobe, k, nlist,
                                      global_cap, slot_stride, slot_offset)
        return _grouped_epilogue(out_d, out_s, pack, batch, nprobe, k, nlist,
                                 global_cap, slot_stride, slot_offset,
                                 k_inner=ki)


def scan_probed_codes_grouped(
    queries: torch.Tensor,
    codes_t: torch.Tensor,
    code_sq: torch.Tensor,
    counts: torch.Tensor,
    centroids: torch.Tensor,
    codebooks: torch.Tensor,
    probe_ids: torch.Tensor,
    k: int,
    metric: Metric = Metric.L2,
    m_budget: int | None = None,
    slot_stride: int = 1,
    slot_offset: int = 0,
    global_capacity: int | None = None,
    k_inner: int | None = None,
    emit_full: bool = False,
    scan_capacity: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped ADC scan of each query's probed lists; returns ``(dists
    [B, k] ascending, pos [B, k] int32 global positions, -1 for empty)``.

    ``queries [B, D]`` fp32 (normalized by the caller for cosine, which
    passes ``Metric.L2``), ``codes_t [nlist, m, cap]`` uint8,
    ``code_sq [nlist, cap]`` fp32 ‖c_l + r̂‖², ``counts [nlist]`` int32,
    ``centroids [nlist, D]``, ``codebooks [m, 256, dsub]``, ``probe_ids
    [B, P]`` int32 (−1 = no probe). On CUDA tensors the per-row step is the
    hand-written kernel (list-row width clamped to what its shared memory
    holds; k, or the ``k_inner`` depth, ≤ 64 unless ``emit_full``); on CPU
    tensors it is the plain version. ``k_inner`` and ``emit_full`` are the
    shortlist and full-row modes of the module docstring (``emit_full``
    overrides ``k_inner``); ``m_budget``, ``scan_capacity`` and the
    striping arguments are those of ``scan_probed_lists_grouped``.
    """
    if codes_t.is_cuda:
        rows_fn = _grouped_pq_rows_cuda     # raises for a depth > KMAX
        m_limit = kernel_max_m(codes_t.shape[1] * codebooks.shape[2])
    else:
        rows_fn, m_limit = _grouped_pq_rows_reference, None
    return _scan_codes_grouped(
        rows_fn, queries, codes_t, code_sq, counts, centroids, codebooks,
        probe_ids, k, metric, m_budget, slot_stride, slot_offset,
        global_capacity, k_inner, emit_full, scan_capacity, m_limit,
    )


def scan_probed_codes_grouped_reference(
    queries: torch.Tensor,
    codes_t: torch.Tensor,
    code_sq: torch.Tensor,
    counts: torch.Tensor,
    centroids: torch.Tensor,
    codebooks: torch.Tensor,
    probe_ids: torch.Tensor,
    k: int,
    metric: Metric = Metric.L2,
    m_budget: int | None = None,
    slot_stride: int = 1,
    slot_offset: int = 0,
    global_capacity: int | None = None,
    k_inner: int | None = None,
    emit_full: bool = False,
    scan_capacity: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`scan_probed_codes_grouped` with the plain PyTorch per-row
    step on any device (no kernel, no launch count)."""
    return _scan_codes_grouped(
        _grouped_pq_rows_reference, queries, codes_t, code_sq, counts,
        centroids, codebooks, probe_ids, k, metric, m_budget, slot_stride,
        slot_offset, global_capacity, k_inner, emit_full, scan_capacity,
    )
