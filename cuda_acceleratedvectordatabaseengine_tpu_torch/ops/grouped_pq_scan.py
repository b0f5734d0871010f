"""Grouped ADC scan over PQ codes: the port of the TPU kernel K2.

Counterpart of ``scan_probed_codes_pallas_grouped`` in
``cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py``. For every
(query, probed list) pair and each occupied slot of the list it computes
``qx = q·c_l + q·r̂_s`` (``r̂_s`` the slot's decoded residual) and the
distance (L2 ``max(‖q‖² − 2·qx + code_sq, 0)``, IP ``−qx``). Three output
modes:

- top-k: the k smallest per pair, then the epilogue over ``nprobe · k``;
- ``k_inner``: each pair keeps ``min(max(k_inner, ⌈k/nprobe⌉), cap_s, k)``
  and the epilogue runs over ``nprobe`` times that (a shortlist that an
  exact rerank absorbs);
- ``emit_full``: the masked full ``[B·P, cap_s]`` rows, then one top-k over
  the ``nprobe · cap_s`` union (exact at any depth).

The TPU kernel packed the pairs into list-rows and decoded each list with
one-hot MXU products (Mosaic has no gather). On Hopper the scan is
query-major and decodes nothing: the residual codebooks are shared by all
lists, so ``q·r̂_s = Σ_j T[b, j, codes_t[l, j, s]]`` with the per-query
inner-product table ``T[b, j, c] = q[b, j·dsub:(j+1)·dsub] · codebooks[j,
c]``. Two hand-written kernels in ``csrc/grouped_pq_scan.cu`` do the work
(:func:`_pq_tables_cuda`, :func:`_pq_pair_rows_cuda`): the table kernel
writes ``T [B, m, 256]`` fp32, and the scan kernel gives a CTA one query
and a group of its probes, holds the query's table in shared memory and
does ``m`` lookups and adds per slot. Rows come out per pair, in ``(b,
p)`` order; no pair packing, no permutation afterwards. What bounds it on
the card: the shared-memory lookups (random banks) and the codes each pair
re-reads: the function itself needs only the table product and ``m`` adds
per (pair, slot), and its inputs once; the source header has the numbers.

Beside the kernels sit the plain PyTorch versions of the same functions
(:func:`_pq_tables_reference`; :func:`_pq_pair_rows_reference`, which
decodes each pair's list and takes the D-long dot).
:func:`scan_probed_codes_grouped` takes the plain version for CPU tensors
and the kernels for CUDA tensors (it raises rather than fall back) and adds
one to :data:`LAUNCHES` per launch of the scan kernel;
:func:`scan_probed_codes_grouped_reference` always takes the plain version.
The row step and the epilogue run in the ``torch.profiler`` ranges
``grouped_pq_scan.rows`` (table kernel and scan kernel) and
``grouped_pq_scan.epilogue``; under ``emit_full`` the epilogue is the
shortlist's selection (one top-k over the full rows, a rerank's whole
shortlist) and runs in ``grouped_pq_scan.select``.
"""

from __future__ import annotations

import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.grouped_scan import (
    KMAX,
    _effective_cap,
    _local_counts,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
    topk_smallest,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.profiling import (
    trace,
)

# Launches of the scan kernel made by _pq_pair_rows_cuda since the process
# started (or since a caller last reset it): lets a run show it went
# through K2.
LAUNCHES = 0

KS = 256  # codewords per subspace: the kernel takes 8-bit codes
_METRIC_IDS = {Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2}
# Bound on the fp32 decoded-block transient of the plain version (bytes).
_REFERENCE_CHUNK_BYTES = 1 << 28
# Bound on the table transient [B_chunk, m, 256] fp32 of the kernel path
# (bytes): a larger batch goes through in query chunks (2730 queries a chunk
# at m 96).
TABLE_BYTES = 1 << 28
# Opt-in dynamic shared memory of one CTA on Hopper (227 KB).
_SMEM_LIMIT = 232448
_WARPS = 8           # warps of a scan CTA: one probed list each at a time
_CTAS_PER_SM = 2     # resident scan CTAs an SM (a 96 KB table each at m 96)


def table_fits_smem(msub: int, dim: int) -> bool:
    """Whether one query's table (``m · 256`` fp32) and the query fit the
    shared memory of a scan CTA: m ≤ 224 at D 768."""
    return msub * KS * 4 + 4 * ((dim + 3) & ~3) <= _SMEM_LIMIT


def probes_per_cta(batch: int, nprobe: int, sm_count: int) -> int:
    """How many of a query's probes one scan CTA takes. A CTA holds one
    query's table, so the fewest CTAs load the fewest tables (at B 512,
    nprobe 32 on an H100 the scan took 0.46 ms with 32 probes a CTA, 0.48
    with 16, 0.50 with 8, 0.81 with 4); but a small batch must still fill
    the card's resident CTA slots (two an SM), and a CTA's 8 warps take one
    list each at a time. So: the probes are split until the grid has a
    CTA per slot (each probe its own CTA at most), and a group of more
    than 8 is rounded up to a multiple of 8."""
    target = _CTAS_PER_SM * sm_count
    groups = min(nprobe, max(1, -(-target // batch)))
    ppc = -(-nprobe // groups)
    if ppc > _WARPS:
        ppc = -(-ppc // _WARPS) * _WARPS
    return min(ppc, nprobe)


def _pq_tables_reference(q, codebooks):
    """Plain PyTorch version of the table kernel: ``T [B, m, 256]`` fp32,
    ``T[b, j, c] = Σ_e q[b, j·dsub + e] · codebooks[j, c, e]``."""
    msub, ks, dsub = codebooks.shape
    qs = q.float().reshape(q.shape[0], msub, 1, dsub)
    return (qs * codebooks.float()[None]).sum(-1)


def _pq_pair_rows_reference(q, codes_t, code_sq, counts, centroids, codebooks,
                            probe, k, metric, cap_s, emit_full=False):
    """Plain PyTorch version of the scan. Top-k mode: ``(out_d, out_s)`` of
    shape ``[B·P, k]``, row ``b·P + p`` holding the k smallest ``(distance,
    slot)`` pairs of query b in list ``probe[b, p]``, ascending, ties to
    the smaller slot, (+inf, -1) for probe -1, a list id ≥ nlist and lists
    shorter than k. ``emit_full``: ``(out_d [B·P, cap_s], None)``, the
    masked rows. Decodes each pair's list with a codebook gather and takes
    the D-long dot ``qx = q·c_l + q·r̂`` (not the table sum of the kernel).
    Works in pair chunks to bound the fp32 decoded-block transient."""
    batch, nprobe = probe.shape
    nlist, msub, _ = codes_t.shape
    dsub = codebooks.shape[2]
    dim = msub * dsub
    dev = q.device
    n_pairs = batch * nprobe
    width = cap_s if emit_full else k
    out_d = torch.full((n_pairs, width), float("inf"), device=dev)
    out_s = (None if emit_full else
             torch.full((n_pairs, k), -1, dtype=torch.int32, device=dev))
    flat = probe.reshape(-1).long()
    pair_b = torch.arange(n_pairs, device=dev) // nprobe
    chunk = max(1, _REFERENCE_CHUNK_BYTES // (4 * cap_s * dim))
    slot = torch.arange(cap_s, device=dev)
    sub = torch.arange(msub, device=dev)[None, :, None]
    cb = codebooks.float()
    for p0 in range(0, n_pairs, chunk):
        lists = flat[p0:p0 + chunk]
        real = (lists >= 0) & (lists < nlist)
        safe = lists.clamp(0, nlist - 1)
        qr = q[pair_b[p0:p0 + chunk]]                             # [R, D]
        codes = codes_t[safe, :, :cap_s].long()                   # [R, j, c]
        dec = cb[sub, codes]                                      # [R, j, c, s]
        dec = dec.permute(0, 2, 1, 3).reshape(safe.shape[0], cap_s, dim)
        qx = torch.bmm(dec, qr[:, :, None])[..., 0]               # [R, c]
        qx = qx + (qr * centroids[safe]).sum(-1, keepdim=True)
        if metric == Metric.L2:
            q_sq = (qr * qr).sum(-1, keepdim=True)
            d = (q_sq - 2.0 * qx + code_sq[safe, :cap_s]).clamp_min(0.0)
        elif metric == Metric.INNER_PRODUCT:
            d = -qx
        else:
            d = 1.0 - qx
        valid = (slot[None, :] < counts[safe].long()[:, None]) & real[:, None]
        d = torch.where(valid, d, float("inf"))
        if emit_full:
            out_d[p0:p0 + chunk] = d
            continue
        kk = min(k, cap_s)
        vals, cols = torch.sort(d, dim=-1, stable=True)
        vals, cols = vals[..., :kk], cols[..., :kk]
        out_d[p0:p0 + chunk, :kk] = vals
        out_s[p0:p0 + chunk, :kk] = torch.where(
            torch.isfinite(vals), cols, -1
        ).int()
    return out_d, out_s


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"grouped PQ scan kernel: {msg}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_query_args(q, codebooks):
    """Checks shared by the two kernels' wrappers; returns ``(msub, dim)``."""
    dev = codebooks.device
    _check(dev.type == "cuda", f"codebooks are on {dev}, not a CUDA device")
    _check(codebooks.dtype == torch.float32 and codebooks.dim() == 3
           and codebooks.shape[1] == KS and codebooks.is_contiguous(),
           f"codebooks must be contiguous [m, {KS}, dsub] float32, got "
           f"{tuple(codebooks.shape)} {codebooks.dtype}")
    msub = codebooks.shape[0]
    dim = msub * codebooks.shape[2]
    _check(q.device == dev and q.dtype == torch.float32 and q.dim() == 2
           and q.shape[1] == dim and q.shape[0] >= 1 and q.is_contiguous(),
           f"q must be contiguous [B, {dim}] float32 on {dev}")
    return msub, dim


def _pq_tables_cuda(q, codebooks):
    """Launch the hand-written table kernel on the current CUDA stream:
    ``T [B, m, 256]`` fp32 (same contract as :func:`_pq_tables_reference`).
    Raises on anything the kernel does not take and if the launch is
    refused."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops._build import (
        load_library,
    )

    msub, dim = _check_query_args(q, codebooks)
    dev = q.device
    table = torch.empty((q.shape[0], msub, KS), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = load_library().vdb_pq_tables(
            _ptr(q), _ptr(codebooks), _ptr(table), q.shape[0], dim, msub,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"PQ table kernel launch failed: cudaError {err}")
    return table


def _pq_pair_rows_cuda(q, codes_t, code_sq, counts, centroids, codebooks,
                       probe, k, metric, cap_s, emit_full=False):
    """Launch the hand-written kernels (same contract as
    :func:`_pq_pair_rows_reference`) on the current CUDA stream: the table
    kernel, then the scan kernel, once per query chunk of at most
    :data:`TABLE_BYTES` of table. The scan kernel holds each query's table
    in shared memory where :func:`table_fits_smem` says it fits, and reads
    it in place (from global memory, through L2) where it does not: chosen
    here, by shape. Checks device, dtype, shape and contiguity and
    raises on anything the kernels do not take; raises if a launch is
    refused."""
    global LAUNCHES
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops._build import (
        load_library,
    )

    msub, dim = _check_query_args(q, codebooks)
    dev = codes_t.device
    tensors = {
        "q": q, "codes_t": codes_t, "code_sq": code_sq, "counts": counts,
        "centroids": centroids, "probe": probe,
    }
    for name, t in tensors.items():
        _check(t.device == dev, f"{name} is on {t.device}, codes on {dev}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(codes_t.dim() == 3 and codes_t.dtype == torch.uint8
           and codes_t.shape[1] == msub,
           f"codes_t must be [nlist, {msub}, cap] uint8, got "
           f"{tuple(codes_t.shape)} {codes_t.dtype}")
    nlist, _, cap = codes_t.shape
    _check(code_sq.dtype == torch.float32
           and tuple(code_sq.shape) == (nlist, cap),
           "code_sq must be [nlist, cap] float32")
    _check(counts.dtype == torch.int32 and tuple(counts.shape) == (nlist,),
           "counts must be [nlist] int32")
    _check(centroids.dtype == torch.float32
           and tuple(centroids.shape) == (nlist, dim),
           f"centroids must be [nlist, {dim}] float32")
    _check(probe.dtype == torch.int32 and probe.dim() == 2
           and probe.shape[0] == q.shape[0] and probe.shape[1] >= 1,
           "probe must be [B, P] int32")
    _check(emit_full or 1 <= k <= KMAX, f"k={k} outside 1..{KMAX}")
    _check(1 <= cap_s <= cap, f"cap_s={cap_s} outside 1..{cap}")
    _check(metric in _METRIC_IDS, f"unknown metric {metric}")

    batch, nprobe = probe.shape
    width = cap_s if emit_full else k
    out_d = torch.empty((batch * nprobe, width), dtype=torch.float32,
                        device=dev)
    out_s = (None if emit_full else
             torch.empty((batch * nprobe, k), dtype=torch.int32, device=dev))
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    step = max(1, TABLE_BYTES // (msub * KS * 4))
    lib = load_library()
    for b0 in range(0, batch, step):
        nb = min(step, batch - b0)
        qc = q[b0:b0 + nb]
        table = _pq_tables_cuda(qc, codebooks)
        ppc = probes_per_cta(nb, nprobe, sm_count)
        pair0 = b0 * nprobe
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.vdb_grouped_pq_scan(
                _ptr(qc), _ptr(table), _ptr(codes_t), _ptr(code_sq),
                _ptr(counts), _ptr(centroids), _ptr(probe[b0:b0 + nb]),
                _ptr(out_d[pair0:]),
                None if emit_full else _ptr(out_s[pair0:]), nb, nprobe,
                ppc, dim, msub, nlist, cap, cap_s, 0 if emit_full else k,
                int(emit_full), _METRIC_IDS[metric],
                int(table_fits_smem(msub, dim)), stream,
            )
        if err != 0:
            raise RuntimeError(
                f"grouped PQ scan kernel launch failed: cudaError {err}"
            )
        LAUNCHES += 1
    return out_d, out_s


def _pair_epilogue(out_d, out_s, probe_ids, k, nlist, global_cap,
                   slot_stride, slot_offset):
    """Per-pair rows ``[B·P, w]`` in ``(b, p)`` order (top-k rows with their
    slots, or full rows when ``out_s`` is None) to the final top-k per
    query: local slots map to logical ones under striping, (list, slot) to
    global positions, invalid candidates to (+inf, -1)."""
    batch, nprobe = probe_ids.shape
    w = out_d.shape[1]
    lists = probe_ids.reshape(-1, 1).long()
    if out_s is None:
        slots = torch.arange(w, device=out_d.device)[None, :]
        real = torch.isfinite(out_d)
    else:
        slots = out_s.long()
        real = (slots >= 0) & torch.isfinite(out_d)
    real = real & (lists >= 0) & (lists < nlist)
    d = torch.where(real, out_d, float("inf"))
    pos = torch.where(
        real, lists * global_cap + slots * slot_stride + slot_offset, -1
    ).int()
    return topk_smallest(d.reshape(batch, nprobe * w), k,
                         idx=pos.reshape(batch, nprobe * w))


def _scan_codes_grouped(rows_fn, queries, codes_t, code_sq, counts,
                        centroids, codebooks, probe_ids, k, metric,
                        slot_stride, slot_offset, global_capacity, k_inner,
                        emit_full, scan_capacity):
    nprobe = probe_ids.shape[1]
    nlist, _, cap = codes_t.shape
    cap_s = _effective_cap(cap, scan_capacity)
    # Per-pair depth: the final top-k needs k candidates over nprobe lists,
    # and more than cap_s per list means nothing.
    ki = k if k_inner is None or emit_full else min(
        max(k_inner, -(-k // nprobe)), cap_s, k)
    global_cap = global_capacity if global_capacity is not None else cap
    kernel_counts = _local_counts(counts, cap, slot_stride, slot_offset)
    probe = probe_ids.int().contiguous()
    with trace("grouped_pq_scan.rows"):
        out_d, out_s = rows_fn(
            queries.float().contiguous(), codes_t, code_sq, kernel_counts,
            centroids.float().contiguous(), codebooks.float().contiguous(),
            probe, ki, metric, cap_s, emit_full=emit_full,
        )
    with trace("grouped_pq_scan.select" if emit_full
               else "grouped_pq_scan.epilogue"):
        return _pair_epilogue(out_d, out_s, probe, k, nlist, global_cap,
                              slot_stride, slot_offset)


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
    [B, P]`` int32 (−1 = no probe). On CUDA tensors the row step is the
    hand-written kernels (table, then query-major scan; k, or the
    ``k_inner`` depth, ≤ 64 unless ``emit_full``); on CPU tensors it is the
    plain version. ``k_inner`` and ``emit_full`` are the shortlist and
    full-row modes of the module docstring (``emit_full`` overrides
    ``k_inner``); ``scan_capacity`` and the striping arguments are those of
    ``scan_probed_lists_grouped``. The TPU kernel's ``m_budget`` (its
    list-row width) has no counterpart: this scan packs no list-rows.
    """
    rows_fn = (_pq_pair_rows_cuda if codes_t.is_cuda   # raises for ki > KMAX
               else _pq_pair_rows_reference)
    return _scan_codes_grouped(
        rows_fn, queries, codes_t, code_sq, counts, centroids, codebooks,
        probe_ids, k, metric, slot_stride, slot_offset, global_capacity,
        k_inner, emit_full, scan_capacity,
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
    slot_stride: int = 1,
    slot_offset: int = 0,
    global_capacity: int | None = None,
    k_inner: int | None = None,
    emit_full: bool = False,
    scan_capacity: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`scan_probed_codes_grouped` with the plain PyTorch row step on
    any device (no kernel, no launch count)."""
    return _scan_codes_grouped(
        _pq_pair_rows_reference, queries, codes_t, code_sq, counts,
        centroids, codebooks, probe_ids, k, metric, slot_stride, slot_offset,
        global_capacity, k_inner, emit_full, scan_capacity,
    )
