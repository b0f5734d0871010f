#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives ``cuda_acceleratedvectordatabaseengine_tpu_torch`` (the PyTorch /
CUDA port; it imports no JAX) through the entry points a user calls, and
fails (non-zero exit, no result line) when any phase fails:

0. device: requires CUDA; prints ``nvidia-smi`` name and power limit;
1. build: compiles the kernel sources of the checkout (``csrc/*.cu``, one
   ``nvcc`` per source, all started together);
2. K1 vs plain: the grouped-scan kernel against its plain PyTorch version
   on the card, at the main-path shape and at small shapes that cover
   every metric, arena dtype and edge case; both times;
2b. K2 vs plain: the grouped ADC kernel against its plain version, on small
   cases (IP, -1 probes, short lists, ``k_inner``, emit_full, the
   scan-capacity prefix, a hot list, D 30 with m 6, k 64) and at the
   IVF-PQ main shape in top-k (k 10) and emit_full (keep 40) modes; both
   times;
3. README quick start through the port (bf16 arena, 100K x 128);
4. the IVF-Flat main path at a deployment size (default 1M x 768, int8
   residual, nlist 1024): ``train_from_device``, ``append_balanced`` in
   chunks with a fixed capacity, ``calibrate_nprobe``, batched search;
   prints ingest rate, QPS, recall@10 against an exact fp32 oracle on the
   card and K1's launch count during this phase (read before the checks
   below);
5. K1 against its plain version on the built index, at the calibrated
   nprobe and at nprobe 32 (the shapes the main path serves);
6. one IVF-Flat search per nprobe under ``torch.profiler``: device and
   host time of each named stage, device idle share, the heaviest kernels;
7. the IVF-PQ path at full width (1M x 768, nlist 4096, m 96, bf16 raw
   rows, anisotropic corpus generated on the card): ``train_from_device``,
   ``reserve``, ``add_from_device`` in 125K slices, ``calibrate_nprobe``,
   512-query batches at the calibrated nprobe and at 32, each with and
   without the exact rerank; prints recall@10, QPS, ingest, train time,
   code and raw GB and K2's launch count per setting (each must be > 0;
   recall@10 with rerank at nprobe 32 must reach 0.90);
8. K2 against its plain version on the built index in both served modes;
9. one IVF-PQ search per served setting under ``torch.profiler``;
10. a small OPQ index (100K x 768, nlist 256) beside plain PQ: the rotation
   must be an isometry (max|R^T R - I| <= 2e-5); ADC-only recall of both.

The second-to-last line is the kernel report JSON; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py                         # IVF-Flat 1M x 768 + IVF-PQ 1M
    python3 chip_smoke.py --n 10000000 --nlist 4096   # 10M x 768
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
K1_SOURCE = "cuda_acceleratedvectordatabaseengine_tpu_torch/csrc/grouped_scan.cu"
K1_REPLACES = "cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py:698"
K2_SOURCE = ("cuda_acceleratedvectordatabaseengine_tpu_torch/csrc/"
             "grouped_pq_scan.cu")
K2_REPLACES = "cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py:996"
RTOL = 1e-5          # distance tolerance, relative ...
ATOL_QSQ = 1e-5      # ... plus this × ‖q‖² (fp32 sums in another order)


def log(*parts) -> None:
    print(*parts, flush=True)


def ptxas_summary(nvcc_log: str) -> dict:
    """Registers and spill stores per compiled function, from the
    ``-Xptxas -v`` report of the kernel build."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", nvcc_log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                         nvcc_log)]
    return {
        "ptxas_functions": len(regs),
        "registers_min": min(regs, default=None),
        "registers_max": max(regs, default=None),
        "functions_spilling": sum(s > 0 for s in spills),
        "spill_store_bytes_max": max(spills, default=None),
    }


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs (CUDA events,
    after ``warmup`` runs)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# --------------------------------------------------------------------------- #
# phase 2: kernel against its plain version
# --------------------------------------------------------------------------- #

def make_scan_case(gen, dev, *, nlist, cap, dim, batch, nprobe, dtype,
                   metric, anchors=True, short=False, neg=False,
                   max_count=None):
    """A packed arena on the card with clustered rows (one gaussian ball per
    list), queries near stored rows, and coarse probes by centroid
    distance: the pair pattern a real batch produces."""
    import torch

    from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
        _append_device,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
        Metric, pairwise_distance,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.normalize import (
        l2_normalize,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
        topk_smallest,
    )

    hi = max_count or cap
    counts = torch.randint(hi // 2, hi + 1, (nlist,), generator=gen,
                           device=dev, dtype=torch.int32)
    if short:
        counts[: nlist // 2] = torch.randint(0, 4, (nlist // 2,),
                                             generator=gen, device=dev,
                                             dtype=torch.int32)
    centers = torch.randn((nlist, dim), generator=gen, device=dev)
    arena = torch.zeros((nlist, cap, dim), dtype=dtype, device=dev)
    arena_sq = torch.zeros((nlist, cap), device=dev)
    scale = (torch.zeros((nlist, cap), device=dev)
             if dtype == torch.int8 else None)
    anc = centers if (dtype == torch.int8 and anchors) else None
    slot = torch.arange(cap, device=dev)
    lists = torch.arange(nlist, device=dev)[:, None].expand(nlist, cap)
    live = slot[None, :] < counts[:, None].long()
    li, si = lists[live], slot.expand(nlist, cap)[live]
    rows = centers[li] + 0.25 * torch.randn((li.numel(), dim), generator=gen,
                                            device=dev)
    if metric == Metric.COSINE:
        rows = l2_normalize(rows)
    for s0 in range(0, li.numel(), 1 << 18):
        _append_device(arena, arena_sq, scale, anc, li[s0:s0 + (1 << 18)],
                       si[s0:s0 + (1 << 18)], rows[s0:s0 + (1 << 18)])
    pick = torch.randint(0, rows.shape[0], (batch,), generator=gen,
                         device=dev)
    q = rows[pick] + 0.1 * torch.randn((batch, dim), generator=gen,
                                       device=dev)
    if metric == Metric.COSINE:
        q = l2_normalize(q)
    _, probe = topk_smallest(pairwise_distance(q, centers, metric), nprobe)
    probe = probe.int()
    if neg:
        probe[::3, -1] = -1
    return dict(q=q, arena=arena, arena_sq=arena_sq, counts=counts,
                probe=probe, arena_scale=scale, arena_anchors=anc)


def check_scan_case(name, case, k, metric, m_budget=None, scan_capacity=None,
                    time_it=False):
    """Kernel vs plain version on one case; raises on disagreement."""
    import torch

    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
        grouped_scan as gs,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
        assert_topk_match,
    )

    args = (case["q"], case["arena"], case["arena_sq"], case["counts"],
            case["probe"], k, metric)
    kw = dict(m_budget=m_budget, arena_scale=case["arena_scale"],
              arena_anchors=case["arena_anchors"],
              scan_capacity=scan_capacity)
    d_k, p_k = gs.scan_probed_lists_grouped(*args, **kw)
    torch.cuda.synchronize()
    d_p, p_p = gs.scan_probed_lists_grouped_reference(*args, **kw)
    q = case["q"]
    atol = (ATOL_QSQ * (q * q).sum(1)).cpu().numpy()
    cmp = assert_topk_match(d_k.cpu().numpy(), p_k.cpu().numpy(),
                            d_p.cpu().numpy(), p_p.cpu().numpy(),
                            rtol=RTOL, atol=atol)
    out = {"case": name, "max_abs_err": cmp.max_abs_err,
           "id_differences_at_ties": cmp.n_id_differences,
           "entries": cmp.n_entries}
    if time_it:
        # the step the kernel replaces (one launch per call) ...
        nlist, cap, dim = case["arena"].shape
        batch, nprobe = case["probe"].shape
        m = min(m_budget or gs.auto_m_budget(batch * nprobe, nlist),
                gs.kernel_max_m(dim, case["arena"].dtype))
        pack = gs._pack_pairs_into_rows(
            case["probe"], nlist, m, gs._n_rows_bound(batch * nprobe, nlist,
                                                      m))
        cap_s = gs._effective_cap(cap, scan_capacity)
        rows_args = (q.contiguous(), case["arena"], case["arena_sq"],
                     case["counts"], pack.row_list, pack.qrow_table, k,
                     metric, cap_s)
        rows_kw = dict(arena_scale=case["arena_scale"],
                       arena_anchors=case["arena_anchors"])
        rk = gs._grouped_rows_cuda(*rows_args, **rows_kw)
        rp = gs._grouped_rows_reference(*rows_args, **rows_kw)
        n_rows = pack.row_list.shape[0]
        rcmp = assert_topk_match(
            rk[0].reshape(n_rows * m, k).cpu().numpy(),
            rk[1].reshape(n_rows * m, k).cpu().numpy(),
            rp[0].reshape(n_rows * m, k).cpu().numpy(),
            rp[1].reshape(n_rows * m, k).cpu().numpy(),
            rtol=RTOL, atol=float(atol.max()),
        )
        out.update(
            m=m, n_rows=n_rows,
            rows_max_abs_err=rcmp.max_abs_err,
            ms=cuda_ms(lambda: gs._grouped_rows_cuda(*rows_args, **rows_kw),
                       10),
            plain_ms=cuda_ms(
                lambda: gs._grouped_rows_reference(*rows_args, **rows_kw), 5),
            scan_ms=cuda_ms(lambda: gs.scan_probed_lists_grouped(*args, **kw),
                            10),
            scan_plain_ms=cuda_ms(
                lambda: gs.scan_probed_lists_grouped_reference(*args, **kw),
                5),
        )
    log("phase2", json.dumps(out))
    return out


def phase_kernel_vs_plain(seed: int, dev) -> dict:
    import torch

    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
        Metric,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    small = [
        ("ip_f32_neg", dict(nlist=16, cap=256, dim=64, batch=48, nprobe=6,
                            dtype=torch.float32, metric=Metric.INNER_PRODUCT,
                            neg=True), 10, None, None),
        ("cos_bf16", dict(nlist=16, cap=256, dim=64, batch=48, nprobe=6,
                          dtype=torch.bfloat16, metric=Metric.COSINE), 10, 16,
         None),
        ("l2_bf16_short", dict(nlist=32, cap=256, dim=96, batch=64, nprobe=8,
                               dtype=torch.bfloat16, metric=Metric.L2,
                               short=True), 10, None, None),
        ("l2_f32_odd_dim", dict(nlist=8, cap=128, dim=30, batch=16, nprobe=4,
                                dtype=torch.float32, metric=Metric.L2), 7, 8,
         None),
        ("l2_i8_raw_k40", dict(nlist=16, cap=384, dim=128, batch=64, nprobe=8,
                               dtype=torch.int8, metric=Metric.L2,
                               anchors=False), 40, None, None),
        ("l2_i8_scan_capacity", dict(nlist=16, cap=512, dim=128, batch=64,
                                     nprobe=8, dtype=torch.int8,
                                     metric=Metric.L2, max_count=200), 10,
         None, 200),
        ("ip_i8_hot_list", dict(nlist=4, cap=384, dim=64, batch=256, nprobe=2,
                                dtype=torch.int8,
                                metric=Metric.INNER_PRODUCT), 10, 16, None),
    ]
    for name, spec, k, m, scap in small:
        check_scan_case(name, make_scan_case(gen, dev, **spec), k,
                        spec["metric"], m_budget=m, scan_capacity=scap)
    main = make_scan_case(gen, dev, nlist=1024, cap=1408, dim=768,
                          batch=1024, nprobe=32, dtype=torch.int8,
                          metric=Metric.L2)
    res = check_scan_case("main_int8_residual_768", main, 10, Metric.L2,
                          time_it=True)
    del main
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------- #
# phase 2b: K2 against its plain version
# --------------------------------------------------------------------------- #

def make_pq_case(gen, dev, *, nlist, cap, msub, dsub, batch, nprobe, metric,
                 counts=(1, None), short=False, neg=False, hot=False):
    """PQ state on the card: random 8-bit codes over random codebooks, the
    stored norms ‖c_l + r̂‖², counts drawn from ``counts`` (lo, hi; hi None
    = cap), queries near random centroids and coarse probes by centroid
    distance (about as many pairs per list as a real batch gives)."""
    import torch

    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
        pairwise_distance,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
        topk_smallest,
    )

    dim = msub * dsub
    lo, hi = counts[0], counts[1] or cap
    cnt = torch.randint(lo, hi + 1, (nlist,), generator=gen, device=dev,
                        dtype=torch.int32)
    if short:
        cnt[: nlist // 2] = torch.randint(0, 4, (nlist // 2,), generator=gen,
                                          device=dev, dtype=torch.int32)
    cen = torch.randn((nlist, dim), generator=gen, device=dev)
    cb = 0.3 * torch.randn((msub, 256, dsub), generator=gen, device=dev)
    codes_t = torch.randint(0, 256, (nlist, msub, cap), generator=gen,
                            device=dev, dtype=torch.uint8)
    code_sq = torch.empty((nlist, cap), device=dev)
    sub = torch.arange(msub, device=dev)[None, :, None]
    for l0 in range(0, nlist, 64):
        dec = cb[sub, codes_t[l0:l0 + 64].long()]         # [L, j, cap, s]
        x = dec.permute(0, 2, 1, 3).reshape(-1, cap, dim) + cen[l0:l0 + 64,
                                                                None]
        code_sq[l0:l0 + 64] = (x * x).sum(-1)
    home = torch.randint(0, nlist, (batch,), generator=gen, device=dev)
    q = cen[home] + 0.3 * torch.randn((batch, dim), generator=gen,
                                      device=dev)
    _, probe = topk_smallest(pairwise_distance(q, cen, metric), nprobe)
    probe = probe.int()
    if neg:
        probe[::3, -1] = -1
    if hot:
        probe[:, 0] = 0                     # every query probes list 0
    return dict(q=q, codes_t=codes_t, code_sq=code_sq, counts=cnt, cen=cen,
                cb=cb, probe=probe)


def compare_full_rows(rk, rp, atol: float) -> float:
    """Full distance rows of the kernel against the plain version: +inf in
    the same places, finite entries within RTOL / ``atol``. Returns the
    largest difference."""
    import torch

    fk, fp = torch.isfinite(rk), torch.isfinite(rp)
    if not torch.equal(fk, fp):
        raise AssertionError(f"full rows: {int((fk != fp).sum())} entries "
                             f"finite in one version only")
    err = (rk[fk] - rp[fp]).abs()
    bound = atol + RTOL * rp[fp].abs()
    if bool((err > bound).any()):
        raise AssertionError(f"full rows: largest difference "
                             f"{float(err.max())} over its bound")
    return float(err.max()) if err.numel() else 0.0


def check_pq_case(name, case, k, metric, m_budget=None, scan_capacity=None,
                  k_inner=None, emit_full=False, time_it=False):
    """K2 against its plain version on one case (whole scan, and with
    ``time_it`` the per-row step alone, with both times); raises on
    disagreement."""
    import torch

    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
        grouped_pq_scan as gps,
        grouped_scan as gs,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
        assert_topk_match,
    )

    args = (case["q"], case["codes_t"], case["code_sq"], case["counts"],
            case["cen"], case["cb"], case["probe"], k, metric)
    kw = dict(m_budget=m_budget, scan_capacity=scan_capacity,
              k_inner=k_inner, emit_full=emit_full)
    d_k, p_k = gps.scan_probed_codes_grouped(*args, **kw)
    torch.cuda.synchronize()
    d_p, p_p = gps.scan_probed_codes_grouped_reference(*args, **kw)
    q = case["q"]
    atol = (ATOL_QSQ * (q * q).sum(1)).cpu().numpy()
    cmp = assert_topk_match(d_k.cpu().numpy(), p_k.cpu().numpy(),
                            d_p.cpu().numpy(), p_p.cpu().numpy(),
                            rtol=RTOL, atol=atol)
    out = {"case": name, "k": k, "mode": "emit_full" if emit_full else (
        "k_inner" if k_inner else "topk"), "max_abs_err": cmp.max_abs_err,
        "id_differences_at_ties": cmp.n_id_differences,
        "entries": cmp.n_entries}
    if time_it:
        nlist, msub, cap = case["codes_t"].shape
        dim = msub * case["cb"].shape[2]
        batch, nprobe = case["probe"].shape
        m = min(m_budget or gs.auto_m_budget(batch * nprobe, nlist),
                gps.kernel_max_m(dim))
        pack = gs._pack_pairs_into_rows(
            case["probe"], nlist, m, gs._n_rows_bound(batch * nprobe, nlist,
                                                      m))
        cap_s = gs._effective_cap(cap, scan_capacity)
        rows_args = (q.contiguous(), case["codes_t"], case["code_sq"],
                     case["counts"], case["cen"], case["cb"], pack.row_list,
                     pack.qrow_table, k, metric, cap_s)
        rk = gps._grouped_pq_rows_cuda(*rows_args, emit_full=emit_full)
        rp = gps._grouped_pq_rows_reference(*rows_args, emit_full=emit_full)
        n_rows = pack.row_list.shape[0]
        if emit_full:
            rows_err = compare_full_rows(rk[0], rp[0], float(atol.max()))
        else:
            rows_err = assert_topk_match(
                rk[0].reshape(n_rows * m, k).cpu().numpy(),
                rk[1].reshape(n_rows * m, k).cpu().numpy(),
                rp[0].reshape(n_rows * m, k).cpu().numpy(),
                rp[1].reshape(n_rows * m, k).cpu().numpy(),
                rtol=RTOL, atol=float(atol.max())).max_abs_err
        out.update(
            m=m, n_rows=n_rows, cap_s=cap_s, rows_max_abs_err=rows_err,
            ms=cuda_ms(lambda: gps._grouped_pq_rows_cuda(
                *rows_args, emit_full=emit_full), 10),
            plain_ms=cuda_ms(lambda: gps._grouped_pq_rows_reference(
                *rows_args, emit_full=emit_full), 5),
            scan_ms=cuda_ms(lambda: gps.scan_probed_codes_grouped(
                *args, **kw), 10),
            scan_plain_ms=cuda_ms(
                lambda: gps.scan_probed_codes_grouped_reference(*args, **kw),
                5),
        )
    log("phase2b", json.dumps(out))
    return out


def phase_pq_kernel_vs_plain(seed: int, dev) -> dict:
    """K2 on small cases covering each metric, mode and edge, then at the
    main shape of the IVF-PQ path (nlist 4096, m 96, D 768, cap 384, lists
    filled as a 1M build fills them, B 512, nprobe 32) in top-k mode at
    k 10 and in emit_full mode at keep 40, with both times."""
    import torch

    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
        Metric,
    )

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    base = dict(nlist=16, cap=256, msub=16, dsub=8, batch=48, nprobe=6)
    small = [
        ("l2_neg_short", dict(base, metric=Metric.L2, neg=True, short=True),
         dict(k=10)),
        ("ip_neg", dict(base, metric=Metric.INNER_PRODUCT, neg=True),
         dict(k=10, m_budget=16)),
        ("l2_k_inner", dict(base, metric=Metric.L2), dict(k=40, k_inner=4)),
        ("l2_emit_full_short", dict(base, metric=Metric.L2, short=True,
                                    neg=True), dict(k=40, emit_full=True)),
        ("ip_emit_full", dict(base, metric=Metric.INNER_PRODUCT),
         dict(k=40, emit_full=True)),
        ("l2_scan_capacity", dict(base, cap=512, counts=(1, 200),
                                  metric=Metric.L2),
         dict(k=10, scan_capacity=200)),
        ("l2_hot_list", dict(base, nlist=4, batch=256, nprobe=2, hot=True,
                             metric=Metric.L2), dict(k=10, m_budget=16)),
        ("l2_dim30_m6", dict(base, msub=6, dsub=5, metric=Metric.L2,
                             short=True), dict(k=7, m_budget=8)),
        ("l2_dim30_m6_full", dict(base, msub=6, dsub=5, metric=Metric.L2),
         dict(k=40, emit_full=True)),
        ("l2_k64", dict(base, metric=Metric.L2), dict(k=64)),
    ]
    for name, spec, kw in small:
        k = kw.pop("k")
        check_pq_case(name, make_pq_case(gen, dev, **spec), k, spec["metric"],
                      **kw)
    main = make_pq_case(gen, dev, nlist=4096, cap=384, msub=96, dsub=8,
                        batch=512, nprobe=32, metric=Metric.L2,
                        counts=(160, 330))
    res = {
        "topk_k10": check_pq_case("main_topk_k10", main, 10, Metric.L2,
                                  time_it=True),
        "emit_full_keep40": check_pq_case("main_emit_full_keep40", main, 40,
                                          Metric.L2, emit_full=True,
                                          time_it=True),
    }
    del main
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------- #
# phase 3: README quick start
# --------------------------------------------------------------------------- #

def phase_quickstart(dev) -> None:
    import numpy as np

    import cuda_acceleratedvectordatabaseengine_tpu_torch as vdb

    rng = np.random.default_rng(0)
    x = rng.standard_normal((100_000, 128)).astype(np.float32)
    t0 = time.perf_counter()
    idx = vdb.IVFFlatIndex(vdb.IVFFlatConfig(dimension=128, nlist=256),
                           device=dev)
    idx.train(x)
    idx.add(x)
    d, ids = idx.search(x[:8], vdb.SearchParams(nprobe=32, k=10))
    secs = time.perf_counter() - t0
    if not (ids[:, 0] == np.arange(8)).all():
        raise AssertionError(f"quick start: self-match failed {ids[:, 0]}")
    if not (np.isfinite(d).all() and d[:, 0].max() < 1e-2):
        raise AssertionError(f"quick start: bad distances {d[:, 0]}")
    log("phase3", json.dumps({
        "arena": str(idx.arena.dtype), "ids0": ids[:, 0].tolist(),
        "d0_max": float(d[:, 0].max()), "seconds": secs,
    }))


# --------------------------------------------------------------------------- #
# phase 4: the main path at a deployment size
# --------------------------------------------------------------------------- #

def corpus_chunk(centers, start, m, seed, noise=0.25):
    """Rows ``[start, start + m)`` of the mixture corpus: row g belongs to
    ball ``g % nlist`` (balanced lists), stored bf16, as the JAX package's
    benchmark generates it. Deterministic per (seed, start)."""
    import torch

    gen = torch.Generator(device=centers.device).manual_seed(
        seed * 1_000_003 + start)
    g = torch.arange(start, start + m, device=centers.device)
    pts = centers[g % centers.shape[0]] + noise * torch.randn(
        (m, centers.shape[1]), generator=gen, device=centers.device)
    return pts.to(torch.bfloat16)


def oracle_update(best_d, best_i, q, xc, base, k, block=1 << 18):
    """Exact fp32 top-k of ``q`` over the rows of ``xc`` merged into the
    running ``(best_d, best_i)`` (global row ids)."""
    import torch

    q_sq = (q * q).sum(1, keepdim=True)
    for s0 in range(0, xc.shape[0], block):
        xf = xc[s0:s0 + block].float()
        d = (q_sq - 2.0 * q @ xf.T + (xf * xf).sum(1)[None, :]).clamp_min(0)
        v, i = torch.topk(d, k, dim=1, largest=False)
        cat_d = torch.cat([best_d, v], 1)
        cat_i = torch.cat([best_i, i + base + s0], 1)
        best_d, sel = torch.topk(cat_d, k, dim=1, largest=False)
        best_i = torch.gather(cat_i, 1, sel)
    return best_d, best_i


def search_timed(idx, queries, params, reps):
    """Host-to-host searches of one batch (numpy in, numpy out), after one
    warm-up: (per-batch ms list, last result)."""
    res = idx.search(queries, params)
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = idx.search(queries, params)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, res


def recall_at(ids, truth, k=10) -> float:
    """Mean share of each query's exact top-k ids found in ``ids``."""
    import numpy as np

    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                          for a, b in zip(ids.astype(np.int64), truth)]))


# Named profiler ranges of one IVFFlatIndex.search (the package opens them).
SEARCH_STAGES = ("ivf_flat.upload", "ivf_flat.coarse_probe",
                 "grouped_scan.pack", "grouped_scan.rows",
                 "grouped_scan.epilogue", "ivf_flat.finalize")
# ... and of one IVFPQIndex.search.
PQ_SEARCH_STAGES = ("ivf_pq.upload", "ivf_pq.coarse_probe",
                    "grouped_pq_scan.pack", "grouped_pq_scan.rows",
                    "grouped_pq_scan.epilogue", "ivf_pq.rerank",
                    "ivf_pq.finalize")


def trace_search(idx, queries, params, batch_ms, top=6,
                 stage_names=SEARCH_STAGES,
                 kernel_stages=(("grouped_scan_kernel",
                                 "grouped_scan.rows"),)) -> dict:
    """One ``search`` of ``idx`` (after a warm-up) under
    ``torch.profiler``: device and host ms of each named stage, the sum of
    all device activity (busy), the idle share against ``batch_ms`` (the
    untraced median batch time) and against the traced batch, which the
    profiler slows on the host, and the heaviest device kernels. Device
    figures are "not measured" when the trace holds no device time.

    Each device event counts once, in the stage whose device-side range
    (the span of the device work its aten ops launched) holds it. The
    hand-written kernels are launched through ctypes, not aten ops, so the
    profiler ties them to no range: their events are found by kernel name
    (``kernel_stages``: name fragment → stage)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    idx.search(queries, params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.search"):
            idx.search(queries, params)
    events = prof.events()
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]

    def host_ms(name):
        return sum(e.cpu_time_total for e in on_host if e.name == name) / 1e3

    wall = host_ms("chip_smoke.search")
    spans = {e.name: e.time_range for e in on_device
             if e.is_user_annotation and e.name in stage_names}
    stages = {s: {"device_ms": 0.0, "host_ms": host_ms(s)}
              for s in stage_names}
    kernels: dict[str, float] = {}
    unattributed = 0.0
    for e in on_device:
        if e.is_user_annotation:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        kernels[e.name] = kernels.get(e.name, 0.0) + ms
        stage = next((st for frag, st in kernel_stages if frag in e.name),
                     None) or next(
            (s for s, r in spans.items() if r.start <= e.time_range.start
             and e.time_range.end <= r.end), None)
        if stage is None:
            unattributed += ms
        else:
            stages[stage]["device_ms"] += ms
    busy = sum(kernels.values())
    if busy <= 0:
        for s in stages.values():
            s["device_ms"] = "not measured"
        return {"traced_batch_ms": wall, "batch_ms": batch_ms,
                "device_busy_ms": "not measured",
                "idle_share": "not measured", "stages": stages}
    return {
        "traced_batch_ms": wall, "batch_ms": batch_ms,
        "device_busy_ms": busy,
        "idle_share": 1.0 - busy / batch_ms,
        "idle_share_traced": 1.0 - busy / wall,
        "unattributed_device_ms": unattributed,
        "stages": stages,
        "top_kernels": [[n[:90], v] for n, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:top]],
    }


def check_index_scan(idx, q_dev, nprobe, k) -> dict:
    """The search's device half as ``search`` runs it on this index (coarse
    probe, then the grouped scan through the kernel) against the plain
    version of the grouped scan on the same probes and the index's own
    arena; raises on disagreement. Also both scans' device times."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat import (
        _ivf_search_device,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
        grouped_scan as gs,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
        Metric,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.normalize import (
        l2_normalize,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
        assert_topk_match,
    )

    a = idx.arena
    kw = dict(arena_scale=a.arena_scale, arena_anchors=a.anchors,
              m_budget=idx.config.m_budget,
              scan_capacity=a.scan_capacity_hint())
    d_k, p_k, probes = _ivf_search_device(
        q_dev, idx.centroids, a.arena, a.arena_sq, a.counts, nprobe, k,
        idx.metric, "grouped", **kw)
    q = l2_normalize(q_dev) if idx.metric == Metric.COSINE else q_dev
    args = (q, a.arena, a.arena_sq, a.counts, probes, k, idx.metric)
    d_p, p_p = gs.scan_probed_lists_grouped_reference(*args, **kw)
    atol = (ATOL_QSQ * (q_dev * q_dev).sum(1)).cpu().numpy()
    cmp = assert_topk_match(d_k.cpu().numpy(), p_k.cpu().numpy(),
                            d_p.cpu().numpy(), p_p.cpu().numpy(),
                            rtol=RTOL, atol=atol)
    return {
        "nprobe": nprobe, "max_abs_err": cmp.max_abs_err,
        "id_differences_at_ties": cmp.n_id_differences,
        "entries": cmp.n_entries,
        "scan_ms": cuda_ms(lambda: gs.scan_probed_lists_grouped(*args, **kw),
                           10),
        "scan_plain_ms": cuda_ms(
            lambda: gs.scan_probed_lists_grouped_reference(*args, **kw), 3),
    }


def phase_main_path(args, dev):
    import numpy as np
    import torch

    import cuda_acceleratedvectordatabaseengine_tpu_torch as vdb
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
        grouped_scan,
    )

    n, dim, nlist, k = args.n, args.dim, args.nlist, 10
    chunk = -(-n // args.chunks)
    capacity = -(-math.ceil(1.35 * n / nlist) // 128) * 128
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    centers = torch.randn((nlist, dim), generator=gen, device=dev)
    cfg = vdb.IVFFlatConfig(dimension=dim, nlist=nlist, dtype="int8",
                            max_capacity_factor=4.0)
    idx = vdb.IVFFlatIndex(cfg, device=dev)

    # queries: corpus rows spread over all chunks + 0.1 noise
    qi = torch.sort(torch.randint(0, n, (args.batch,), generator=gen,
                                  device=dev)).values
    queries = torch.empty((args.batch, dim), device=dev)
    for s in range(0, n, chunk):
        sel = (qi >= s) & (qi < s + chunk)
        if sel.any():
            xc = corpus_chunk(centers, s, min(chunk, n - s), args.seed)
            queries[sel] = xc[qi[sel] - s].float()
    queries += 0.1 * torch.randn(queries.shape, generator=gen, device=dev)
    best_d = torch.full((args.batch, k), float("inf"), device=dev)
    best_i = torch.full((args.batch, k), -1, dtype=torch.long, device=dev)

    torch.cuda.reset_peak_memory_stats()
    train_s = append_s = oracle_s = 0.0
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        xc = corpus_chunk(centers, s, m, args.seed)
        torch.cuda.synchronize()
        if s == 0:
            t0 = time.perf_counter()
            idx.train_from_device(xc)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.append_balanced(xc, ids=np.arange(s, s + m, dtype=np.uint64),
                            capacity=capacity)
        torch.cuda.synchronize()
        append_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        best_d, best_i = oracle_update(best_d, best_i, queries, xc, s, k)
        torch.cuda.synchronize()
        oracle_s += time.perf_counter() - t0
        del xc
    counts = idx.arena.counts.cpu().numpy()
    if idx.ntotal != n or idx.arena.capacity != capacity:
        raise AssertionError(f"build: ntotal {idx.ntotal} capacity "
                             f"{idx.arena.capacity}, expected {n} {capacity}")
    truth = best_i.cpu().numpy()
    q_np = queries.cpu().numpy()

    t0 = time.perf_counter()
    cal = idx.calibrate_nprobe(queries=q_np[:512], target_coverage=0.99,
                               k=k)
    cal_s = time.perf_counter() - t0
    out = {
        "n": n, "dim": dim, "nlist": nlist, "capacity": capacity,
        "chunks": args.chunks, "arena_gb": idx.arena.nbytes_device() / 1e9,
        "counts_p50": int(np.percentile(counts, 50)),
        "counts_max": int(counts.max()),
        "train_s": train_s, "append_s": append_s,
        "ingest_mvec_per_min": n / append_s * 60 / 1e6,
        "oracle_s": oracle_s, "calibrate_s": cal_s,
        "calibrated_nprobe": cal["nprobe"],
        "calibrated_coverage": cal["coverage"],
        "coverage_curve": cal["curve"],
    }
    for label, nprobe in (("auto", 0), ("p32", 32)):
        launches0 = grouped_scan.LAUNCHES
        ms, (d, ids) = search_timed(
            idx, q_np, vdb.SearchParams(nprobe=nprobe, k=k), args.reps)
        if not (np.isfinite(d).all() and d.shape == (args.batch, k)):
            raise AssertionError(f"search {label}: bad distances")
        med = float(np.median(ms))
        out[f"search_k1_launches_{label}"] = grouped_scan.LAUNCHES - launches0
        out[f"qps_{label}"] = args.batch / med * 1e3
        out[f"ms_per_batch_median_{label}"] = med
        out[f"ms_per_batch_max_{label}"] = float(max(ms))
        out[f"recall10_{label}"] = recall_at(ids, truth, k)
    out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("phase4", json.dumps(out))
    for label in ("auto", "p32"):
        if out[f"search_k1_launches_{label}"] <= 0:
            raise AssertionError(f"search ({label}) never launched the K1 "
                                 f"kernel")
    if out["recall10_auto"] < 0.95:
        raise AssertionError(f"recall@10 {out['recall10_auto']} < 0.95")
    return out, idx, queries, q_np, min(cal["nprobe"], nlist)


def phase_index_checks(idx, queries, q_np, cal_nprobe, main_path,
                       k=10) -> dict:
    """After the main path's launch count is read: the kernel against its
    plain version on the built index at the served probe counts, and one
    traced search per probe count (where the batch's time goes)."""
    import cuda_acceleratedvectordatabaseengine_tpu_torch as vdb

    out = {}
    for label, nprobe in (("auto", cal_nprobe), ("p32", 32)):
        out[f"index_scan_{label}"] = check_index_scan(idx, queries, nprobe, k)
        log("phase5", json.dumps(out[f"index_scan_{label}"]))
    for label, nprobe in (("auto", 0), ("p32", 32)):
        out[f"trace_{label}"] = trace_search(
            idx, q_np, vdb.SearchParams(nprobe=nprobe, k=k),
            main_path[f"ms_per_batch_median_{label}"])
        log("phase6", label, json.dumps(out[f"trace_{label}"]))
    return out


# --------------------------------------------------------------------------- #
# phases 7-10: the IVF-PQ path
# --------------------------------------------------------------------------- #

def pq_corpus_chunk(centers, spec, mix, start, m, seed, noise=0.25):
    """Rows ``[start, start + m)`` of the anisotropic mixture: row g in
    ball ``g % nlist`` plus ``noise`` gaussian, fp32, each dimension i
    scaled by ``spec[i] = (1+i)^-0.5`` and mixed through the orthogonal
    ``mix`` (the JAX package's ``dev_pq_sweep.py --aniso 0.5`` geometry:
    embedding spectra decay, which isotropic balls would hide from PQ).
    Deterministic per (seed, start)."""
    import torch

    gen = torch.Generator(device=centers.device).manual_seed(
        seed * 1_000_003 + start + 17)
    g = torch.arange(start, start + m, device=centers.device)
    pts = centers[g % centers.shape[0]] + noise * torch.randn(
        (m, centers.shape[1]), generator=gen, device=centers.device)
    return (pts * spec) @ mix


def pq_geometry(gen, dev, nlist, dim):
    import torch

    centers = torch.randn((nlist, dim), generator=gen, device=dev)
    spec = (1.0 + torch.arange(dim, device=dev, dtype=torch.float32)) ** -0.5
    mix, _ = torch.linalg.qr(torch.randn((dim, dim), generator=gen,
                                         device=dev))
    return centers, spec, mix


def pq_queries_and_oracle(geom, n, chunk, batch, seed, gen, k, each=None):
    """Queries = corpus rows spread over all chunks + 0.1 noise, and their
    exact fp32 top-k over the corpus (one pass over the chunks, calling
    ``each(start, rows)`` on every chunk)."""
    import torch

    centers = geom[0]
    dev = centers.device
    qi = torch.sort(torch.randint(0, n, (batch,), generator=gen,
                                  device=dev)).values
    queries = torch.empty((batch, centers.shape[1]), device=dev)
    for s in range(0, n, chunk):
        sel = (qi >= s) & (qi < s + chunk)
        if sel.any():
            xc = pq_corpus_chunk(*geom, s, min(chunk, n - s), seed)
            queries[sel] = xc[qi[sel] - s]
    queries += 0.1 * torch.randn(queries.shape, generator=gen, device=dev)
    best_d = torch.full((batch, k), float("inf"), device=dev)
    best_i = torch.full((batch, k), -1, dtype=torch.long, device=dev)
    for s in range(0, n, chunk):
        xc = pq_corpus_chunk(*geom, s, min(chunk, n - s), seed)
        if each is not None:
            each(s, xc)
        best_d, best_i = oracle_update(best_d, best_i, queries, xc, s, k)
        del xc
    return queries, best_i.cpu().numpy()


# the served IVF-PQ settings: (label, nprobe (0 = calibrated), exact rerank)
PQ_SETTINGS = (("auto", 0, False), ("auto_rr", 0, True),
               ("p32", 32, False), ("p32_rr", 32, True))


def phase_pq_main_path(args, dev):
    """IVF-PQ at full width (1M×768, nlist 4096, m 96, bf16 raw rows,
    ``train_sample_per_list`` 64: the JAX package's ``dev_pq_sweep.py``
    defaults): ``train_from_device``, ``reserve``, ``add_from_device`` in
    125K slices, ``calibrate_nprobe``, then timed 512-query batches at the
    calibrated nprobe and at 32, each with and without the exact rerank."""
    import numpy as np
    import torch

    import cuda_acceleratedvectordatabaseengine_tpu_torch as vdb
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
        grouped_pq_scan,
    )

    n, dim, nlist, k, batch = args.pq_n, 768, args.pq_nlist, 10, 512
    chunk, piece = 500_000, 125_000
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    geom = pq_geometry(gen, dev, nlist, dim)
    cfg = vdb.IVFPQConfig(dimension=dim, nlist=nlist, m=96,
                          raw_dtype="bfloat16", train_sample_per_list=64)
    idx = vdb.IVFPQIndex(cfg, device=dev)
    capacity = -(-math.ceil(1.3 * n / nlist) // 128) * 128
    times = {"train_s": 0.0, "add_s": 0.0}
    torch.cuda.reset_peak_memory_stats()

    def ingest(s, xc):
        if s == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx.train_from_device(xc)
            torch.cuda.synchronize()
            times["train_s"] = time.perf_counter() - t0
            idx.reserve(capacity)
        for s0 in range(0, xc.shape[0], piece):
            s1 = min(s0 + piece, xc.shape[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx.add_from_device(
                xc[s0:s1], ids=np.arange(s + s0, s + s1, dtype=np.uint64))
            torch.cuda.synchronize()
            times["add_s"] += time.perf_counter() - t0

    queries, truth = pq_queries_and_oracle(geom, n, chunk, batch, args.seed,
                                           gen, k, each=ingest)
    if idx.ntotal != n:
        raise AssertionError(f"IVF-PQ build: ntotal {idx.ntotal} != {n}")
    q_np = queries.cpu().numpy()
    t0 = time.perf_counter()
    cal = idx.calibrate_nprobe(queries=q_np, target_coverage=0.99, k=k)
    cal_s = time.perf_counter() - t0
    mem = idx.memory_stats()
    counts = idx.counts.cpu().numpy()
    out = {
        "n": n, "dim": dim, "nlist": nlist, "m": 96,
        "capacity_reserved": capacity, "capacity": idx.capacity,
        "code_gb": mem["code_bytes"] / 1e9, "raw_gb": mem["raw_bytes"] / 1e9,
        "counts_p50": int(np.percentile(counts, 50)),
        "counts_max": int(counts.max()),
        "train_s": times["train_s"], "add_s": times["add_s"],
        "ingest_mvec_per_min": n / times["add_s"] * 60 / 1e6,
        "calibrate_s": cal_s, "calibrated_nprobe": cal["nprobe"],
        "calibrated_coverage": cal["coverage"],
        "coverage_curve": cal["curve"],
    }
    for label, nprobe, rr in PQ_SETTINGS:
        launches0 = grouped_pq_scan.LAUNCHES
        ms, (d, ids) = search_timed(
            idx, q_np, vdb.SearchParams(nprobe=nprobe, k=k,
                                        use_exact_rerank=rr), args.pq_reps)
        if not (np.isfinite(d).all() and d.shape == (batch, k)):
            raise AssertionError(f"IVF-PQ search {label}: bad distances")
        med = float(np.median(ms))
        out[f"k2_launches_{label}"] = grouped_pq_scan.LAUNCHES - launches0
        out[f"qps_{label}"] = batch / med * 1e3
        out[f"ms_per_batch_median_{label}"] = med
        out[f"ms_per_batch_max_{label}"] = float(max(ms))
        out[f"recall10_{label}"] = recall_at(ids, truth, k)
    out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("phase7", json.dumps(out))
    for label, _, _ in PQ_SETTINGS:
        if out[f"k2_launches_{label}"] <= 0:
            raise AssertionError(f"IVF-PQ search ({label}) never launched "
                                 f"the K2 kernel")
    if out["recall10_p32_rr"] < 0.90:
        raise AssertionError(f"IVF-PQ recall@10 with rerank at nprobe 32: "
                             f"{out['recall10_p32_rr']} < 0.90")
    return out, idx, queries, q_np, min(cal["nprobe"], nlist)


def check_index_pq_scan(idx, q_dev, nprobe, keep) -> dict:
    """K2 on the built index as ``search`` drives it (coarse probe, then the
    grouped ADC scan in the mode ``keep`` selects: top-k up to 32, full
    rows beyond) against the plain version on the same probes; raises on
    disagreement. Also both scans' device times."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
        grouped_pq_scan as gps,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
        Metric, pairwise_distance,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
        topk_smallest,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
        assert_topk_match,
    )

    q = idx._rot(q_dev)
    _, probes = topk_smallest(pairwise_distance(q, idx.centroids, Metric.L2),
                              nprobe)
    args = (q, idx.code_arena_t, idx.code_sq, idx.counts, idx.centroids,
            idx.codebooks, probes.int(), keep, Metric.L2)
    kw = dict(emit_full=keep > 32,
              scan_capacity=idx._scan_capacity_hint())
    d_k, p_k = gps.scan_probed_codes_grouped(*args, **kw)
    d_p, p_p = gps.scan_probed_codes_grouped_reference(*args, **kw)
    atol = (ATOL_QSQ * (q * q).sum(1)).cpu().numpy()
    cmp = assert_topk_match(d_k.cpu().numpy(), p_k.cpu().numpy(),
                            d_p.cpu().numpy(), p_p.cpu().numpy(),
                            rtol=RTOL, atol=atol)
    return {
        "nprobe": nprobe, "keep": keep,
        "mode": "emit_full" if keep > 32 else "topk",
        "max_abs_err": cmp.max_abs_err,
        "id_differences_at_ties": cmp.n_id_differences,
        "entries": cmp.n_entries,
        "scan_ms": cuda_ms(lambda: gps.scan_probed_codes_grouped(*args, **kw),
                           10),
        "scan_plain_ms": cuda_ms(
            lambda: gps.scan_probed_codes_grouped_reference(*args, **kw), 3),
    }


def phase_pq_index_checks(idx, queries, q_np, cal_nprobe, main_path,
                          k=10) -> dict:
    """After the IVF-PQ path's launch count is read: K2 against its plain
    version on the built index in both served modes (phase 8), and one
    traced search per served setting (phase 9)."""
    import cuda_acceleratedvectordatabaseengine_tpu_torch as vdb

    out = {}
    for nprobe in sorted({cal_nprobe, 32}):
        for keep in (k, min(4 * k, 256)):
            key = f"index_pq_scan_p{nprobe}_keep{keep}"
            out[key] = check_index_pq_scan(idx, queries, nprobe, keep)
            log("phase8", json.dumps(out[key]))
    for label, nprobe, rr in PQ_SETTINGS:
        out[f"trace_{label}"] = trace_search(
            idx, q_np, vdb.SearchParams(nprobe=nprobe, k=k,
                                        use_exact_rerank=rr),
            main_path[f"ms_per_batch_median_{label}"],
            stage_names=PQ_SEARCH_STAGES,
            kernel_stages=(("grouped_pq_scan_kernel",
                            "grouped_pq_scan.rows"),))
        log("phase9", label, json.dumps(out[f"trace_{label}"]))
    return out


def phase_opq(args, dev) -> dict:
    """A small OPQ index (100K×768, nlist 256, m 96) beside plain PQ on the
    same anisotropic data: the learned rotation must be an isometry to
    fp32 roundoff (max|RᵀR − I| ≤ 2e-5); ADC-only recall@10 of both."""
    import numpy as np
    import torch

    import cuda_acceleratedvectordatabaseengine_tpu_torch as vdb

    n, dim, nlist, k = args.opq_n, 768, 256, 10
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
    geom = pq_geometry(gen, dev, nlist, dim)
    queries, truth = pq_queries_and_oracle(geom, n, n, 256, args.seed + 1,
                                           gen, k)
    x = pq_corpus_chunk(*geom, 0, n, args.seed + 1)
    q_np = queries.cpu().numpy()
    out = {"n": n, "nlist": nlist}
    for opq in (False, True):
        name = "opq" if opq else "pq"
        idx = vdb.IVFPQIndex(vdb.IVFPQConfig(dimension=dim, nlist=nlist,
                                             m=96, opq=opq), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.train_from_device(x)
        torch.cuda.synchronize()
        out[f"{name}_train_s"] = time.perf_counter() - t0
        idx.add_from_device(x)
        _, ids = idx.search(q_np, vdb.SearchParams(nprobe=32, k=k))
        out[f"{name}_adc_recall10_p32"] = recall_at(ids, truth, k)
        if opq:
            R = idx.opq_R.double()
            eye = torch.eye(dim, dtype=torch.float64, device=dev)
            out["opq_isometry_max_err"] = float((R.T @ R - eye).abs().max())
        del idx
    log("phase10", json.dumps(out))
    if not out["opq_isometry_max_err"] <= 2e-5:
        raise AssertionError(f"OPQ rotation not an isometry: max|RᵀR − I| "
                             f"{out['opq_isometry_max_err']}")
    del x
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20,
                    help="timed search batches per nprobe setting")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pq-n", type=int, default=1_000_000,
                    help="rows of the IVF-PQ path (768-D, m 96)")
    ap.add_argument("--pq-nlist", type=int, default=4096)
    ap.add_argument("--pq-reps", type=int, default=10,
                    help="timed IVF-PQ batches per served setting")
    ap.add_argument("--opq-n", type=int, default=100_000,
                    help="rows of the small OPQ-vs-PQ index")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every phase's numbers to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import cuda_acceleratedvectordatabaseengine_tpu_torch as port
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
        _build,
        grouped_pq_scan,
        grouped_scan,
    )

    if not Path(port.__file__).resolve().is_relative_to(REPO):
        print(f"chip_smoke: the port was imported from {port.__file__}, "
              f"not from this checkout", file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # phase 0: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log("phase0", json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}))

    # phase 1: build
    fresh = not (_build.BUILD_ROOT / _build.source_hash()
                 / _build.LIB_NAME).is_file()
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    log("phase1", json.dumps({
        "library": str(lib_path.relative_to(REPO)), "compiled_now": fresh,
        "build_s": time.perf_counter() - t0,
        **ptxas_summary((lib_path.parent / "nvcc.log").read_text())}))

    dev = torch.device("cuda")
    k1 = phase_kernel_vs_plain(args.seed, dev)     # phase 2
    k2 = phase_pq_kernel_vs_plain(args.seed, dev)  # phase 2b
    phase_quickstart(dev)                          # phase 3
    grouped_scan.LAUNCHES = 0                      # phase 4: the main path
    main_path, idx, queries, q_np, cal_nprobe = phase_main_path(args, dev)
    launches = grouped_scan.LAUNCHES
    log("phase4_k1_launches", launches)
    if launches <= 0:
        raise AssertionError("the main path never launched the K1 kernel")
    checks = phase_index_checks(idx, queries, q_np, cal_nprobe,  # 5, 6
                                main_path)
    del idx, queries
    torch.cuda.empty_cache()

    grouped_pq_scan.LAUNCHES = 0                   # phase 7: the IVF-PQ path
    pq_path, pq_idx, pq_q, pq_q_np, pq_cal = phase_pq_main_path(args, dev)
    pq_launches = grouped_pq_scan.LAUNCHES
    log("phase7_k2_launches", pq_launches)
    if pq_launches <= 0:
        raise AssertionError("the IVF-PQ path never launched the K2 kernel")
    pq_checks = phase_pq_index_checks(pq_idx, pq_q, pq_q_np,  # 8, 9
                                      pq_cal, pq_path)
    del pq_idx, pq_q
    torch.cuda.empty_cache()
    opq = phase_opq(args, dev)                     # phase 10
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    report = {"kernels": [{
        "name": "grouped_scan", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max(k1["max_abs_err"],
                           checks["index_scan_auto"]["max_abs_err"],
                           checks["index_scan_p32"]["max_abs_err"]),
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }, {
        "name": "grouped_pq_scan", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": pq_launches,
        "max_abs_err": max([r["max_abs_err"] for r in k2.values()]
                           + [c["max_abs_err"] for key, c in pq_checks.items()
                              if key.startswith("index_pq_scan")]),
        "ms": k2["topk_k10"]["ms"],
        "plain_ms": k2["topk_k10"]["plain_ms"],
    }]}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "nvidia_smi": smi, "k1_main_shape": k1, "main_path": main_path,
            "index_checks": checks, "k2_main_shape": k2,
            "pq_main_path": pq_path, "pq_index_checks": pq_checks,
            "opq": opq, **report}, indent=1))
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
