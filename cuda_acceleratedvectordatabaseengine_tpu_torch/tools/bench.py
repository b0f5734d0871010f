"""Headline benchmark harness: IVF-Flat QPS at recall@10 on one GPU (the
port of the JAX system's root ``bench.py``: the same flags, defaults,
``--quick`` cut and output).

Prints ONE JSON line, ``{"metric", "value", "unit", "vs_baseline",
"detail"}``, on stdout; progress goes to stderr. Baseline: 45,000 QPS at
p99 < 6 ms (the reference's self-reported A100-40GB row, never measured
there).

Workload (the defaults): 10M × 768, int8 residual arena, nlist 4096, k 10,
batch 8192, nprobe chosen from the measured probe coverage (the rule of
``models/calibrate``, which unlike ``bench.py`` never takes a candidate
equal to nlist, a full scan). Corpus: a mixture of gaussians made on the
device from fixed seeds (rows 42, centers 1234, queries 7), one ball per
list (noise 0.25), stored bf16;
``--clusters-per-list`` nests sub-modes in each ball, ``--skew zipf``
gives the modes zipf sizes (row g joins the mode of ``(g · 2654435761 mod
2³²) mod n`` in the cumulative size table, whatever the chunking).
Queries are corpus rows + 0.1 noise; the oracle ranks the stored bf16 rows
exactly in fp32 (TF32 off).

Build: with at most 4 GiB of corpus (n · dim · 2 bytes) the bulk path,
``train_from_device`` + ``build_from_device`` on the whole corpus;
otherwise, with ``--force-chunked`` or with ``--multi-assign-eps``, the
chunked path: 500K-row chunks, each made anew, training on chunk 0,
``append_balanced`` at a capacity fixed up front and the oracle updated
per chunk, so the corpus never sits whole on the card.

Timed loops, as ``bench.py`` times them: ``--n-batches`` device searches
(``models/ivf_flat._ivf_search_device``: coarse probe and scan; no copy to
the host, no id map) enqueued back to back, then one synchronise: the
headline ``value`` (QPS, host clock) and ``detail.device_ms_per_batch``
(CUDA events around the same loop); then 10 blocking batches: p50 / p99
batch ms.

``--scan`` takes ``bench.py``'s names, routed by ``ops/flat_scan``:
``pallas_grouped`` (the default) → K1, ``pallas_sorted`` / ``ragged`` →
K3, ``pallas`` → K4 (K3 on an int8 arena), ``gather`` → the plain scan. On
CUDA the named kernel runs or the run fails; only ``--device cpu`` takes
the kernels' plain PyTorch versions. ``detail.mesh1`` serves the same arena
through a one-shard ``parallel.ShardedIVFFlatIndex``; a failure there
fails the run.

    python -m cuda_acceleratedvectordatabaseengine_tpu_torch.tools.bench
    python -m cuda_acceleratedvectordatabaseengine_tpu_torch.tools.bench \\
        --skew zipf --batch 4096
    python -m cuda_acceleratedvectordatabaseengine_tpu_torch.tools.bench \\
        --quick --device cpu
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# ops.distance turns TF32 off on import: the oracle's products are fp32
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
    _ivf_search_device,
    dedup_topk,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.calibrate import (
    probe_coverage_calibrate,
    true_lists,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
    Metric,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel import (
    ShardedIVFFlatIndex,
    make_mesh,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (
    synchronize,
    timed_loop,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (
    resolve_device,
)

BASELINE_QPS = 45_000.0
CHUNK_ROWS = 500_000          # rows a chunk (chunked build, generation)
BULK_MAX_BYTES = 4 << 30      # bulk build up to this much bf16 corpus
HASH_MULT = 2654435761        # Knuth's multiplicative-hash constant
CORPUS_SEED, CENTERS_SEED, QUERY_SEED = 42, 1234, 7
NOISE = 0.25                  # a row's spread around its mode
QUERY_NOISE = 0.1             # a query's offset from its corpus row
SUB_MODE_SPREAD = 0.4         # --clusters-per-list: sub-mode offsets
NPROBE_CANDIDATES = (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
COVERAGE_TARGET = 0.99        # auto nprobe: the first candidate covering it
LATENCY_BATCHES = 10
ORACLE_BLOCK_BYTES = 1 << 30  # each of the oracle's fp32 temporaries


def zipf_cumulative(n, n_modes, s=1.0):
    """Exact zipf mode sizes summing to n: size_j ∝ (j+1)^-s, largest
    remainders distributed to the head. Returns int64 cumulative table
    [n_modes] with cum[-1] == n."""
    w = (np.arange(1, n_modes + 1, dtype=np.float64)) ** (-s)
    sizes = np.floor(w / w.sum() * n).astype(np.int64)
    sizes[: int(n - sizes.sum())] += 1
    assert sizes.sum() == n
    return np.cumsum(sizes)


def check_skew_total(n_total: int) -> None:
    """The zipf map ``g → g · HASH_MULT mod 2³² mod n_total`` needs
    ``n_total`` below 2³¹ and not a multiple of the constant."""
    if not (0 < n_total < 2**31 and n_total % HASH_MULT != 0):
        raise ValueError(f"zipf corpus of {n_total} rows: needs 0 < n < 2^31 "
                         f"and n not divisible by {HASH_MULT}")


def row_modes(start, m, n_modes, skew_cum=None, n_total=None,
              device="cpu") -> torch.Tensor:
    """Mode of each global row ``[start, start + m)`` (int64 ``[m]``):
    ``g % n_modes`` (round robin, every mode the same size), or with the
    cumulative zipf table ``skew_cum`` (int64 tensor) the bucket of ``(g ·
    HASH_MULT mod 2³²) mod n_total``. The product runs in int64 and is
    masked to 32 bits, the wrap of the JAX system's uint32 product."""
    g = torch.arange(start, start + m, dtype=torch.int64, device=device)
    if skew_cum is None:
        return g % n_modes
    r = ((g * HASH_MULT) & 0xFFFFFFFF) % n_total
    return torch.searchsorted(skew_cum, r, right=True)


def corpus_chunk(centers, start, m, seed, noise=NOISE, skew_cum=None,
                 n_total=None) -> torch.Tensor:
    """Rows ``[start, start + m)`` of the mixture corpus on ``centers``'
    device, stored bf16: each row is its mode's center (:func:`row_modes`)
    plus ``noise`` · N(0, 1) from a generator seeded by (seed, start)."""
    gen = torch.Generator(device=centers.device).manual_seed(
        seed * 1_000_003 + start)
    ci = row_modes(start, m, centers.shape[0], skew_cum, n_total,
                   centers.device)
    pts = centers[ci] + noise * torch.randn(
        (m, centers.shape[1]), generator=gen, device=centers.device)
    return pts.to(torch.bfloat16)


def clustered_corpus(centers, n, seed, base=0, skew_cum=None, n_total=None,
                     noise=NOISE, chunk=CHUNK_ROWS) -> torch.Tensor:
    """Global rows ``[base, base + n)``: :func:`corpus_chunk` over
    ``chunk``-row pieces. Every piece draws from the one shared mixture
    ``centers`` (per-chunk centers would give the corpus nlist · n_chunks
    latent clusters, and a quantizer trained on one chunk would probe the
    others at chance), so a chunked build and a bulk build whose chunks
    start at multiples of ``chunk`` see the same rows."""
    return torch.cat([
        corpus_chunk(centers, base + s, min(chunk, n - s), seed, noise,
                     skew_cum, n_total)
        for s in range(0, n, chunk)])


def make_centers(nlist, dim, clusters_per_list, device) -> torch.Tensor:
    """Mixture centers ``[nlist · cpl, dim]`` fp32: nlist super-centers
    N(0, 1); with cpl > 1, sub-mode j sits at ``sup[j // cpl] + 0.4 ·
    N(0, 1)`` (768-D: spread² within a sub-mode ≈ 96, between sub-modes
    ≈ 245, between supers ≈ 1536, so k-means locks onto the supers and
    each list holds cpl resolved sub-modes)."""
    gen = torch.Generator(device=device).manual_seed(CENTERS_SEED)
    sup = torch.randn((nlist, dim), generator=gen, device=device)
    if clusters_per_list == 1:
        return sup
    n_modes = nlist * clusters_per_list
    parent = torch.arange(n_modes, device=device) // clusters_per_list
    return sup[parent] + SUB_MODE_SPREAD * torch.randn(
        (n_modes, dim), generator=gen, device=device)


def synthetic_rows(args, dev):
    """The flags' corpus as ``rows(start, m)`` (bf16 on ``dev``)."""
    cpl = max(args.clusters_per_list, 1)
    centers = make_centers(args.nlist, args.dim, cpl, dev)
    cum = None
    if args.skew == "zipf":
        check_skew_total(args.n)
        cum = torch.from_numpy(zipf_cumulative(
            args.n, args.nlist * cpl, args.skew_s)).to(dev)
    return lambda start, m: clustered_corpus(
        centers, m, CORPUS_SEED, base=start, skew_cum=cum, n_total=args.n)


def make_queries(rows, n, batch, dim, dev) -> torch.Tensor:
    """``batch`` corpus rows drawn uniformly over ``[0, n)`` (read chunk by
    chunk through ``rows``) plus 0.1 · N(0, 1): fp32 ``[batch, dim]``."""
    gen = torch.Generator(device=dev).manual_seed(QUERY_SEED)
    qi = torch.sort(torch.randint(0, n, (batch,), generator=gen,
                                  device=dev)).values
    base = torch.empty((batch, dim), device=dev)
    for start in range(0, n, CHUNK_ROWS):
        sel = (qi >= start) & (qi < start + CHUNK_ROWS)
        if bool(sel.any()):
            xc = rows(start, min(CHUNK_ROWS, n - start))
            base[sel] = xc[qi[sel] - start].float()
    return base + QUERY_NOISE * torch.randn((batch, dim), generator=gen,
                                            device=dev)


def oracle_update(best_d, best_i, q, xc, base, k, block=None, keep=None):
    """Exact fp32 top-k of ``q`` over the rows of ``xc`` merged into the
    running ``(best_d, best_i)`` (global row ids: ``base`` + row); rows
    where the bool ``keep`` is False (removed) are left out. ``block`` rows
    at a time (default: as many as keep the ``[B, block]`` distances and
    the ``[block, D]`` fp32 rows each within ``ORACLE_BLOCK_BYTES``). Raises
    if TF32 is on: TF32 ground truth would cost the recall figures a
    percent."""
    if q.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the oracle needs fp32 products; TF32 is on")
    if block is None:
        block = max(k, ORACLE_BLOCK_BYTES // (4 * max(q.shape)))
    q_sq = (q * q).sum(1, keepdim=True)
    for s0 in range(0, xc.shape[0], block):
        xf = xc[s0:s0 + block].float()
        d = (q_sq - 2.0 * q @ xf.T + (xf * xf).sum(1)[None, :]).clamp_min(0)
        if keep is not None:
            d = d.masked_fill(~keep[s0:s0 + block][None, :], float("inf"))
        v, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        cat_d = torch.cat([best_d, v], 1)
        cat_i = torch.cat([best_i, i + base + s0], 1)
        best_d, sel = torch.topk(cat_d, k, dim=1, largest=False)
        best_i = torch.gather(cat_i, 1, sel)
    return best_d, best_i


def recall_at(ids, truth, k=10) -> float:
    """Mean share of each query's exact top-k ids found in ``ids``."""
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                          for a, b in zip(ids.astype(np.int64), truth)]))


def device_label(dev) -> str:
    """``nvidia-smi``'s name and power limit of the card (``"cpu"`` on the
    host)."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="IVF-Flat QPS at recall@10 → one JSON line")
    p.add_argument("--n", type=int, default=10_000_000)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--nlist", type=int, default=4096)
    p.add_argument("--nprobe", type=int, default=0,
                   help="coarse probes per query; 0 (default): the smallest "
                        "candidate whose probes cover >= 99%% of the exact "
                        "top-k's lists, else the knee of the coverage curve")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--n-batches", type=int, default=40)
    p.add_argument("--m-budget", type=int, default=0,
                   help="list-row width of K1 / K3 (0 = auto from batch "
                        "and nlist)")
    p.add_argument("--quick", action="store_true",
                   help="tiny cut: n 50K, dim 64, nlist 128, batch 64, "
                        "5 batches")
    p.add_argument("--dtype", default="int8",
                   choices=["bfloat16", "int8", "float32"],
                   help="arena storage dtype")
    p.add_argument("--force-chunked", action="store_true",
                   help="take the chunked build whatever the size")
    p.add_argument("--mesh1", type=int, default=1,
                   help="1 (default): also serve the arena through a "
                        "one-shard ShardedIVFFlatIndex (detail.mesh1); 0 = "
                        "skip")
    p.add_argument("--clusters-per-list", type=int, default=1,
                   help="mixture modes per list (>1: sub-modes offset 0.4 "
                        "a coordinate around each ball's center)")
    p.add_argument("--skew", default="none", choices=["none", "zipf"],
                   help="mode sizes: none = round robin; zipf = sizes ∝ "
                        "rank^-s (--skew-s); queries follow the rows")
    p.add_argument("--split-threshold", type=float, default=1.5,
                   help="k-means overfull trigger (× mean train count)")
    p.add_argument("--assign-choices", type=int, default=4,
                   help="balanced-assignment spill depth")
    p.add_argument("--skew-s", type=float, default=1.0,
                   help="zipf exponent")
    p.add_argument("--multi-assign-eps", type=float, default=0.0,
                   help=">0: a second copy of rows whose 2nd-nearest "
                        "centroid passes d2 <= (1+eps)^2 d1; the search "
                        "scans 2k and dedups ids; forces the chunked build")
    p.add_argument("--multi-assign-budget", type=float, default=1.0,
                   help="replicas per chunk ≤ this × its rows")
    p.add_argument("--capacity-factor", type=float, default=1.35,
                   help="chunked build: per-list capacity × mean rows")
    p.add_argument("--scan",
                   default="pallas_grouped",
                   choices=["gather", "ragged", "pallas", "pallas_sorted",
                            "pallas_grouped"],
                   help="scan: pallas_grouped K1, pallas_sorted / ragged "
                        "K3, pallas K4 (K3 on int8), gather the plain scan")
    p.add_argument("--device", default=None,
                   help="device to run on (default: cuda)")
    args = p.parse_args(argv)
    if args.quick:
        # nprobe stays 0: the auto path runs in the quick cut too
        args.n, args.dim, args.nlist = 50_000, 64, 128
        args.batch, args.n_batches = 64, 5
    return args


def _clock(dev, fn, *a):
    """``(fn(*a), seconds)``, the device synchronised at both ends."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn(*a)
    synchronize(dev)
    return out, time.perf_counter() - t0


def build(args, dev, rows, queries, stage):
    """The index of the flags, and the exact top-k of the queries over the
    corpus. Bulk path: the whole corpus, ``train_from_device`` +
    ``build_from_device``, then the oracle; chunked path: chunk by chunk,
    training on chunk 0, ``append_balanced`` at the capacity the flags
    fix, the oracle updated per chunk. Returns ``(index, queries on the
    device, truth distances, truth ids, seconds)``."""
    n, k = args.n, args.k
    idx = IVFFlatIndex(IVFFlatConfig(
        dimension=args.dim, nlist=args.nlist, dtype=args.dtype,
        train_sample_per_list=128, max_capacity_factor=4.0,
        split_threshold=args.split_threshold,
        assign_choices=args.assign_choices,
        multi_assign_eps=args.multi_assign_eps,
        multi_assign_budget=args.multi_assign_budget,
        scan_impl=args.scan, m_budget=args.m_budget or None,
    ), device=dev)
    chunked = (args.force_chunked or args.multi_assign_eps > 0
               or n * args.dim * 2 > BULK_MAX_BYTES)
    best_d = torch.full((args.batch, k), float("inf"), device=dev)
    best_i = torch.full((args.batch, k), -1, dtype=torch.long, device=dev)
    t = dict(gen=0.0, train=0.0, build=0.0, oracle=0.0, chunks=[],
             chunked=chunked)
    if not chunked:
        stage("generating corpus")
        x, t["gen"] = _clock(dev, rows, 0, n)
        if queries is None:
            queries = make_queries(lambda s, m: x[s:s + m], n, args.batch,
                                   args.dim, dev)
        queries = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        stage("training coarse quantizer")
        _, t["train"] = _clock(dev, idx.train_from_device, x)
        stage("bulk build")
        _, t["build"] = _clock(dev, idx.build_from_device, x)
        stage("exact oracle")
        (best_d, best_i), t["oracle"] = _clock(
            dev, oracle_update, best_d, best_i, queries, x, 0, k)
        return idx, queries, best_d, best_i, t
    capacity = -(-int(n // args.nlist * args.capacity_factor) // 128) * 128
    if queries is None:
        stage("pass 1: sampling query rows across all chunks")
        queries, t["gen"] = _clock(dev, make_queries, rows, n, args.batch,
                                   args.dim, dev)
    queries = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    for ci, start in enumerate(range(0, n, CHUNK_ROWS)):
        m = min(CHUNK_ROWS, n - start)
        stage(f"chunk {ci}: generate {m}")
        xc, dt = _clock(dev, rows, start, m)
        t["gen"] += dt
        if ci == 0:
            stage("training coarse quantizer (chunk 0)")
            _, t["train"] = _clock(dev, idx.train_from_device, xc)
        stage(f"chunk {ci}: balanced append")
        _, dt = _clock(dev, idx.append_balanced, xc,
                       np.arange(start, start + m, dtype=np.uint64),
                       capacity)
        t["chunks"].append(dt)
        t["build"] += dt
        (best_d, best_i), dt = _clock(
            dev, oracle_update, best_d, best_i, queries, xc, start, k)
        t["oracle"] += dt
        del xc
    return idx, queries, best_d, best_i, t


def run(args, dev, rows=None, queries=None, keep=None) -> dict:
    """Build, measure and return the result object ``main`` prints.
    ``rows(start, m)`` gives global corpus rows (default: the flags'
    synthetic corpus) and ``queries`` the query batch (default: made from
    the corpus); ``keep``, a dict, receives the index, the device queries
    and the nprobe served."""
    t_run = time.perf_counter()

    def stage(msg):
        print(f"[bench {time.perf_counter() - t_run:6.1f}s] {msg}",
              file=sys.stderr, flush=True)

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    n, k = args.n, args.k
    idx, queries, best_d, best_i, t = build(
        args, dev, rows if rows is not None else synthetic_rows(args, dev),
        queries, stage)
    truth = best_i.cpu().numpy()
    truth_d = best_d.cpu().numpy()
    arena = idx.arena
    cap = arena.capacity
    cnts = arena.counts.cpu().numpy()
    stage(f"built: capacity={cap} counts p50={int(np.percentile(cnts, 50))} "
          f"p99={int(np.percentile(cnts, 99))} max={int(cnts.max())} "
          f"arena_gb={arena.nbytes_device() / (1 << 30):.2f}")
    # the list of each true id (either copy, under multi-assignment) and,
    # with --nprobe 0, the smallest candidate whose probes cover
    # COVERAGE_TARGET of them, else the knee of the coverage curve: the
    # rule of IVFFlatIndex.calibrate_nprobe on this run's exact oracle
    matched, lists = true_lists(arena.ids, truth)
    nprobe = min(args.nprobe, args.nlist)
    nprobe_curve, coverage_limited = None, False
    if args.nprobe <= 0:
        cal = probe_coverage_calibrate(
            centroids=idx.centroids, metric=Metric.L2, ids_table=arena.ids,
            queries=queries.cpu().numpy(),
            exact_search_fn=lambda q, kk: (truth_d, truth),
            target_coverage=COVERAGE_TARGET, k=k,
            candidates=NPROBE_CANDIDATES)
        nprobe, coverage_limited = cal["nprobe"], cal["coverage_limited"]
        nprobe_curve = {str(p): round(c, 4) for p, c in cal["curve"].items()
                        if p in NPROBE_CANDIDATES}
        stage(f"auto-nprobe: {nprobe} (coverage curve: {nprobe_curve}"
              f"{', coverage-limited' if coverage_limited else ''})")

    # a multi-assignment arena scans a doubled shortlist and dedups ids on
    # the host, as IVFFlatIndex.search does
    k_dev = 2 * k if args.multi_assign_eps > 0 else k
    scan_kw = dict(arena_scale=arena.arena_scale,
                   arena_anchors=arena.anchors,
                   m_budget=args.m_budget or None,
                   scan_capacity=arena.scan_capacity_hint())

    def device_search(q):
        return _ivf_search_device(
            q, idx.centroids, arena.arena, arena.arena_sq, arena.counts,
            nprobe, k_dev, Metric.L2, args.scan, **scan_kw)

    stage("first search")
    d, pos, probes = device_search(queries)
    got = pos.cpu().numpy()
    got_ids_u = arena.positions_to_ids(got)
    d_h = d.cpu().numpy().copy()
    if args.multi_assign_eps > 0:
        got_ids_u[got < 0] = INVALID_ID
        d_h, got_ids_u = dedup_topk(d_h, got_ids_u, k)
    recall = recall_at(got_ids_u, truth, k)
    # eps-recall: the share of RETURNED neighbours within 5% (L2) of the
    # exact k-th distance; separates near-tie scattering (zipf head modes)
    # from real misses
    ret_d = np.sqrt(np.maximum(d_h[:, :k], 0.0))
    true_dk = np.sqrt(np.maximum(truth_d[:, k - 1], 0.0))
    recall_eps = float(np.mean(ret_d <= 1.05 * true_dk[:, None] + 1e-6))
    # duplicate ids in a returned row (a replicated row found twice)
    srt = np.sort(got_ids_u, axis=1)
    dup_rows = int(((srt[:, 1:] == srt[:, :-1])
                    & (srt[:, 1:] != INVALID_ID)).any(1).sum())

    # probe coverage: the share of the true top-k whose list was probed
    probes_h = probes.cpu().numpy()

    def covered(b):
        return float(np.mean(np.isin(lists[b][matched[b]], probes_h[b]).any(
            -1)))

    coverage = float(np.mean([covered(b) if matched[b].any() else 0.0
                              for b in range(truth.shape[0])]))

    stage("throughput loop")
    dt, device_ms = timed_loop(lambda: device_search(queries),
                               args.n_batches, dev)
    qps = args.n_batches * args.batch / dt

    lats = []
    for _ in range(LATENCY_BATCHES):
        t1 = time.perf_counter()
        device_search(queries)
        synchronize(dev)
        lats.append((time.perf_counter() - t1) * 1e3)

    mesh1 = None
    if args.mesh1 and args.multi_assign_eps == 0:
        # the same arena on a one-shard mesh (the publish copies no arena)
        stage("mesh-1: publish + first search")
        sh = ShardedIVFFlatIndex(idx, make_mesh(devices=[dev]),
                                 scan_impl=args.scan)
        sp = SearchParams(nprobe=nprobe, k=k)
        (_, ids_m), first_s = _clock(dev, sh.search, queries, sp)
        recall_m = recall_at(ids_m, truth, k)
        stage(f"mesh-1: throughput (recall {recall_m:.4f})")
        n_mb = max(args.n_batches // 2, 5)
        synchronize(dev)
        tm = time.perf_counter()
        dev_results = [sh.search_device(queries, sp) for _ in range(n_mb)]
        synchronize(dev)
        dt_m = time.perf_counter() - tm
        del dev_results
        mesh_qps = n_mb * args.batch / dt_m
        mesh1 = {
            "qps": round(mesh_qps, 1),
            "recall_at_10": round(recall_m, 4),
            "vs_unsharded_qps_pct": round(100.0 * mesh_qps / max(qps, 1e-9),
                                          1),
            "compile_s": round(first_s, 1),
            "scan_impl": sh.scan_impl,
            "interpret": not cuda,
        }
    if keep is not None:
        keep.update(index=idx, queries=queries, nprobe=nprobe)

    chunk_build_s = t["chunks"]
    steady = (
        round((n - n // len(chunk_build_s))
              / max(sum(chunk_build_s[1:]), 1e-9) / 1e6 * 60, 2)
        if len(chunk_build_s) > 1 and n >= 1_000_000 else None)
    ingest = (round(n / t["build"] / 1e6 * 60, 2)
              if t["build"] and n >= 1_000_000 else None)
    detail = {
        "recall_at_10": round(recall, 4),
        "recall_eps_05": round(recall_eps, 4),
        "probe_coverage": round(coverage, 4),
        "coverage_limited": coverage_limited,
        "p50_batch_ms": round(float(np.percentile(lats, 50)), 2),
        "p99_batch_ms": round(float(np.percentile(lats, 99)), 2),
        "device_ms_per_batch": (round(device_ms, 3)
                                if device_ms is not None else None),
        "batch": args.batch,
        "n": n,
        "dim": args.dim,
        "nlist": args.nlist,
        "nprobe": nprobe,
        "k": k,
        "nprobe_curve": nprobe_curve,
        "skew": args.skew,
        "split_threshold": args.split_threshold,
        "assign_choices": args.assign_choices,
        "multi_assign_eps": args.multi_assign_eps,
        "multi_assign_budget": args.multi_assign_budget,
        "replication_factor": (round(arena.total_vectors / n, 4)
                               if args.multi_assign_eps > 0 else None),
        "rows_with_duplicate_ids": dup_rows,
        "capacity_factor": args.capacity_factor,
        "clusters_per_list": max(args.clusters_per_list, 1),
        "arena_dtype": args.dtype,
        "scan_impl": args.scan,
        "capacity_per_list": cap,
        "build": "chunked" if t["chunked"] else "bulk",
        "gen_s": round(t["gen"], 1),
        "train_s": round(t["train"], 1),
        "build_s": round(t["build"], 1),
        "oracle_s": round(t["oracle"], 1),
        # ingest = the balanced appends (assign + quantize + pack), without
        # the corpus generation
        "ingest_mvec_per_min": ingest,
        "ingest_vs_baseline": (round(ingest / 3.8, 2)
                               if ingest is not None else None),
        "chunk_build_s": [round(s, 2) for s in chunk_build_s],
        "mesh1": mesh1,
        "ingest_steady_mvec_per_min": steady,
        "peak_device_gb": (round(torch.cuda.max_memory_allocated(dev) / 1e9,
                                 3) if cuda else None),
        "device": device_label(dev),
    }
    stage("done")
    return {
        "metric": "ivfflat_search_qps@recall0.95",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / BASELINE_QPS, 4),
        "detail": detail,
    }


def main(argv=None) -> int:
    """Run the benchmark of ``argv``'s flags and print its JSON line."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps(run(args, dev)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
