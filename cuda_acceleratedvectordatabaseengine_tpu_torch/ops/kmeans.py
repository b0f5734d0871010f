"""k-means for the IVF coarse quantizer (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/ops/kmeans.py``).

Assignment is a chunked ``[C, D] × [D, K]`` fp32 distance matmul plus a row
argmin / top-t; the Lloyd update is another matmul, ``onehot(a).T @ x``,
accumulated in fp32 over chunks (deterministic, unlike scatter-add atomics).
k-means++ seeding samples ∝ D² with the Gumbel-max trick, and every random
draw comes from the caller's ``torch.Generator`` (on the data's device), so
a seed fixes the result. All of it is matmuls and reductions: the TPU
package had no hand kernel here either.

``torch.Generator`` does not replay ``jax.random``: the two packages seed
differently and are held to each other by quality (inertia, balance, no
empty list), not by identical centroids.
"""

from __future__ import annotations

import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
    Metric,
    pairwise_distance,
)


def _chunks(x: torch.Tensor, chunk_size: int):
    for s in range(0, x.shape[0], chunk_size):
        yield x[s:s + chunk_size].float()


def kmeans_assign(
    x: torch.Tensor,
    centroids: torch.Tensor,
    metric: Metric = Metric.L2,
    chunk_size: int = 16384,
) -> torch.Tensor:
    """Nearest centroid of each row of ``x [N, D]``: int32 ``[N]``."""
    out = [
        pairwise_distance(xc, centroids, metric).argmin(-1).int()
        for xc in _chunks(x, chunk_size)
    ]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32,
                                                  device=x.device)


def kmeans_assign_topk_vals(
    x: torch.Tensor,
    centroids: torch.Tensor,
    t: int = 4,
    metric: Metric = Metric.L2,
    chunk_size: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``t`` nearest centroids per row with their distances:
    ``(vals [N, t] fp32 ascending, idx [N, t] int32)``. Backs balanced
    assignment (overflow rows fall to their next choice) and the
    multi-assignment ratio test."""
    vals, idx = [], []
    for xc in _chunks(x, chunk_size):
        v, i = torch.topk(pairwise_distance(xc, centroids, metric), t,
                          dim=-1, largest=False, sorted=True)
        vals.append(v)
        idx.append(i.int())
    return torch.cat(vals), torch.cat(idx)


def kmeans_assign_topk(
    x: torch.Tensor,
    centroids: torch.Tensor,
    t: int = 4,
    metric: Metric = Metric.L2,
    chunk_size: int = 16384,
) -> torch.Tensor:
    """Top-``t`` nearest centroids per row: ``[N, t]`` int32, best first."""
    return kmeans_assign_topk_vals(x, centroids, t, metric, chunk_size)[1]


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def kmeans_pp_init(
    x: torch.Tensor, k: int, generator: torch.Generator
) -> torch.Tensor:
    """k-means++ seeding (D² sampling): fp32 centroids ``[k, D]``. Each
    step samples a row with P ∝ min squared distance to the chosen seeds by
    Gumbel-max over log weights, then folds that row into the minimum."""
    n, dim = x.shape
    dev = x.device
    xf = x.float()
    x_sq = (xf * xf).sum(-1)

    def dist_to(c):
        return (x_sq - 2.0 * (xf @ c) + (c * c).sum()).clamp_min(0.0)

    first = torch.randint(0, n, (), generator=generator, device=dev)
    centroids = torch.zeros((k, dim), dtype=torch.float32, device=dev)
    centroids[0] = xf[first]
    min_d2 = dist_to(xf[first])
    for i in range(1, k):
        logits = torch.where(
            min_d2 > 0, torch.log(min_d2 + 1e-30), float("-inf")
        )
        idx = torch.argmax(logits + _gumbel((n,), generator, dev))
        c = xf[idx]
        centroids[i] = c
        min_d2 = torch.minimum(min_d2, dist_to(c))
    return centroids


def _reseed_step(new_centroids, counts, cand_v, cand_vecs, samp_vecs,
                 samp_a, d_tot, n_total, it, iters, generator, k: int,
                 split_thresh: float = 1.5):
    """Twin/orphan/overfull reseeding after a Lloyd update (the JAX
    package's ``_reseed_step``; see its docstring for the measurements
    behind each rule):

    - starved: count < 10% of mean;
    - redundant: twin centroids inside one mode (nearest-neighbour distance
      < 0.35 × median) whose combined count is not itself overfull;
    - donated: the lowest-count centroids, funding ceil(count /
      (split_thresh · mean)) − 1 clones of each overfull list (capped at
      min(256, k/8) per iteration).

    Starved and redundant slots move to a high-distortion or overfull-list
    row drawn ∝ score by Gumbel top-k; donated slots bisect their target
    (a clone plus a jitter of 0.25 × the rms assignment radius). Nothing is
    reseeded on the last two iterations."""
    if it >= iters - 2:
        return new_centroids
    dev = new_centroids.device
    cc = pairwise_distance(new_centroids, new_centroids, Metric.L2)
    cc = cc + torch.where(
        torch.eye(k, dtype=torch.bool, device=dev), float("inf"), 0.0
    )
    nn_d, partner = cc.min(-1)
    med_nn = torch.quantile(nn_d, 0.5)   # midpoint median, as jnp.median
    mean_count = counts.mean()
    mean_d = d_tot / float(n_total) + 1e-12
    ar = torch.arange(k, device=dev)
    redundant = (
        (nn_d < 0.35 * med_nn)
        & (ar > partner)
        & (counts + counts[partner] < split_thresh * mean_count)
    )
    starved = counts < 0.1 * mean_count
    demand = (torch.ceil(counts / (split_thresh * mean_count)) - 1.0
              ).clamp_min(0.0)
    d_cap = max(min(256, k // 8), 1)
    quota = torch.clamp(demand.sum(), max=float(d_cap)).long()
    rank_by_count = torch.empty(k, dtype=torch.long, device=dev)
    rank_by_count[torch.argsort(counts, stable=True)] = ar
    donated = (rank_by_count < quota) & (demand == 0)
    reseed = starved | redundant | donated

    score_dist = cand_v.reshape(-1) / mean_d
    samp_c = counts[samp_a.reshape(-1).long()]
    score_samp = torch.where(
        samp_c > split_thresh * mean_count, 4.0 + samp_c / mean_count,
        float("-inf"),
    )
    pool_x = torch.cat([cand_vecs, samp_vecs])
    pool_s = torch.cat([score_dist, score_samp])
    noisy = torch.where(
        pool_s > 0,
        torch.log(pool_s.clamp_min(1e-30))
        + _gumbel(pool_s.shape, generator, dev),
        float("-inf"),
    )
    s_cand = min(pool_s.shape[0], 512)
    best = torch.topk(noisy, s_cand).indices
    cand_rows = pool_x[best]
    slot = (torch.cumsum(reseed.long(), 0) - 1) % s_cand

    d_rank = torch.cumsum(donated.long(), 0) - 1
    cum = torch.cumsum(demand, 0)
    tgt = torch.searchsorted(cum, d_rank.to(cum.dtype), right=True).clamp(
        0, k - 1
    )
    eps = torch.randn(new_centroids.shape, generator=generator, device=dev)
    eps = eps * (0.25 * torch.sqrt(mean_d)
                 / (eps.norm(dim=-1, keepdim=True) + 1e-20))
    placed = torch.where(
        donated[:, None], new_centroids[tgt] + eps, cand_rows[slot]
    )
    return torch.where(reseed[:, None], placed, new_centroids)


def _lloyd_chunk(xc: torch.Tensor, centroids: torch.Tensor, nc: int,
                 w: torch.Tensor | None = None):
    """One chunk's share of a Lloyd iteration: the partial ``onehot.T @
    xc`` sums, counts and distortion, and the reseed candidates — the
    ``nc`` highest-distortion rows (orphaned modes) and a stratified sample
    of ``nc`` rows with their assignment (split donors for overfull lists).
    ``w`` is a 0 / 1 row weight (None: every row counts); a row of weight 0
    joins no cluster, adds no distortion and is never a candidate.
    Returns ``(sums, counts, distortion, cand_v, cand_x, samp_x, samp_a,
    assignments)``."""
    k = centroids.shape[0]
    d_min, a = pairwise_distance(xc, centroids, Metric.L2).min(-1)
    onehot = (a[:, None] == torch.arange(k, device=xc.device)[None, :]).float()
    if w is None:
        d_part = d_min.clamp_min(0.0).sum()
    else:
        onehot = onehot * w[:, None]
        d_min = torch.where(w > 0, d_min, float("-inf"))
        d_part = (d_min.clamp_min(0.0) * w).sum()
    top_v, top_i = torch.topk(d_min, nc)
    samp = torch.arange(nc, device=xc.device) * max(xc.shape[0] // nc, 1)
    return (onehot.T @ xc, onehot.sum(0), d_part, top_v, xc[top_i],
            xc[samp], a[samp], a)


def kmeans_fit(
    x: torch.Tensor,
    k: int,
    iters: int = 10,
    chunk_size: int = 16384,
    init: str = "kmeans++",
    split_thresh: float = 1.5,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Train k-means: seeding + ``iters`` Lloyd iterations with reseeding.

    Returns ``(centroids [k, D] fp32, assignments [N] int32)`` (the
    assignments of the last iteration). Empty clusters keep their previous
    centroid. ``generator`` must live on ``x``'s device (default: a fresh
    one seeded 0)."""
    n, dim = x.shape
    dev = x.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if init == "kmeans++":
        centroids = kmeans_pp_init(x, k, generator)
    elif init == "random":
        if n < k:
            idx = torch.randint(0, n, (k,), generator=generator, device=dev)
        else:
            idx = torch.randperm(n, generator=generator, device=dev)[:k]
        centroids = x[idx].float()
    else:
        raise ValueError(f"unknown init {init!r}")

    cs = min(chunk_size, max(n, 1))
    n_cand = min(32, cs)
    assigns = None
    for it in range(iters):
        sums = torch.zeros((k, dim), dtype=torch.float32, device=dev)
        counts = torch.zeros((k,), dtype=torch.float32, device=dev)
        d_tot = torch.zeros((), dtype=torch.float32, device=dev)
        parts, cand_v, cand_x, samp_x, samp_a = [], [], [], [], []
        for xc in _chunks(x, cs):
            c_sums, c_counts, c_d, top_v, top_x, s_x, s_a, a = _lloyd_chunk(
                xc, centroids, min(n_cand, xc.shape[0]))
            sums += c_sums
            counts += c_counts
            d_tot += c_d
            parts.append(a.int())
            cand_v.append(top_v)
            cand_x.append(top_x)
            samp_x.append(s_x)
            samp_a.append(s_a)
        new_centroids = torch.where(
            (counts > 0)[:, None], sums / counts.clamp_min(1.0)[:, None],
            centroids,
        )
        centroids = _reseed_step(
            new_centroids, counts, torch.cat(cand_v), torch.cat(cand_x),
            torch.cat(samp_x), torch.cat(samp_a), d_tot, n, it, iters,
            generator, k, split_thresh=split_thresh,
        )
        assigns = torch.cat(parts)
    if assigns is None:
        assigns = kmeans_assign(x, centroids, Metric.L2, chunk_size)
    return centroids, assigns
