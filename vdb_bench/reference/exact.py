"""The plain reference of an IVF-Flat L2 search: exact answers over the
corpus, in plain PyTorch, in blocks of rows so that they fit beside nothing
else on the card.

It imports nothing of the system under test and takes nothing the system
made: the corpus comes from the benchmark's own generator, chunk by chunk
(``chunks``: an iterable of ``(start, rows)``), and the queries are the
benchmark's. TF32 is switched off for every product here: TF32 keeps ten
mantissa bits, which would move the exact top-k.
"""

from __future__ import annotations

import torch

BLOCK_BYTES = 1 << 30   # each fp32 temporary of the top-k at most this


def _fp32_products() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_topk(queries: torch.Tensor, chunks, k: int):
    """The exact L2 top-``k`` of ``queries`` (fp32 ``[Q, D]``) over every
    row of ``chunks``: ``(d [Q, k] fp32 ascending, ids [Q, k] int64)``,
    ids being global row numbers. Distances are ``|q|² − 2 q·x + |x|²`` in
    fp32 on the rows as stored (bf16 widened to fp32)."""
    _fp32_products()
    q = queries.float()
    n_q = q.shape[0]
    best_d = torch.full((n_q, k), float("inf"), device=q.device)
    best_i = torch.full((n_q, k), -1, dtype=torch.long, device=q.device)
    q_sq = (q * q).sum(1, keepdim=True)
    block = max(k, BLOCK_BYTES // (4 * max(n_q, q.shape[1])))
    for start, rows in chunks:
        for s0 in range(0, rows.shape[0], block):
            x = rows[s0:s0 + block].float()
            d = (q_sq - 2.0 * q @ x.T + (x * x).sum(1)[None, :]).clamp_min(0)
            v, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
            cat_d = torch.cat([best_d, v], 1)
            cat_i = torch.cat([best_i, i + start + s0], 1)
            best_d, sel = torch.topk(cat_d, k, dim=1, largest=False)
            best_i = torch.gather(cat_i, 1, sel)
    return best_d, best_i


def pair_distances(queries: torch.Tensor, q_index: torch.Tensor,
                   ids: torch.Tensor, chunks) -> torch.Tensor:
    """Squared L2 distance of each pair ``(queries[q_index[p]], row
    ids[p])`` (fp64 ``[P]``), summed over the differences in fp64: the
    distance the system should have reported for that answer. Pairs whose id
    is outside the corpus read NaN."""
    out = torch.full(ids.shape, float("nan"), dtype=torch.float64,
                     device=queries.device)
    for start, rows in chunks:
        sel = torch.nonzero((ids >= start) & (ids < start + rows.shape[0]))
        sel = sel.reshape(-1)
        for s0 in range(0, sel.numel(), 65536):
            p = sel[s0:s0 + 65536]
            diff = (queries[q_index[p]].double()
                    - rows[ids[p] - start].double())
            out[p] = (diff * diff).sum(1)
    return out


def coarse_probe(queries: torch.Tensor, centroids: torch.Tensor,
                 nprobe: int) -> torch.Tensor:
    """The ``nprobe`` nearest centroids of each query by fp32 L2
    (``[Q, nprobe]`` int64), the lists an IVF search with these centroids
    reads."""
    _fp32_products()
    q, c = queries.float(), centroids.float()
    d = (q * q).sum(1, keepdim=True) - 2.0 * q @ c.T + (c * c).sum(1)[None]
    return torch.topk(d, nprobe, dim=1, largest=False).indices
