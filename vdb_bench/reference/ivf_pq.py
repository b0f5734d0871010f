"""The plain reference of an IVF-PQ L2 search with an exact rerank: given
an index's trained centroids, residual codebooks, codes and raw rows, the
answer that the search as defined gives, in plain PyTorch.

1. the coarse probe: the ``nprobe`` nearest centroids by fp32 L2;
2. ADC over the probed lists: each stored slot decodes to ``c + r̂``
   (``r̂`` the concatenated codewords of its codes), and its distance is
   ``|q − (c + r̂)|²``, summed over the differences in fp32;
3. the shortlist: the ``rerank_k`` smallest ADC distances over the probed
   slots (all of them where fewer);
4. the exact rerank: ``|q − x|²`` of each shortlisted raw row ``x`` (as
   stored, widened to fp32), summed over the differences; the ``k``
   smallest.

Positions are global slots ``list · capacity + slot``, so the caller maps
them to ids through its own table. It imports nothing of the system under
test. It decodes every probed slot and takes the distances as sums of
squared differences: not the tables, the expanded norms or the kernels of
the system, so a fault there shows against it. TF32 is switched off: TF32
keeps ten mantissa bits, which would move the shortlist.
"""

from __future__ import annotations

import torch

from vdb_bench.reference.exact import coarse_probe


def decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Residuals ``[n, m · dsub]`` fp32 of ``codes [n, m]`` (uint8) under
    ``codebooks [m, 256, dsub]``."""
    m = codebooks.shape[0]
    picked = codebooks.float()[torch.arange(m, device=codes.device)[None, :],
                               codes.long()]                  # [n, m, dsub]
    return picked.reshape(codes.shape[0], -1)


def _sq_dist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``|q − x_i|²`` of one query ``q [D]`` against rows ``x [n, D]``,
    fp32."""
    diff = x.float() - q.float()[None, :]
    return (diff * diff).sum(1)


def search(queries: torch.Tensor, centroids: torch.Tensor,
           codebooks: torch.Tensor, codes: torch.Tensor,
           counts: torch.Tensor, raw: torch.Tensor, nprobe: int,
           rerank_k: int, k: int):
    """The IVF-PQ answer of ``queries [Q, D]``: ``(d [Q, k] fp32
    ascending, pos [Q, k] int64)``, ``pos`` the global slot of each answer
    (+inf / -1 past the candidates there are), and ``shortlist [Q]``, the
    candidates each query's rerank read. ``codes [nlist, cap, m]`` uint8
    and ``raw [nlist, cap, D]`` hold each list's slots, the first
    ``counts[l]`` of them occupied. One query at a time: its probed lists
    decoded whole (``nprobe · cap · D`` fp32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_q = queries.shape[0]
    cap = codes.shape[1]
    dev = queries.device
    probes = coarse_probe(queries, centroids, nprobe)
    out_d = torch.full((n_q, k), float("inf"), device=dev)
    out_p = torch.full((n_q, k), -1, dtype=torch.long, device=dev)
    shortlist = torch.zeros(n_q, dtype=torch.long, device=dev)
    slot = torch.arange(cap, device=dev)
    for i in range(n_q):
        q = queries[i].float()
        lists = probes[i]
        live = slot[None, :] < counts[lists].long()[:, None]   # [P, cap]
        lst = lists[:, None].expand_as(live)[live]
        slt = slot[None, :].expand_as(live)[live]
        recon = decode(codes[lst, slt], codebooks) + centroids[lst].float()
        adc = _sq_dist(q, recon)
        r = min(rerank_k, adc.numel())
        sel = torch.topk(adc, r, largest=False).indices
        shortlist[i] = r
        exact = _sq_dist(q, raw[lst[sel], slt[sel]])
        kk = min(k, r)
        d, j = torch.topk(exact, kk, largest=False)
        out_d[i, :kk] = d
        out_p[i, :kk] = lst[sel][j] * cap + slt[sel][j]
    return out_d, out_p, shortlist
