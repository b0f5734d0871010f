"""The yardstick of K2, the grouped ADC scan over PQ codes
(``ops/grouped_pq_scan``): the work its function needs, counted as
``chip_smoke.py``'s K2 phase counts it (a frozen copy), from the probe set
and the list occupancy as plain tensors, and set against the card's peaks
(``roofline.py``).
"""

from __future__ import annotations

import torch

from vdb_bench.roofline import roofline, scan_work

KS = 256   # codewords a subspace: 8-bit codes


def grouped_pq_scan_bound(probe: torch.Tensor, counts: torch.Tensor,
                          cap_s: int, dim: int, msub: int) -> dict:
    """Roofline of one grouped ADC scan in its full-row mode (the mode of
    a rerank's shortlist) of a batch whose probes are ``probe [B,
    nprobe]``. Operations: the per-query tables (``B · m · 256`` entries
    of ``2 · dsub`` each) and ``m`` adds per (valid pair, occupied slot),
    at the fp32 CUDA-core peak. Bytes read once: the codes and norms of
    the distinct probed lists' occupied slots, their centroids, the
    codebooks and the fp32 queries; written once: the fp32 distance row of
    ``cap_s`` slots of every (query, probe). The tables are the kernels'
    own intermediate and count no bytes."""
    batch, nprobe = probe.shape
    pair_slots, list_slots, n_lists = scan_work(probe, counts, cap_s)
    dsub = dim // msub
    flops = 2 * dsub * batch * msub * KS + msub * pair_slots
    nbytes = ((msub + 4) * list_slots
              + (msub * KS * dsub + n_lists * dim + batch * dim) * 4
              + batch * nprobe * cap_s * 4)
    return roofline(flops, nbytes, exact_bf16=False)
