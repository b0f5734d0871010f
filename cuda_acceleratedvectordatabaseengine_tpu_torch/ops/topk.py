"""Top-k selection and merge (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/ops/topk.py``).

All selection is over *distances* (smaller = closer). Invalid slots are
``+inf`` distance / ``-1`` index. The JAX package's 4-lane tournament and
its auto gate are not ported: they dodge ``lax.top_k`` lowering to a full
sort on the TPU, and ``torch.topk`` has no such problem.
"""

from __future__ import annotations

import torch


def topk_smallest(
    d: torch.Tensor,
    k: int,
    idx: torch.Tensor | None = None,
    approx: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Select the k smallest entries of ``d [..., N]``.

    Returns ``(dists [..., k], indices [..., k])`` sorted ascending. If
    ``idx`` is given, it supplies the identity of each column (e.g. global
    arena positions) and is gathered instead of returning column numbers.

    ``approx`` is accepted for API parity with the JAX package and takes
    the exact path: ``torch.topk`` has no approximate variant. The order of
    tied entries is not part of the contract.
    """
    del approx
    vals, cols = torch.topk(d, k, dim=-1, largest=False, sorted=True)
    if idx is not None:
        return vals, torch.gather(idx, -1, cols)
    return vals, cols


def merge_topk(
    d_a: torch.Tensor,
    i_a: torch.Tensor,
    d_b: torch.Tensor,
    i_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two top-k candidate sets along the last axis and re-select k.
    No dedup: every vector lives in exactly one inverted list, so a global
    arena position appears at most once across partial results."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    return topk_smallest(d, k, idx=i)
