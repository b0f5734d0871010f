"""Distance metrics in matmul form (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/ops/distance.py``).

Semantics match the JAX package:
  - L2            → squared euclidean distance, no sqrt
  - InnerProduct  → negated dot product, so smaller = closer
  - Cosine        → 1 - cosine similarity with eps=1e-8

Precision: every product here runs in full fp32. Importing this module sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``: TF32 keeps ~10 mantissa bits,
the same rounding hazard as the TPU's single-pass bf16 matmuls that capped
OPQ rerank recall in the JAX package, and the scan's correctness contract
is an exact fp32 dot against the stored representation.
"""

from __future__ import annotations

import enum

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

COSINE_EPS = 1e-8


class Metric(enum.Enum):
    """Distance metric. String values match the JAX package's ``Metric``
    (and the gRPC API: "L2", "InnerProduct", "Cosine"), so manifests written
    by either package parse in the other."""

    L2 = "L2"
    INNER_PRODUCT = "InnerProduct"
    COSINE = "Cosine"

    @classmethod
    def parse(cls, name: str) -> "Metric":
        for m in cls:
            if m.value.lower() == str(name).lower():
                return m
        raise ValueError(f"unknown metric {name!r}; expected one of "
                         f"{[m.value for m in cls]}")


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """fp32 squared L2 norms along the last axis."""
    xf = x.float()
    return (xf * xf).sum(-1)


def pairwise_distance(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: Metric = Metric.L2,
    x_sq: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pairwise distances between queries ``q [B, D]`` and points ``x [N, D]``.

    Returns ``[B, N]`` fp32 distances where smaller = closer for every
    metric. Both operands are widened to fp32 before the product (the JAX
    package's ``compute_dtype`` knob only ever saw fp32 centroids on this
    path). ``x_sq`` optionally supplies precomputed squared norms of ``x``.
    """
    qf, xf = q.float(), x.float()
    if metric == Metric.L2:
        dots = qf @ xf.T
        if x_sq is None:
            x_sq = squared_norms(xf)
        d = squared_norms(qf)[:, None] - 2.0 * dots + x_sq[None, :]
        return d.clamp_min(0.0)
    elif metric == Metric.INNER_PRODUCT:
        return -(qf @ xf.T)
    elif metric == Metric.COSINE:
        if x_sq is None:
            x_sq = squared_norms(xf)
        dots = qf @ xf.T
        inv = torch.rsqrt(
            squared_norms(qf)[:, None] * x_sq[None, :] + COSINE_EPS
        )
        return 1.0 - dots * inv
    raise ValueError(f"unknown metric: {metric}")
