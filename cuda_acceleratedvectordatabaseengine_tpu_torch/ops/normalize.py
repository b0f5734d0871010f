"""Vector normalization (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/ops/normalize.py``)."""

from __future__ import annotations

import torch

NORMALIZE_EPS = 1e-8


def l2_normalize(x: torch.Tensor, eps: float = NORMALIZE_EPS) -> torch.Tensor:
    """L2-normalize along the last axis with ``rsqrt(‖x‖² + eps)``, computed
    in fp32 and cast back to the input dtype."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).sum(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype)
