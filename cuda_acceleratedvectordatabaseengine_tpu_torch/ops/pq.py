"""Product quantization ops (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/ops/pq.py``).

Codebook training (per-subspace k-means), OPQ rotation learning, residual
encode / decode, ADC distance tables and the gather ADC lookup. Every
product here is a plain fp32 matmul or gather: the JAX package had no
Pallas kernel in this module either (its ADC kernel, K2, lives in
``ops/grouped_pq_scan.py`` here).

Precision: the rotation algebra (``_mm``, ``_orthonormalize``, the
Procrustes step of ``opq_fit``) runs in full fp32, TF32 off. The JAX
package learned
that the hard way: single-pass bf16 rotations left ``max|RᵀR − I| ≈ 7e-3``
and capped OPQ rerank recall (its ``ops/pq.py:108-115``).

``torch.Generator`` does not replay ``jax.random``: trained codebooks and
rotations differ from the JAX package's and are held to them by quality
(reconstruction error, isometry), not value.
"""

from __future__ import annotations

import torch

# (ops/kmeans imports ops/distance, which switches TF32 off)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.kmeans import (
    kmeans_fit,
)


def train_product_quantizer(
    x: torch.Tensor,
    m: int,
    ks: int = 256,
    iters: int = 10,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Per-subspace codebooks ``[m, ks, dsub]`` fp32: one
    ``kmeans_fit(init="random")`` per ``dsub``-wide slice of ``x [n, dim]``,
    all drawing from ``generator`` (on ``x``'s device)."""
    n, dim = x.shape
    if dim % m:
        raise ValueError(f"dim {dim} not divisible by m {m}")
    dsub = dim // m
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    xf = x.float()
    out = []
    for j in range(m):
        cb, _ = kmeans_fit(
            xf[:, j * dsub:(j + 1) * dsub].contiguous(), ks, iters=iters,
            init="random", generator=generator,
        )
        out.append(cb)
    return torch.stack(out)


def _refresh_codebooks(xr, codes, codebooks, chunk_size: int = 2048):
    """One warm Lloyd step per subspace: each codeword becomes the mean of
    the (rotated) subvectors assigned to it; a codeword nobody picked
    keeps its value. One-hot matmuls accumulated over row chunks
    (deterministic, unlike scatter-add atomics)."""
    n, dim = xr.shape
    m, ks, dsub = codebooks.shape
    dev = xr.device
    sums = torch.zeros((m, ks, dsub), dtype=torch.float32, device=dev)
    cnts = torch.zeros((m, ks), dtype=torch.float32, device=dev)
    ar = torch.arange(ks, device=dev)
    for s0 in range(0, n, chunk_size):
        x_sub = xr[s0:s0 + chunk_size].float().reshape(-1, m, dsub)
        onehot = (codes[s0:s0 + chunk_size].long().T[:, :, None]
                  == ar).float()                            # [m, c, ks]
        sums += torch.bmm(onehot.transpose(1, 2), x_sub.transpose(0, 1))
        cnts += onehot.sum(1)
    return torch.where(
        cnts[..., None] > 0, sums / cnts.clamp_min(1.0)[..., None], codebooks
    )


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 matmul of the rotation algebra (TF32 is off package-wide)."""
    return a @ b


def _orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Pull a near-orthogonal matrix back onto the orthogonal manifold with
    two Newton–Schulz iterations, R ← ½R(3I − RᵀR): the published rotation
    is an isometry to fp32 roundoff however it was produced."""
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    for _ in range(2):
        R = 0.5 * _mm(R, 3.0 * eye - _mm(R.T, R))
    return R


def _opq_step(x, R, codebooks):
    """One OPQ-NP alternation: Procrustes rotation update from the current
    code reconstruction, then a warm Lloyd refresh of the codebooks in the
    new rotated frame."""
    xr = _mm(x, R)
    y = pq_decode(pq_encode(xr, codebooks), codebooks)
    # min_R ‖xR − y‖_F over orthogonal R → R = U Vᵀ with U S Vᵀ = svd(xᵀy)
    u, _, vt = torch.linalg.svd(_mm(x.T, y), full_matrices=False)
    R = _orthonormalize(_mm(u, vt))
    xr = _mm(x, R)
    return R, _refresh_codebooks(xr, pq_encode(xr, codebooks), codebooks)


def opq_fit(
    x: torch.Tensor,
    m: int,
    ks: int = 256,
    iters: int = 10,
    opq_iters: int = 6,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimized Product Quantization (OPQ-NP, Ge et al. CVPR'13): an
    orthogonal ``R [dim, dim]`` and codebooks minimizing
    ``‖xR − decode(encode(xR))‖²``. As in the JAX package, the codebooks
    dragged through the alternation are replaced at the end by a fresh
    per-subspace k-means at the converged rotation. Returns
    ``(R, codebooks)``."""
    x = x.float()
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    codebooks = train_product_quantizer(x, m, ks, iters, generator)
    R = torch.eye(x.shape[1], dtype=torch.float32, device=x.device)
    for _ in range(opq_iters):
        R, codebooks = _opq_step(x, R, codebooks)
    codebooks = train_product_quantizer(_mm(x, R), m, ks, iters, generator)
    return R, codebooks


def pq_encode(
    x: torch.Tensor,
    codebooks: torch.Tensor,
    chunk_size: int = 4096,
) -> torch.Tensor:
    """``[n, m]`` uint8 codes: per subspace, the codeword minimising
    ``‖c‖² − 2·x·c`` (``‖x‖²`` is constant in the argmin). Chunked over n:
    the ``[m, n, ks]`` distance tensor is the transient it bounds."""
    n, dim = x.shape
    m, ks, dsub = codebooks.shape
    cb = codebooks.float()
    c_sq = (cb * cb).sum(-1)                                 # [m, ks]
    cb_t = cb.transpose(1, 2)                                # [m, dsub, ks]
    out = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    for s0 in range(0, n, chunk_size):
        x_sub = x[s0:s0 + chunk_size].float().reshape(-1, m, dsub)
        dots = torch.bmm(x_sub.transpose(0, 1), cb_t)         # [m, c, ks]
        d = c_sq[:, None, :] - 2.0 * dots
        out[s0:s0 + chunk_size] = d.argmin(-1).T.to(torch.uint8)
    return out


def pq_distance_tables(
    residuals: torch.Tensor,
    codebooks: torch.Tensor,
) -> torch.Tensor:
    """ADC tables ``[B, m, ks]``: ``table[b, j, c] = ‖r_bj − codebook_jc‖²``
    for residuals ``[B, dim]`` (query minus coarse centroid)."""
    b, _ = residuals.shape
    m, ks, dsub = codebooks.shape
    r_sub = residuals.float().reshape(b, m, dsub)
    cb = codebooks.float()
    dots = torch.einsum("bmd,mkd->bmk", r_sub, cb)
    r_sq = (r_sub * r_sub).sum(-1)                           # [B, m]
    c_sq = (cb * cb).sum(-1)                                 # [m, ks]
    return r_sq[:, :, None] - 2.0 * dots + c_sq[None]


def pq_adc_lookup(
    tables: torch.Tensor,
    codes: torch.Tensor,
) -> torch.Tensor:
    """Gather ADC: distance of each coded vector ``Σ_j table[b, j,
    code[b, j, l]]`` for subspace-major codes ``[B, m, L]`` (the storage
    layout); returns ``[B, L]`` fp32. The port's CPU / ``"xla"`` ADC."""
    return torch.gather(tables, -1, codes.long()).sum(1)


def pq_decode(
    codes: torch.Tensor,
    codebooks: torch.Tensor,
) -> torch.Tensor:
    """Reconstructed residuals ``[n, m·dsub]`` fp32 from codes ``[n, m]``.
    Not chunked: the JAX package chunked only because TPU tiling padded the
    ``[n, m, dsub]`` gather 16×; here it is the size of the output."""
    m = codebooks.shape[0]
    picked = codebooks.float()[
        torch.arange(m, device=codes.device)[None, :], codes.long()
    ]                                                        # [n, m, dsub]
    return picked.reshape(codes.shape[0], -1)
