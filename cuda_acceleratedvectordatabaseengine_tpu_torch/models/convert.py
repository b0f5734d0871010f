"""Carry an IVF-Flat index's state across from the JAX package.

:func:`ivf_flat_from_arrays` takes the JAX index's device state as numpy
arrays (``np.asarray`` of each ``jax.Array``) and builds this package's
``IVFFlatIndex`` with identical centroids, codes, scales, norms, anchors,
counts and ids, so both packages can search the *same* index. No JAX import
is needed: bfloat16 arrays arrive as ``ml_dtypes`` numpy arrays and are
reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    PackedListArena,
    torch_dtype,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat import (
    IVFFlatConfig,
    IVFFlatIndex,
)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    # an owned, writable copy: arena appends write in place, and the
    # arrays of a jax.Array are read-only views
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":   # ml_dtypes: same bits as torch.bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device
        )
    return torch.from_numpy(a).to(device)


def ivf_flat_from_arrays(
    config: IVFFlatConfig,
    *,
    centroids: np.ndarray,
    arena: np.ndarray,
    arena_sq: np.ndarray,
    arena_scale: np.ndarray | None,
    anchors: np.ndarray | None,
    counts: np.ndarray,
    ids: np.ndarray,
    counts_max: int | None,
    device: torch.device | str = "cpu",
) -> IVFFlatIndex:
    """An ``IVFFlatIndex`` on ``device`` holding exactly this state.
    ``arena`` must already be in ``config.dtype`` (int8 codes, bf16 or
    fp32 rows)."""
    dtype = torch_dtype(config.dtype)
    arena_t = _tensor(arena, device)
    if arena_t.dtype != dtype:
        raise ValueError(
            f"arena dtype {arena_t.dtype} does not match config dtype {dtype}"
        )
    nlist, capacity, dim = arena_t.shape
    if (nlist, dim) != (config.nlist, config.dimension):
        raise ValueError(
            f"arena [nlist={nlist}, dim={dim}] does not match the config "
            f"[nlist={config.nlist}, dim={config.dimension}]"
        )
    idx = IVFFlatIndex(config, device=device)
    idx.centroids = _tensor(np.asarray(centroids, np.float32), device)
    idx.arena = PackedListArena(
        nlist=nlist,
        dim=dim,
        dtype=dtype,
        capacity=capacity,
        arena=arena_t,
        arena_sq=_tensor(np.asarray(arena_sq, np.float32), device),
        counts=_tensor(np.asarray(counts, np.int32), device),
        ids=np.asarray(ids, np.uint64).copy(),
        arena_scale=(
            _tensor(np.asarray(arena_scale, np.float32), device)
            if arena_scale is not None else None
        ),
        anchors=(
            _tensor(np.asarray(anchors, np.float32), device)
            if anchors is not None else None
        ),
        counts_max=counts_max,
    )
    idx.trained = True
    return idx
