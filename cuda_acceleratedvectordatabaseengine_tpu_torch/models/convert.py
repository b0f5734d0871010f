"""Carry an index's state across from the JAX package.

:func:`ivf_flat_from_arrays` and :func:`ivf_pq_from_arrays` take the JAX
index's device state as numpy arrays (``np.asarray`` of each
``jax.Array``) and build this package's ``IVFFlatIndex`` / ``IVFPQIndex``
with identical centroids, codes, codebooks, rotation, scales, norms,
anchors, counts and ids, so both packages can search the *same* index;
:func:`sharded_ivf_flat_from_arrays` does the same for a JAX sharded
IVF-Flat view's stripes. No JAX import is needed: bfloat16 arrays arrive
as ``ml_dtypes`` numpy arrays and are reinterpreted bit for bit.
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
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq import (
    IVFPQConfig,
    IVFPQIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (
    resolve_device,
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
    arena_lo: np.ndarray | None = None,
    device: torch.device | str | None = "cuda",
) -> IVFFlatIndex:
    """An ``IVFFlatIndex`` on ``device`` (the card unless another is named)
    holding exactly this state. ``arena`` must already be in
    ``config.dtype`` (int8 codes, bf16 or fp32 rows); ``arena_lo`` is the
    bf16 residual plane of a ``store_residuals`` index."""
    dtype = torch_dtype(config.dtype)
    device = resolve_device(device)
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
        arena_lo=_tensor(arena_lo, device) if arena_lo is not None else None,
    )
    idx.trained = True
    return idx


def ivf_pq_from_arrays(
    config: IVFPQConfig,
    *,
    centroids: np.ndarray,
    codebooks: np.ndarray,
    codes_t: np.ndarray,
    code_sq: np.ndarray,
    counts: np.ndarray,
    ids: np.ndarray,
    raw_arena: np.ndarray | None,
    raw_sq: np.ndarray | None,
    raw_scale: np.ndarray | None,
    raw_anchors: np.ndarray | None,
    opq_R: np.ndarray | None,
    device: torch.device | str | None = "cuda",
) -> IVFPQIndex:
    """An ``IVFPQIndex`` on ``device`` (the card unless another is named)
    holding exactly this state: codes ``codes_t [nlist, m, cap]`` uint8
    (the transposed storage), and, when ``config.keep_raw``, the raw arena
    in ``config.raw_dtype`` with the same capacity."""
    device = resolve_device(device)
    codes = _tensor(np.asarray(codes_t, np.uint8), device)
    nlist, m, capacity = codes.shape
    if (nlist, m) != (config.nlist, config.m):
        raise ValueError(
            f"codes [nlist={nlist}, m={m}] do not match the config "
            f"[nlist={config.nlist}, m={config.m}]"
        )
    if (raw_arena is not None) != config.keep_raw:
        raise ValueError("raw_arena must be given exactly when keep_raw")
    idx = IVFPQIndex(config, device=device)
    idx.centroids = _tensor(np.asarray(centroids, np.float32), device)
    idx.codebooks = _tensor(np.asarray(codebooks, np.float32), device)
    idx.opq_R = (_tensor(np.asarray(opq_R, np.float32), device)
                 if opq_R is not None else None)
    idx.code_arena_t = codes
    idx.code_sq = _tensor(np.asarray(code_sq, np.float32), device)
    counts_t = _tensor(np.asarray(counts, np.int32), device)
    ids = np.asarray(ids, np.uint64).copy()
    if raw_arena is not None:
        arena_t = _tensor(raw_arena, device)
        dtype = torch_dtype(config.raw_dtype)
        if arena_t.dtype != dtype or arena_t.shape[1] != capacity:
            raise ValueError(
                f"raw arena {tuple(arena_t.shape)} {arena_t.dtype} does not "
                f"match raw_dtype {dtype} and code capacity {capacity}"
            )
        opt = lambda a: None if a is None else _tensor(  # noqa: E731
            np.asarray(a, np.float32), device)
        idx.raw = PackedListArena(
            nlist=nlist, dim=config.dimension, dtype=dtype,
            capacity=capacity, arena=arena_t,
            arena_sq=opt(raw_sq), counts=counts_t, ids=ids,
            arena_scale=opt(raw_scale), anchors=opt(raw_anchors),
            counts_max=int(np.max(counts)) if np.size(counts) else 0,
        )
    else:
        idx._counts = counts_t
        idx._ids = ids
    idx.trained = True
    return idx


def sharded_ivf_flat_from_arrays(
    config: IVFFlatConfig,
    mesh,
    *,
    arena_s: np.ndarray,
    arena_sq_s: np.ndarray,
    arena_scale: np.ndarray | None,
    anchors: np.ndarray | None,
    centroids: np.ndarray,
    counts: np.ndarray,
    ids: np.ndarray,
    global_cap: int,
    scan_impl: str = "auto",
):
    """A ``parallel.ShardedIVFFlatIndex`` on ``mesh`` holding exactly the
    state of a JAX sharded view (``np.asarray`` of its arrays): the
    striped arena ``arena_s [nlist, global_cap, D]`` in physical order
    (stripe ``s`` is the slot range ``[s·cap_l, (s+1)·cap_l)``, local slot
    ``j`` = logical ``j·N + s``), its norms, its per-row scales
    (``arena_scale``, None when the view has none), its residual
    ``anchors`` (None likewise), the centroids, the counts and the
    ``[nlist, global_cap]`` id table. A view built by ``build_on_mesh``
    has no base; this is how its stripes cross over. The view is
    read-only, as a mesh-built one is."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel.sharded \
        import ShardedIVFFlatIndex

    n = mesh.size
    nlist, cap, dim = np.shape(arena_s)
    if cap != global_cap or cap % n:
        raise ValueError(
            f"striped arena capacity {cap} does not match global_cap "
            f"{global_cap} over {n} shards")
    cap_l = cap // n

    def stripes(a):
        return [_tensor(np.asarray(a)[:, s * cap_l:(s + 1) * cap_l], dev)
                for s, dev in enumerate(mesh.devices)]

    arena_parts = stripes(arena_s)
    if arena_parts[0].dtype != torch_dtype(config.dtype):
        raise ValueError(
            f"arena dtype {arena_parts[0].dtype} does not match config "
            f"dtype {config.dtype}")
    counts = np.asarray(counts, np.int64)
    return ShardedIVFFlatIndex._from_stripes(
        mesh, config, scan_impl,
        arena_parts,
        stripes(np.asarray(arena_sq_s, np.float32)),
        (stripes(np.asarray(arena_scale, np.float32))
         if arena_scale is not None else None),
        ([_tensor(np.asarray(anchors, np.float32), dev)
          for dev in mesh.devices] if anchors is not None else None),
        torch.from_numpy(counts.astype(np.int32)),
        _tensor(np.asarray(centroids, np.float32), mesh.leader),
        np.asarray(ids, np.uint64).copy(), int(global_cap),
        int(counts.max()) if counts.size else 0,
    )
