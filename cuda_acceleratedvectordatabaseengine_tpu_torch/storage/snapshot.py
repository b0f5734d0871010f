"""Whole-index snapshots in the JAX package's directory layout (its
``storage/snapshot.py``), so a snapshot written by either package loads in
the other:

    manifest.json      — IndexManifest (kind, params, shard table)
    centroids.arrow    — [nlist, dim] fp32
    vectors.arrow      — compacted rows in (list, slot) order + uint64 ids
    codebooks.arrow    — PQ only: [m, ks, dsub] fp32
    codes.arrow        — PQ only: [n, m] uint8 in the same row order
    opq_rotation.npy   — OPQ only: [D, D] fp32

Rows are stored compacted (no padding) with per-list extents in the
manifest's shard table. Saving streams the rows list group by list group
off the device; loading creates the arena on the device at the manifest's
capacity and writes the rows in chunks through the append path's
quantization (``models/arena._append_device``), so no padded fp32 host
arena is built (at 1M×768, nlist 1024 that array alone is 4.4 GB).

Port-only repairs, as manifest ``extra`` keys the JAX loader ignores:

- ``"store_residuals": true``: the index keeps a lo plane. It saves the
  rebuilt rows ``stored + lo`` (the JAX package saves the bare stored rows
  and records nothing, so a reloaded index loses its exact rerank), and
  loading rebuilds the stored codes and the lo plane from them. The JAX
  package reading such a snapshot requantizes better rows.
- ``"raw_frame": "original"``: an IVF-PQ snapshot's raw rows are in the
  original frame, also under OPQ (codes and centroids are in the rotated
  one). The JAX package writes original-frame rows since its OPQ
  rerank-frame change but no marker; an unmarked snapshot therefore loads
  as original frame. OPQ ``keep_raw`` snapshots written before that change
  hold rotated rows and cannot be told apart; any other marker is refused.
- ``"rerank_k": R``: an IVF-PQ index's exact-rerank depth
  (``IVFPQConfig.rerank_k``), written where it is set; a snapshot without
  the key loads with 0, the default depth.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.streaming import (
    HostListStore,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
    PackedListArena,
    _append_device,
    _round_up,
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
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.arrow_store import (
    ArrowStorage,
    VectorFileWriter,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.manifest import (
    IndexManifest,
    ShardEntry,
)

VECTORS_FILE = "vectors.arrow"
CENTROIDS_FILE = "centroids.arrow"
CODEBOOKS_FILE = "codebooks.arrow"
CODES_FILE = "codes.arrow"
ROTATION_FILE = "opq_rotation.npy"
# rows a save moves off the device, or a load onto it, at a time
CHUNK_ROWS = PackedListArena.APPEND_DEVICE_ROWS


def _shard_table(counts: np.ndarray) -> list[ShardEntry]:
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return [
        ShardEntry(list_id=i, row_offset=int(offsets[i]),
                   num_vectors=int(counts[i]))
        for i in range(len(counts))
    ]


def _manifest_counts(man: IndexManifest) -> np.ndarray:
    counts = np.zeros(man.nlist, np.int64)
    for s in man.shards:
        counts[s.list_id] = s.num_vectors
    return counts


def _load_manifest(path: str, kind: str) -> IndexManifest:
    man = IndexManifest.load(path)
    if man.kind != kind:
        raise ValueError(f"snapshot at {path} is kind={man.kind!r}")
    return man


def _write_rows(path: str, arena: PackedListArena) -> None:
    """Stream the arena's live rows (``PackedListArena.live_rows``) to a
    vectors file, list group by list group of at most ``CHUNK_ROWS`` rows
    (a longer list is a group of its own)."""
    counts = arena.counts.cpu().numpy().astype(np.int64)
    with VectorFileWriter(path) as w:
        l0 = 0
        while l0 < arena.nlist:
            l1, rows = l0 + 1, int(counts[l0])
            while l1 < arena.nlist and rows + counts[l1] <= CHUNK_ROWS:
                rows += int(counts[l1])
                l1 += 1
            vecs, ids = arena.live_rows(l0, l1)
            w.append(ids, vecs.cpu().numpy())
            l0 = l1


def _read_arena(path: str, counts: np.ndarray, dim: int, dtype,
                capacity: int, anchors, store_residuals: bool,
                device) -> PackedListArena:
    """A device arena holding the compact rows of the vectors file at
    ``path`` (``counts[l]`` rows of list l, in list order), written in
    chunks through ``_append_device`` at their ``(list, slot)``: the codes
    equal what ``PackedListArena.from_host`` makes of the padded rows."""
    nlist = len(counts)
    if counts.size and counts.max() > capacity:
        raise ValueError(f"a list holds {counts.max()} rows, more than the "
                         f"capacity {capacity}")
    arena = PackedListArena.create(nlist, dim, dtype, capacity,
                                   store_residuals=store_residuals,
                                   device=device)
    arena = dataclasses.replace(arena, anchors=anchors)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    row_list = np.repeat(np.arange(nlist), counts)
    row_slot = np.arange(row_list.size) - offsets[row_list]
    ids_table = np.full((nlist, arena.capacity), INVALID_ID, np.uint64)
    r0 = 0
    for ids, vecs in ArrowStorage.iter_vector_chunks(path, CHUNK_ROWS):
        r1 = r0 + len(ids)
        if r1 > row_list.size:
            raise ValueError(f"{path} holds more rows than the shard table")
        lists, slots = row_list[r0:r1], row_slot[r0:r1]
        _append_device(
            arena.arena, arena.arena_sq, arena.arena_scale, arena.anchors,
            torch.from_numpy(lists).to(arena.device),
            torch.from_numpy(slots).to(arena.device),
            torch.from_numpy(vecs).to(arena.device), arena.arena_lo,
        )
        ids_table[lists, slots] = ids
        r0 = r1
    if r0 != row_list.size:
        raise ValueError(f"{path} holds {r0} rows, the shard table "
                         f"{row_list.size}")
    return dataclasses.replace(
        arena, ids=ids_table,
        counts=torch.from_numpy(counts.astype(np.int32)).to(arena.device),
        counts_max=int(counts.max()) if counts.size else 0,
    )


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


# ---------------------------------------------------------------------- #
# IVF-Flat
# ---------------------------------------------------------------------- #

def save_ivf_flat(path: str, index: IVFFlatIndex) -> None:
    """Snapshot an IVF-Flat index (the caller holds its mutation lock, as
    ``IVFFlatIndex.save`` does)."""
    os.makedirs(path, exist_ok=True)
    arena = index.arena
    counts = arena.counts.cpu().numpy()
    _write_rows(os.path.join(path, VECTORS_FILE), arena)
    ArrowStorage.write_centroids(os.path.join(path, CENTROIDS_FILE),
                                 index.centroids.cpu().numpy())
    cfg = index.config
    extra = {}
    if index.calibrated_nprobe:
        extra["calibrated_nprobe"] = int(index.calibrated_nprobe)
    if cfg.multi_assign_eps:
        # replicated ids: a loaded index must keep the 2k scan + dedup
        extra["multi_assign_eps"] = float(cfg.multi_assign_eps)
    if arena.arena_lo is not None:
        extra["store_residuals"] = True
    IndexManifest(
        kind="ivf_flat",
        dimension=cfg.dimension,
        nlist=cfg.nlist,
        metric=cfg.metric.value,
        num_vectors=int(counts.sum()),
        capacity_per_list=arena.capacity,
        dtype=str(cfg.dtype),
        shards=_shard_table(counts),
        extra=extra,
    ).save(path)


def load_ivf_flat(path: str,
                  device: torch.device | str | None = "cuda") -> IVFFlatIndex:
    """Load an IVF-Flat snapshot written by either package onto ``device``
    (the card unless another is named)."""
    man = _load_manifest(path, "ivf_flat")
    cfg = IVFFlatConfig(
        dimension=man.dimension, nlist=man.nlist, metric=man.metric,
        dtype=man.dtype,
        multi_assign_eps=float(man.extra.get("multi_assign_eps", 0.0)),
        store_residuals=bool(man.extra.get("store_residuals", False)),
    )
    idx = IVFFlatIndex(cfg, device=device)
    idx.centroids = _tensor(
        ArrowStorage.read_centroids(os.path.join(path, CENTROIDS_FILE)),
        idx.device)
    idx.arena = _read_arena(
        os.path.join(path, VECTORS_FILE), _manifest_counts(man),
        man.dimension, cfg.dtype, man.capacity_per_list,
        idx._quant_anchors(), cfg.store_residuals, idx.device,
    )
    idx.trained = True
    if man.extra.get("calibrated_nprobe"):
        idx.calibrated_nprobe = int(man.extra["calibrated_nprobe"])
    return idx


def load_ivf_flat_host(path: str):
    """Load an IVF-Flat snapshot into host RAM only, for the streaming
    tier (``StreamingIVFFlatIndex.from_store``): nothing is placed on a
    device, so it takes none. Returns ``(store, centroids_host, config,
    capacity_per_list)``."""
    man = _load_manifest(path, "ivf_flat")
    centroids = ArrowStorage.read_centroids(
        os.path.join(path, CENTROIDS_FILE))
    cfg = IVFFlatConfig(
        dimension=man.dimension, nlist=man.nlist, metric=man.metric,
        dtype=man.dtype,
    )
    ids, vecs = ArrowStorage.read_vectors(os.path.join(path, VECTORS_FILE))
    store = HostListStore(man.nlist, man.dimension)
    for s in man.shards:
        rows = slice(s.row_offset, s.row_offset + s.num_vectors)
        v = np.ascontiguousarray(vecs[rows], np.float32)
        store.vectors[s.list_id] = v
        store.sq[s.list_id] = (
            (v.astype(np.float64) ** 2).sum(-1).astype(np.float32)
        )
        store.ids[s.list_id] = ids[rows].astype(np.uint64)
    return store, centroids, cfg, man.capacity_per_list


# ---------------------------------------------------------------------- #
# IVF-PQ
# ---------------------------------------------------------------------- #

def save_ivf_pq(path: str, index: IVFPQIndex, host_rows=None,
                host_rows_file: bool = False) -> None:
    """Snapshot an IVF-PQ index (the caller holds its mutation lock).

    ``host_rows=(vectors, ids)`` also persists original-frame raw rows
    (any order, matched to the arena by id) when ``keep_raw=False``; for
    cosine they are L2-normalized, as the index ingested them.
    ``host_rows_file=True`` records that the caller already streamed the
    raw rows to the vectors file (``build_index_chunked``'s ``row_sink``)."""
    os.makedirs(path, exist_ok=True)
    cfg = index.config
    counts = index.counts.cpu().numpy()
    live = np.arange(index.capacity)[None, :] < counts[:, None]
    ids = index.ids[live]
    codes = index.code_arena[torch.from_numpy(live).to(index.device)]
    ArrowStorage.write_codes(os.path.join(path, CODES_FILE), ids,
                             codes.cpu().numpy())
    ArrowStorage.write_codebooks(os.path.join(path, CODEBOOKS_FILE),
                                 index.codebooks.cpu().numpy())
    ArrowStorage.write_centroids(os.path.join(path, CENTROIDS_FILE),
                                 index.centroids.cpu().numpy())
    if index.opq_R is not None:
        np.save(os.path.join(path, ROTATION_FILE),
                index.opq_R.cpu().numpy().astype(np.float32))
    if index.raw is not None:
        _write_rows(os.path.join(path, VECTORS_FILE), index.raw)
    elif host_rows is not None:
        hx, hids = host_rows
        hids = np.asarray(hids, np.uint64)
        order = np.argsort(hids, kind="stable")
        pos = np.minimum(np.searchsorted(hids[order], ids), len(hids) - 1)
        if not (hids[order][pos] == ids).all():
            raise ValueError("host_rows ids do not cover the arena's ids")
        rows = np.ascontiguousarray(hx, np.float32)[order[pos]]
        if cfg.metric.value == "Cosine":
            rows = rows / np.maximum(
                np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
        ArrowStorage.write_vectors(os.path.join(path, VECTORS_FILE), ids,
                                   rows)
    has_rows = index.raw is not None or host_rows is not None \
        or host_rows_file
    extra = {"keep_raw": index.raw is not None, "host_rows": has_rows}
    if has_rows:
        extra["raw_frame"] = "original"
    if index.calibrated_nprobe:
        extra["calibrated_nprobe"] = int(index.calibrated_nprobe)
    if cfg.rerank_k:
        extra["rerank_k"] = int(cfg.rerank_k)
    IndexManifest(
        kind="ivf_pq",
        dimension=cfg.dimension,
        nlist=cfg.nlist,
        metric=cfg.metric.value,
        pq_m=cfg.m,
        pq_nbits=cfg.nbits,
        num_vectors=int(counts.sum()),
        capacity_per_list=index.capacity,
        dtype=str(cfg.raw_dtype),
        shards=_shard_table(counts),
        extra=extra,
    ).save(path)


def load_ivf_pq(path: str,
                device: torch.device | str | None = "cuda") -> IVFPQIndex:
    """Load an IVF-PQ snapshot written by either package onto ``device``
    (the card unless another is named); raw rows in a frame other than
    the original one are refused (see the module docstring)."""
    man = _load_manifest(path, "ivf_pq")
    frame = man.extra.get("raw_frame", "original")
    if frame != "original":
        raise ValueError(f"snapshot at {path} holds raw rows in the "
                         f"{frame!r} frame; only 'original' is supported")
    keep_raw = bool(man.extra.get("keep_raw", False))
    rot_path = os.path.join(path, ROTATION_FILE)
    cfg = IVFPQConfig(
        dimension=man.dimension, nlist=man.nlist, m=man.pq_m,
        nbits=man.pq_nbits, metric=man.metric, keep_raw=keep_raw,
        raw_dtype=man.dtype, opq=os.path.isfile(rot_path),
        rerank_k=int(man.extra.get("rerank_k", 0)),
    )
    idx = IVFPQIndex(cfg, device=device)
    dev = idx.device
    if cfg.opq:
        idx.opq_R = _tensor(np.load(rot_path), dev)
    idx.centroids = _tensor(
        ArrowStorage.read_centroids(os.path.join(path, CENTROIDS_FILE)), dev)
    idx.codebooks = _tensor(
        ArrowStorage.read_codebooks(os.path.join(path, CODEBOOKS_FILE)), dev)
    ids, codes = ArrowStorage.read_codes(os.path.join(path, CODES_FILE))
    counts = _manifest_counts(man)
    nlist = man.nlist
    cap = _round_up(max(man.capacity_per_list, PackedListArena.SLOT_ALIGN),
                    PackedListArena.SLOT_ALIGN)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    row_list = np.repeat(np.arange(nlist), counts)
    row_slot = np.arange(len(ids)) - offsets[row_list]
    codes_t = torch.zeros((nlist, cfg.m, cap), dtype=torch.uint8, device=dev)
    codes_t[torch.from_numpy(row_list).to(dev), :,
            torch.from_numpy(row_slot).to(dev)] = \
        torch.from_numpy(codes).to(dev)
    idx.code_arena_t = codes_t
    idx._refresh_code_sq()
    if keep_raw:
        idx.raw = _read_arena(
            os.path.join(path, VECTORS_FILE), counts, man.dimension,
            torch_dtype(man.dtype), cap, None, False, dev)
        if not (idx.raw.ids[row_list, row_slot] == ids).all():
            raise ValueError(f"snapshot at {path}: raw rows and codes "
                             f"disagree on ids")
    else:
        idx.raw = None
        id_table = np.full((nlist, cap), INVALID_ID, np.uint64)
        id_table[row_list, row_slot] = ids
        idx._counts = torch.from_numpy(counts.astype(np.int32)).to(dev)
        idx._ids = id_table
    idx.trained = True
    if man.extra.get("calibrated_nprobe"):
        idx.calibrated_nprobe = int(man.extra["calibrated_nprobe"])
    return idx


def load_ivf_pq_capacity(path: str, rerank_k: int = 128, margin: float = 0.0,
                         device: torch.device | str | None = "cuda"
                         ) -> IVFPQIndex:
    """Load a ``keep_raw=False`` IVF-PQ snapshot as the capacity tier: the
    codes go to ``device`` (~m bytes a row), the snapshot's raw rows into
    an int8 host-RAM store that serves the exact rerank
    (``io_host/host_rerank.HostReranker``). The rows may be in (list,
    slot) order or in arrival order (the builder streams them chunk by
    chunk): each row's list comes from matching its id against the code
    arena's id table. The store's anchors are the centroids in the rows'
    original frame (OPQ centroids un-rotated). The returned index is
    ``read_only``: an add would desynchronize the host store."""
    man = _load_manifest(path, "ivf_pq")
    if man.extra.get("keep_raw", False):
        raise ValueError(
            "snapshot has a device-resident raw arena (keep_raw=True); the "
            "capacity tier expects keep_raw=False codes + host rows"
        )
    if not man.extra.get("host_rows", False):
        raise ValueError(
            "snapshot has no host rows; save with "
            "save_ivf_pq(..., host_rows=(vectors, ids))"
        )
    idx = load_ivf_pq(path, device=device)
    ids, vecs = ArrowStorage.read_vectors(os.path.join(path, VECTORS_FILE))
    ids_tab = idx.ids
    valid = ids_tab != INVALID_ID
    a_lists = np.nonzero(valid)[0]
    a_ids = ids_tab[valid]
    order = np.argsort(a_ids, kind="stable")
    pos = np.minimum(np.searchsorted(a_ids[order], ids),
                     max(len(a_ids) - 1, 0))
    if len(a_ids) == 0 or not (a_ids[order][pos] == ids).all():
        raise ValueError(
            "vectors file ids do not match the code arena's id table"
        )
    assignments = a_lists[order][pos].astype(np.int64)
    centroids = idx.centroids.cpu().numpy().astype(np.float32)
    if idx.opq_R is not None:
        centroids = centroids @ idx.opq_R.cpu().numpy().astype(np.float32).T
    store = HostListStore.from_assignments(
        vecs, ids, assignments, man.nlist, dtype="int8", anchors=centroids
    )
    idx.attach_host_rerank(store, rerank_k=rerank_k, margin=margin)
    idx.read_only = True
    return idx
