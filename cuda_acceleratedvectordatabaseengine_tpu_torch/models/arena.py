"""Packed, padded inverted-list arena on torch tensors (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/models/arena.py``).

Layout, identical to the JAX package so state carries across:

    arena     [nlist, capacity, dim]   int8 / bfloat16 / float32
    arena_sq  [nlist, capacity]        fp32 squared norms of the stored point
    counts    [nlist]                  int32 live rows
    ids       [nlist, capacity]        uint64, host numpy (user ids)
    arena_lo  [nlist, capacity, dim]   optional bf16 residual plane

A vector's identity on the device is its int32 global position
``list_id * capacity + slot``; the host maps positions back to user ids.

Mutation rule. JAX arrays are immutable; here mutations write in place
and return a handle with a NEW ``counts`` tensor and a copied id table
(copy-on-write), so a reader that holds the old handle keeps a consistent
(counts, ids) pair. An append writes only slots at or beyond the old
counts; ``grow`` allocates new tensors. A removal moves surviving tail
rows into holes INSIDE the occupied prefix, so a search that snapshotted
the old handle could read moved rows. It is safe only because every
index enqueues its device search under the same lock as its mutations,
on the device's one stream: device work then runs in lock order, and a
search enqueued before a removal reads the rows its id table describes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (
    resolve_device,
)

INVALID_ID = np.uint64(0xFFFFFFFFFFFFFFFF)  # UINT64_MAX sentinel

DTYPES = {
    "int8": torch.int8,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def torch_dtype(name) -> torch.dtype:
    """Map a config dtype name ("int8" | "bfloat16" | "float32") to torch."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[str(name)]
    except KeyError:
        raise ValueError(
            f"unsupported arena dtype {name!r}; expected one of {list(DTYPES)}"
        ) from None


def _append_device(arena, arena_sq, arena_scale, anchors, lists, slots,
                   vec_f32, arena_lo=None):
    """Write a batch of rows into their pre-assigned ``(lists, slots)`` in
    place. int8 arenas use per-row symmetric scales (``arena_scale``);
    with ``anchors`` (residual mode) the row encodes ``x − anchor[list]``.
    ``arena_sq`` holds the squared norm of the STORED (dequantized) point,
    so scan distances are distances to what the arena holds. With
    ``arena_lo`` the bf16 residual ``x − stored(x)`` goes there too."""
    if arena.dtype == torch.int8:
        a_rows = anchors[lists] if anchors is not None else 0.0
        res = vec_f32 - a_rows
        row_scale = res.abs().amax(-1).clamp_min(1e-12) / 127.0
        hi_f = torch.round(res / row_scale[:, None]).clamp(-127, 127)
        hi = hi_f.to(torch.int8)
        deq = a_rows + hi_f * row_scale[:, None]
        arena_scale[lists, slots] = row_scale
    else:
        hi = vec_f32.to(arena.dtype)
        deq = hi.float()
    arena[lists, slots] = hi
    arena_sq[lists, slots] = (deq * deq).sum(-1)
    if arena_lo is not None:
        arena_lo[lists, slots] = (vec_f32 - deq).to(torch.bfloat16)


def _remove_device(planes, src, dst) -> None:
    """Swap-from-tail compaction in place: copy rows ``src`` into the holes
    ``dst`` along the first axis of every plane (None entries skipped; an
    arena passes its planes flattened to ``[nlist · cap, ...]``, so rows
    are global positions). ``src`` and ``dst`` are disjoint (tail
    survivors, holes), so one gather then one scatter per plane is exact;
    a delete costs O(moved rows)."""
    for t in planes:
        if t is not None:
            t.index_copy_(0, dst, t.index_select(0, src))


def plan_removals(
    counts: np.ndarray, lists: np.ndarray, slots: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side swap-from-tail plan for deleting ``(lists[i], slots[i])``
    (copied from the JAX package).

    Returns ``(move_lists, src_slots, dst_slots, new_counts)``: moving row
    ``(move_lists[i], src_slots[i])`` → ``(move_lists[i], dst_slots[i])``
    compacts every affected list's live rows into its prefix. For each
    list with deletion set D (|D| = d, fill c, new fill c−d): holes =
    D ∩ [0, c−d), tail survivors = [c−d, c) \\ D — the two sets always
    have equal size, so each hole is filled by one surviving tail row and
    no other row moves. Slots ≥ the list's fill are ignored (stale)."""
    moves_l, moves_src, moves_dst = [], [], []
    new_counts = counts.copy()
    order = np.argsort(lists, kind="stable")
    ls, ss = lists[order], slots[order]
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(ls)) + 1, [len(ls)]]
    )
    for a, b in zip(starts[:-1], starts[1:]):
        l = int(ls[a])
        d = np.unique(ss[a:b])
        cnt = int(counts[l])
        d = d[d < cnt]
        if d.size == 0:
            continue
        nc = cnt - d.size
        dset = set(d.tolist())
        holes = [s for s in d.tolist() if s < nc]
        tail = [s for s in range(nc, cnt) if s not in dset]
        moves_l.extend([l] * len(holes))
        moves_src.extend(tail)
        moves_dst.extend(holes)
        new_counts[l] = nc
    return (
        np.asarray(moves_l, np.int64),
        np.asarray(moves_src, np.int64),
        np.asarray(moves_dst, np.int64),
        new_counts,
    )


def apply_removal_to_ids(
    ids_table: np.ndarray,
    move_l: np.ndarray,
    src_s: np.ndarray,
    dst_s: np.ndarray,
    new_counts: np.ndarray,
    old_counts: np.ndarray,
) -> np.ndarray:
    """Mirror a ``plan_removals`` plan onto a host id table, copy-on-write
    (concurrent readers may hold the old table): apply the moves, then
    invalidate each shrunken list's tail (copied from the JAX package)."""
    new_ids = ids_table.copy()
    new_ids[move_l, dst_s] = new_ids[move_l, src_s]
    for l in np.flatnonzero(new_counts != old_counts):
        new_ids[l, new_counts[l]: old_counts[l]] = INVALID_ID
    return new_ids


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compute_append_slots(
    counts: np.ndarray, assignments: np.ndarray
) -> np.ndarray:
    """Destination slot for each appended row: current list fill + stable rank
    among same-list rows in the batch (copied from the JAX package)."""
    n = assignments.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(assignments, kind="stable")
    sorted_lists = assignments[order]
    boundaries = np.flatnonzero(np.diff(sorted_lists)) + 1
    starts = np.concatenate([[0], boundaries])
    sizes = np.diff(np.concatenate([starts, [n]]))
    group_start_of_row = np.repeat(starts, sizes)
    ranks_sorted = np.arange(n) - group_start_of_row
    slots = np.empty(n, np.int64)
    slots[order] = counts[sorted_lists] + ranks_sorted
    return slots


def _choose_capacity(
    counts: np.ndarray, align: int, max_factor: float = 8.0,
    spill_budget: float = 0.01,
) -> int:
    """Per-list arena capacity for a bulk build: the smallest clamp that
    keeps the spill fraction ≤ ``spill_budget``, clipped to
    ``[1.5, max_factor] × mean`` (copied from the JAX package)."""
    n = int(counts.sum())
    if n == 0:
        return align
    mean = max(counts.mean(), 1.0)
    lo, hi = 1, int(counts.max())
    while lo < hi:                      # binary search on the clamp
        mid = (lo + hi) // 2
        spill = n - int(np.minimum(counts, mid).sum())
        if spill <= spill_budget * n:
            hi = mid
        else:
            lo = mid + 1
    cap = int(np.clip(lo, mean * 1.5 + 1, mean * max_factor))
    return max(-(-cap // align) * align, align)


def _balance_assignments(
    choices: np.ndarray, cap: int, nlist: int,
    initial_counts: np.ndarray | None = None,
) -> np.ndarray:
    """Greedy capacity-respecting placement over ranked centroid choices
    ``[n, t]``: rank-0 lists fill first; rows that would overflow a full
    list fall to their next choice; anything still unplaced lands in the
    least-full list with room (copied from the JAX package)."""
    n, t = choices.shape
    placed = np.full(n, -1, np.int64)
    counts = (
        initial_counts.astype(np.int64).copy()
        if initial_counts is not None else np.zeros(nlist, np.int64)
    )
    for r in range(t):
        todo = np.flatnonzero(placed < 0)
        if todo.size == 0:
            break
        lists = choices[todo, r].astype(np.int64)
        slots = compute_append_slots(counts, lists)
        ok = slots < cap
        placed[todo[ok]] = lists[ok]
        counts = np.bincount(
            placed[placed >= 0], minlength=nlist
        ) + (initial_counts.astype(np.int64)
             if initial_counts is not None else 0)
    leftovers = np.flatnonzero(placed < 0)
    for i in leftovers:
        # only lists with free slots: the chunked build never reallocates
        open_lists = np.flatnonzero(counts < cap)
        if open_lists.size == 0:
            raise ValueError(
                f"arena full: {n} rows into nlist={nlist} × cap={cap}"
            )
        l = int(open_lists[np.argmin(counts[open_lists])])
        placed[i] = l
        counts[l] += 1
    return placed.astype(np.int32)


@dataclasses.dataclass
class PackedListArena:
    """Device-resident packed inverted lists + host-side id table."""

    nlist: int
    dim: int
    dtype: torch.dtype
    capacity: int
    arena: torch.Tensor       # [nlist, capacity, dim]
    arena_sq: torch.Tensor    # [nlist, capacity] fp32
    counts: torch.Tensor      # [nlist] int32
    ids: np.ndarray           # [nlist, capacity] uint64 host
    # int8 arenas: per-row symmetric dequant scales [nlist, capacity]
    # (stored point = anchor[l] + scale[l, slot] · code).
    arena_scale: torch.Tensor | None = None
    # Residual anchors [nlist, dim] fp32 (the coarse centroids): int8 codes
    # encode x − anchor[list].
    anchors: torch.Tensor | None = None
    # Optional bf16 residual plane: lo = fp32(x) − stored(x). stored + lo
    # rebuilds x to ~16 mantissa bits for the exact rerank, while the scan
    # reads only the stored plane. Absent on fp32 arenas.
    arena_lo: torch.Tensor | None = None
    # Host-tracked max(counts): lets searches scan only the occupied slot
    # prefix (``scan_capacity_hint``). None = unknown.
    counts_max: int | None = None

    # Slot granularity for capacity growth.
    SLOT_ALIGN = 128
    # Rows per device append step: bounds the fp32 staging transients
    # (residual, rounding and norm planes are each [rows, dim] fp32).
    APPEND_DEVICE_ROWS = 262_144

    @property
    def device(self) -> torch.device:
        return self.arena.device

    @classmethod
    def create(
        cls, nlist: int, dim: int, dtype=torch.bfloat16, capacity: int = 128,
        store_residuals: bool = False,
        device: torch.device | str | None = "cuda",
    ) -> "PackedListArena":
        """An empty arena on ``device`` (the card unless another is
        named); ``store_residuals`` adds the bf16 lo plane (not on fp32
        arenas, which store x exactly)."""
        dtype = torch_dtype(dtype)
        device = resolve_device(device)
        capacity = _round_up(max(capacity, cls.SLOT_ALIGN), cls.SLOT_ALIGN)
        scale = (
            torch.zeros((nlist, capacity), dtype=torch.float32, device=device)
            if dtype == torch.int8 else None
        )
        lo = (
            torch.zeros((nlist, capacity, dim), dtype=torch.bfloat16,
                        device=device)
            if store_residuals and dtype != torch.float32 else None
        )
        return cls(
            nlist=nlist,
            dim=dim,
            dtype=dtype,
            capacity=capacity,
            arena=torch.zeros((nlist, capacity, dim), dtype=dtype,
                              device=device),
            arena_sq=torch.zeros((nlist, capacity), dtype=torch.float32,
                                 device=device),
            counts=torch.zeros((nlist,), dtype=torch.int32, device=device),
            ids=np.full((nlist, capacity), INVALID_ID, np.uint64),
            arena_scale=scale,
            arena_lo=lo,
            counts_max=0,
        )

    @property
    def total_vectors(self) -> int:
        return int(self.counts.sum().item())

    def scan_capacity_hint(self) -> int | None:
        """Slot-prefix bound for the scans: the 128-rounded occupancy when
        it is known AND smaller than the allocation, else None (scan the
        full capacity)."""
        if self.counts_max is None:
            return None
        occ = _round_up(max(int(self.counts_max), 1), self.SLOT_ALIGN)
        return occ if occ < self.capacity else None

    def nbytes_device(self) -> int:
        n = (
            self.arena.numel() * self.arena.element_size()
            + self.arena_sq.numel() * 4
            + self.counts.numel() * 4
        )
        if self.arena_scale is not None:
            n += self.arena_scale.numel() * 4
        if self.arena_lo is not None:
            n += self.arena_lo.numel() * 2
        return n

    # ------------------------------------------------------------------ #
    # ingest
    # ------------------------------------------------------------------ #

    def append(
        self,
        vectors: np.ndarray | torch.Tensor,
        ids: np.ndarray,
        assignments: np.ndarray,
    ) -> "PackedListArena":
        """Append ``vectors [n, dim]`` with user ``ids [n]`` into the lists
        given by ``assignments [n]`` (host int array). Returns the updated
        handle; see the module docstring for what is written in place."""
        n = vectors.shape[0]
        if n == 0:
            return self
        assignments = np.asarray(assignments, np.int64)
        counts_h = self.counts.cpu().numpy().astype(np.int64)
        per_list = np.bincount(assignments, minlength=self.nlist)
        needed = counts_h + per_list
        out = self
        max_needed = int(needed.max())
        if max_needed > self.capacity:
            out = out.grow(_round_up(max(max_needed, int(self.capacity * 1.5)),
                                     self.SLOT_ALIGN))
        slots = compute_append_slots(counts_h, assignments)

        dev = out.device
        lists_d = torch.from_numpy(assignments).to(dev)
        slots_d = torch.from_numpy(slots).to(dev)
        step = self.APPEND_DEVICE_ROWS
        for s0 in range(0, n, step):
            s1 = min(s0 + step, n)
            if isinstance(vectors, torch.Tensor):
                vec = vectors[s0:s1].to(device=dev, dtype=torch.float32)
            else:
                vec = torch.from_numpy(
                    np.ascontiguousarray(vectors[s0:s1], np.float32)
                ).to(dev)
            _append_device(
                out.arena, out.arena_sq, out.arena_scale, out.anchors,
                lists_d[s0:s1], slots_d[s0:s1], vec, out.arena_lo,
            )
        new_counts = torch.from_numpy(needed.astype(np.int32)).to(dev)
        new_ids = out.ids.copy()
        new_ids[assignments, slots] = np.asarray(ids).astype(np.uint64)
        return dataclasses.replace(
            out, counts=new_counts, ids=new_ids, counts_max=max_needed,
        )

    def remove(
        self, lists: np.ndarray, slots: np.ndarray
    ) -> tuple["PackedListArena", int]:
        """Delete the rows at ``(lists[i], slots[i])`` by swap-from-tail
        compaction (see ``plan_removals``): every plane (codes, norms,
        scales, lo) moves the same rows in place, and the returned handle
        has new counts and a copied id table. Returns ``(new_arena,
        n_removed)``. Lists stay prefix-packed, so every scan invariant
        (counts masking, the occupied-prefix bound) holds unchanged."""
        if lists.size == 0:
            return self, 0
        counts_h = self.counts.cpu().numpy().astype(np.int64)
        move_l, src_s, dst_s, new_counts = plan_removals(
            counts_h, lists.astype(np.int64), slots.astype(np.int64)
        )
        n_removed = int((counts_h - new_counts).sum())
        if n_removed == 0:
            return self, 0
        new_ids = apply_removal_to_ids(
            self.ids, move_l, src_s, dst_s, new_counts, counts_h
        )
        if move_l.size:
            dev = self.device
            _remove_device(
                [None if t is None else t.flatten(0, 1) for t in (
                    self.arena, self.arena_sq, self.arena_scale,
                    self.arena_lo)],
                torch.from_numpy(move_l * self.capacity + src_s).to(dev),
                torch.from_numpy(move_l * self.capacity + dst_s).to(dev),
            )
        return dataclasses.replace(
            self, ids=new_ids,
            counts=torch.from_numpy(new_counts.astype(np.int32)).to(
                self.device),
            counts_max=int(new_counts.max()) if new_counts.size else 0,
        ), n_removed

    def grow(self, new_capacity: int) -> "PackedListArena":
        """Reallocate with a larger per-list capacity (new tensors; the old
        handle stays valid for readers that hold it)."""
        if new_capacity <= self.capacity:
            raise ValueError(
                f"grow needs a larger capacity: {new_capacity} <= "
                f"{self.capacity}"
            )
        def _pad_slots(t):
            # the new tensor, then the old rows copied in: at most the old
            # and the new live at once (a concatenation also holds the pad)
            if t is None:
                return None
            out = t.new_zeros((t.shape[0], new_capacity) + tuple(t.shape[2:]))
            out[:, :self.capacity] = t
            return out

        ids = np.full((self.nlist, new_capacity), INVALID_ID, np.uint64)
        ids[:, : self.capacity] = self.ids
        return dataclasses.replace(
            self, capacity=new_capacity, arena=_pad_slots(self.arena),
            arena_sq=_pad_slots(self.arena_sq), ids=ids,
            arena_scale=_pad_slots(self.arena_scale),
            arena_lo=_pad_slots(self.arena_lo),
        )

    # ------------------------------------------------------------------ #
    # id mapping
    # ------------------------------------------------------------------ #

    def live_rows(self, l0: int, l1: int) -> tuple[torch.Tensor, np.ndarray]:
        """The live rows of lists ``[l0, l1)`` in (list, slot) order, on
        the arena's device, as the fp32 values the arena stores (``anchor +
        scale · code`` in :meth:`to_host`'s order of operations, or the
        bf16 / fp32 row) plus the lo plane where there is one; and their
        user ids."""
        counts = self.counts[l0:l1].cpu().numpy().astype(np.int64)
        live = np.arange(self.capacity)[None, :] < counts[:, None]
        live_d = torch.from_numpy(live).to(self.device)
        rows = self.arena[l0:l1][live_d].float()
        if self.arena_scale is not None:
            rows *= self.arena_scale[l0:l1][live_d][:, None]
        if self.anchors is not None:
            row_list = torch.from_numpy(
                np.repeat(np.arange(l0, l1), counts)).to(self.device)
            rows += self.anchors[row_list]
        if self.arena_lo is not None:
            rows += self.arena_lo[l0:l1][live_d].float()
        return rows, self.ids[l0:l1][live]

    def positions_to_ids(self, pos: np.ndarray) -> np.ndarray:
        """Map global positions (int32, -1 = empty) to user uint64 ids
        (UINT64_MAX for empties): ``models/search.positions_to_ids``."""
        from cuda_acceleratedvectordatabaseengine_tpu_torch.models.search \
            import positions_to_ids

        return positions_to_ids(pos, self.ids)

    # ------------------------------------------------------------------ #
    # (de)serialization
    # ------------------------------------------------------------------ #

    def to_host(self) -> dict:
        """Dequantized fp32 view of the stored vectors (snapshots persist
        values, not codes). Padded slots stay exactly zero. Dequantization
        happens on the host, like the JAX package's."""
        arena_np = self.arena.float().cpu().numpy()
        counts = self.counts.cpu().numpy()
        if self.dtype == torch.int8 and self.arena_scale is not None:
            arena_np *= self.arena_scale.cpu().numpy()[:, :, None]
            if self.anchors is not None:
                anchors = self.anchors.cpu().numpy()
                for l in range(arena_np.shape[0]):   # in place, no 3-D temp
                    arena_np[l, : int(counts[l])] += anchors[l]
        return {"arena": arena_np, "counts": counts, "ids": self.ids}

    @classmethod
    def from_host(
        cls, arena: np.ndarray, counts: np.ndarray, ids: np.ndarray, dtype,
        anchors: np.ndarray | None = None,
        device: torch.device | str | None = "cuda",
    ) -> "PackedListArena":
        """Rebuild from a ``to_host`` view on ``device`` (the card unless
        another is named); int8 requantizes on the host with the same
        per-row math as the append path."""
        dtype = torch_dtype(dtype)
        device = resolve_device(device)
        nlist, capacity, dim = arena.shape
        arena_f = arena.astype(np.float32)
        arena_scale = None
        anchors_d = None
        if dtype == torch.int8:
            live = (
                np.arange(capacity)[None, :]
                < counts.astype(np.int64)[:, None]
            )
            if anchors is not None:
                anchors_f = anchors.astype(np.float32)
                res = np.where(
                    live[:, :, None], arena_f - anchors_f[:, None, :], 0.0
                )
                anchors_d = torch.from_numpy(anchors_f).to(device)
            else:
                res = arena_f
            scale_h = np.maximum(np.abs(res).max(axis=-1), 1e-12) / 127.0
            codes = np.clip(
                np.round(res / scale_h[:, :, None]), -127, 127
            ).astype(np.int8)
            deq = codes.astype(np.float32) * scale_h[:, :, None]
            if anchors is not None:
                deq = np.where(
                    live[:, :, None], deq + anchors_f[:, None, :], 0.0
                )
            sq_h = np.einsum("lcd,lcd->lc", deq, deq, dtype=np.float32)
            dev = torch.from_numpy(codes).to(device)
            arena_scale = torch.from_numpy(
                scale_h.astype(np.float32)
            ).to(device)
        else:
            dev = torch.from_numpy(arena_f).to(device=device, dtype=dtype)
            stored = dev.float()
            sq_h = (stored * stored).sum(-1).cpu().numpy()
        return cls(
            nlist=nlist,
            dim=dim,
            dtype=dtype,
            capacity=capacity,
            arena=dev,
            arena_sq=torch.from_numpy(
                np.ascontiguousarray(sq_h, np.float32)
            ).to(device),
            counts=torch.from_numpy(counts.astype(np.int32)).to(device),
            ids=ids.astype(np.uint64),
            arena_scale=arena_scale,
            anchors=anchors_d,
            counts_max=int(counts.max()) if counts.size else 0,
        )
