"""Device inverted-list cache with LRU/LFU eviction and hit statistics
(PyTorch port of ``cuda_acceleratedvectordatabaseengine_tpu/io_host/
cache.py``).

A fixed-slot cache on one device:

    cache_arena   [slots + 1, cap, dim]   int8 / bf16 / fp32
    cache_sq      [slots + 1, cap]        fp32 norms of the stored point
    cache_counts  [slots + 1]             int32 live rows of the cached list
    cache_scale   [slots + 1, cap]        fp32 per-row scales (int8 only)
    cache_anchors [slots + 1, dim]        fp32 residual anchors (int8 only)

Row ``slots`` is a sentinel that is never assigned and holds count 0.

Misses upload in batches of at most ``UPLOAD_BATCH_BYTES`` of stored rows:
the host pads each list into a staging buffer (pinned on CUDA), one
non-blocking copy moves the batch to the device, and ``index_copy_``
writes the missed slots in place. Ordering rules that keep this correct:

- every copy and slot write is issued on the current stream, after any
  scan already issued there, so an in-place upload never overwrites a slot
  that an earlier wave's scan is still reading;
- each staging buffer carries an event recorded after its copy, and the
  host waits on it before refilling the buffer, so a copy still in flight
  never reads half-new data.

Norms of a non-int8 cache are computed on the device from the stored
(cast) rows, so scan distances are distances to the stored point; an int8
cache takes the store's norms, scales and anchors as they are.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    torch_dtype,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (
    resolve_device,
)


class HbmListCache:
    """Device-resident cache of whole inverted lists, keyed by list id."""

    # Stored-row bytes of one upload batch (bounds the staging buffers).
    UPLOAD_BATCH_BYTES = 256 << 20

    def __init__(
        self,
        n_slots: int,
        capacity: int,
        dim: int,
        dtype=torch.bfloat16,
        policy: str = "lru",
        device: torch.device | str | None = "cuda",
    ):
        if policy not in ("lru", "lfu"):
            raise ValueError(f"unknown eviction policy {policy!r}")
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.capacity = capacity
        self.dim = dim
        self.dtype = torch_dtype(dtype)
        self.policy = policy
        f32 = torch.float32
        rows = n_slots + 1
        zeros = self._device_zeros
        self.cache_arena = zeros((rows, capacity, dim), self.dtype, 1)
        self.cache_sq = zeros((rows, capacity), f32, 1)
        self.cache_counts = zeros((rows,), torch.int32)
        self.quantized = self.dtype == torch.int8
        self.cache_scale = (
            zeros((rows, capacity), f32, 1) if self.quantized else None
        )
        self.cache_anchors = (
            zeros((rows, dim), f32) if self.quantized else None
        )
        self._lock = threading.Lock()
        self._upload_lock = threading.Lock()   # the staging buffers
        self._list_to_slot: dict[int, int] = {}
        self._slot_to_list: dict[int, int] = {}
        self._free: list[int] = list(range(n_slots))
        self._last_access: dict[int, float] = {}
        self._freq: dict[int, int] = {}
        self.hits = 0
        self.misses = 0
        self.h2d_bytes = 0          # bytes copied host → device by uploads
        self._staging: list[dict] = []   # two buffers, used in turn
        self._turn = 0

    # ------------------------------------------------------------------ #

    def _device_zeros(self, shape, dtype, cap_axis=None) -> torch.Tensor:
        """A zero device plane; ``cap_axis`` names its slot-capacity axis
        (a sharded cache stripes that axis over its mesh)."""
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def get_hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def resident_lists(self) -> list[int]:
        with self._lock:
            return sorted(self._list_to_slot)

    def _pick_victim_locked(
        self, protected: set[int], soft: set[int] | None = None
    ) -> int:
        if self._free:
            return self._free.pop()
        score = self._last_access if self.policy == "lru" else self._freq
        candidates = [
            l for l in self._list_to_slot if l not in protected
        ]
        if not candidates:
            raise ValueError(
                f"cache thrash: all {self.n_slots} slots are needed by the "
                "current batch; raise cache slots or split the batch"
            )
        if soft:
            # The caller knows which resident lists the NEXT wave of this
            # batch needs: evicting one now forces a re-upload right away.
            # Only a preference: if every candidate is soft-protected,
            # evict among them.
            unsoft = [l for l in candidates if l not in soft]
            if unsoft:
                candidates = unsoft
        victim_list = min(candidates, key=lambda l: score.get(l, 0))
        slot = self._list_to_slot.pop(victim_list)
        del self._slot_to_list[slot]
        self._last_access.pop(victim_list, None)
        self._freq.pop(victim_list, None)
        return slot

    def evict_list(self, list_id: int) -> bool:
        """Free the slot of ``list_id``; False when it is not resident."""
        with self._lock:
            slot = self._list_to_slot.pop(list_id, None)
            if slot is None:
                return False
            del self._slot_to_list[slot]
            self._last_access.pop(list_id, None)
            self._freq.pop(list_id, None)
            self._free.append(slot)
            return True

    # ------------------------------------------------------------------ #

    def ensure_resident(
        self, list_ids: np.ndarray, host_fetch,
        soft_protect: set[int] | None = None,
    ) -> dict[int, int]:
        """Make every list in ``list_ids`` resident; returns {list_id:
        slot}. ``host_fetch(list_id)`` gives ``(vectors [c, dim], sq [c],
        count)`` for a float store and ``(codes, sq, count, scale, anchor)``
        for an int8 one. ``soft_protect``: lists a later wave of the same
        batch needs, preferred survivors of eviction (never blocking a
        required upload). The uploads are issued on the current stream and
        are not waited for."""
        now = time.monotonic()
        wanted = [int(l) for l in np.unique(list_ids)]
        if len(wanted) > self.n_slots:
            raise ValueError(
                f"batch probes {len(wanted)} unique lists but cache has "
                f"{self.n_slots} slots; split into waves"
            )
        protected = set(wanted)
        with self._lock:
            missing = []
            for l in wanted:
                if l in self._list_to_slot:
                    self.hits += 1
                else:
                    self.misses += 1
                    missing.append(l)
                self._last_access[l] = now
                self._freq[l] = self._freq.get(l, 0) + 1
            slots_for_missing = {}
            for l in missing:
                slot = self._pick_victim_locked(protected, soft_protect)
                self._list_to_slot[l] = slot
                self._slot_to_list[slot] = l
                slots_for_missing[l] = slot
            mapping = {l: self._list_to_slot[l] for l in wanted}

        miss_l = list(slots_for_missing)
        miss_s = list(slots_for_missing.values())
        step = self._batch_lists()
        with self._upload_lock:
            for b0 in range(0, len(miss_l), step):
                self._upload(miss_l[b0:b0 + step], miss_s[b0:b0 + step],
                             host_fetch)
        return mapping

    def _batch_lists(self) -> int:
        per_list = self.capacity * self.dim * self.dtype.itemsize
        return max(1, min(self.n_slots,
                          self.UPLOAD_BATCH_BYTES // max(per_list, 1)))

    def _buffer(self) -> dict:
        """The next staging buffer (two, used in turn), once the copy that
        last read it has finished."""
        if not self._staging:
            pin = self.device.type == "cuda"
            n, cap, dim = self._batch_lists(), self.capacity, self.dim
            for _ in range(2):
                buf = {
                    "rows": torch.zeros((n, cap, dim), dtype=self.dtype,
                                        pin_memory=pin),
                    "counts": torch.zeros((n,), dtype=torch.int32,
                                          pin_memory=pin),
                    "events": [],
                }
                if self.quantized:
                    for name, shape in (("sq", (n, cap)),
                                        ("scale", (n, cap)),
                                        ("anchors", (n, dim))):
                        buf[name] = torch.zeros(shape, dtype=torch.float32,
                                                pin_memory=pin)
                self._staging.append(buf)
        buf = self._staging[self._turn]
        self._turn = 1 - self._turn
        for event in buf["events"]:
            event.synchronize()
        return buf

    def _upload(self, lists, slots, host_fetch) -> None:
        """Stage one batch of missed lists (zero-padded to the capacity)
        and write them into their slots in place."""
        n = len(lists)
        buf = self._buffer()
        rows, counts = buf["rows"][:n], buf["counts"][:n]
        for i, l in enumerate(lists):
            fetched = host_fetch(l)
            v, s, c = fetched[:3]
            c = int(c)
            rows[i, :c].copy_(torch.from_numpy(np.ascontiguousarray(v[:c])))
            rows[i, c:].zero_()
            counts[i] = c
            if self.quantized:
                sc, an = fetched[3], fetched[4]
                buf["sq"][i, :c] = torch.from_numpy(
                    np.asarray(s[:c], np.float32))
                buf["sq"][i, c:] = 0.0
                buf["scale"][i, :c] = torch.from_numpy(
                    np.asarray(sc[:c], np.float32))
                buf["scale"][i, c:] = 0.0
                buf["anchors"][i] = torch.from_numpy(
                    np.asarray(an, np.float32))
        planes = {"rows": rows, "counts": counts}
        if self.quantized:
            planes.update((name, buf[name][:n])
                          for name in ("sq", "scale", "anchors"))
        buf["events"] = self._write_slots(slots, planes, buf)
        self.h2d_bytes += sum(t.numel() * t.element_size()
                              for t in planes.values())

    @staticmethod
    def _copied(dev) -> list:
        """An event recorded on ``dev``'s current stream after the copies
        issued there (none off CUDA, where copies are synchronous)."""
        if dev.type != "cuda":
            return []
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        return [event]

    def _write_slots(self, slots, planes: dict, buf: dict) -> list:
        """Copy one staged batch (host ``planes`` of the staging buffer
        ``buf``: ``rows``, ``counts`` and, int8, ``sq`` / ``scale`` /
        ``anchors``) into the cache ``slots`` in place, issued on the
        current stream; returns the events the buffer's next user waits
        on."""
        dev = self.device
        slot_d = torch.tensor(slots, dtype=torch.long).to(dev)
        rows_d = planes["rows"].to(dev, non_blocking=True)
        self.cache_arena.index_copy_(0, slot_d, rows_d)
        self.cache_counts.index_copy_(
            0, slot_d, planes["counts"].to(dev, non_blocking=True))
        if self.quantized:
            for name, dst in (("sq", self.cache_sq),
                              ("scale", self.cache_scale),
                              ("anchors", self.cache_anchors)):
                dst.index_copy_(0, slot_d,
                                planes[name].to(dev, non_blocking=True))
        else:
            # norms of the STORED (cast) representation
            rf = rows_d.float()
            self.cache_sq.index_copy_(0, slot_d, (rf * rf).sum(-1))
        return self._copied(dev)

    def memory_bytes(self) -> int:
        """Device bytes of the cache tensors."""
        n = (
            self.cache_arena.numel() * self.cache_arena.element_size()
            + self.cache_sq.numel() * 4 + self.cache_counts.numel() * 4
        )
        if self.quantized:
            n += self.cache_scale.numel() * 4 + self.cache_anchors.numel() * 4
        return n
