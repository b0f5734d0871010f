"""The streaming tier over a device mesh: a slot-striped device list cache
and the merge of the shards' scans (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/parallel/sharded_streaming.py``).

The single-device tier (``io_host/streaming.py``) extends to a mesh the way
the resident index does (``parallel/sharded.py``):

- the **cache's slot-capacity axis is striped round-robin** over the mesh
  (shard ``s`` holds logical slots ``j·N + s`` of every cached list), so an
  N-shard mesh holds an N× larger cached working set;
- a miss upload gathers each shard's stripe of the staged host rows (the
  physical order of ``_striping_perm``) into that shard's own pinned
  buffer and copies it to the shard's device without waiting, so each
  shard receives 1/N of every uploaded list;
- each wave's scan runs per shard with the striping-aware kernels
  (``slot_stride=N``, ``slot_offset=s``) and the shards' ``[B, k]``
  candidates merge on the leader, as in the resident sharded search.

Host bookkeeping (LRU / LFU, wave planning, id lookup) is inherited
unchanged: slot residency is a logical property, independent of how a
slot's bytes are laid out over the shards.
"""

from __future__ import annotations

import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.cache import (
    HbmListCache,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.streaming import (
    HostListStore,
    StreamingIVFFlatIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.flat_scan import (
    scan_flat,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel.mesh import (
    Mesh,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel.sharded import (
    _merge,
)


class ShardedHbmListCache(HbmListCache):
    """:class:`HbmListCache` whose planes are slot-striped over a mesh:
    each plane with a capacity axis is a list of one stripe per shard,
    every other plane a list of one copy per shard. The capacity is padded
    up so that every stripe is 8-aligned; the padding slots are past every
    count and are never scanned."""

    def __init__(self, mesh: Mesh, n_slots, capacity, dim,
                 dtype=torch.bfloat16, policy: str = "lru"):
        self.mesh = mesh
        self.n_shards = mesh.size
        capacity = -(-capacity // (8 * mesh.size)) * (8 * mesh.size)
        super().__init__(n_slots, capacity, dim, dtype, policy,
                         device=mesh.leader)

    def _device_zeros(self, shape, dtype, cap_axis=None):
        if cap_axis is not None:
            shape = list(shape)
            shape[cap_axis] //= self.n_shards
        return [torch.zeros(tuple(shape), dtype=dtype, device=d)
                for d in self.mesh.devices]

    def _stripe_buffers(self, buf: dict) -> list[dict]:
        """One host buffer per shard for its stripe of the staged planes
        (pinned where the shard is on CUDA), kept with the staging buffer
        ``buf`` so that both are reused together, after the copies that
        read them (``buf["events"]``)."""
        if "stripes" not in buf:
            n_lists = buf["rows"].shape[0]
            cap_l = self.capacity // self.n_shards
            shapes = {"rows": (n_lists, cap_l, self.dim)}
            if self.quantized:
                shapes.update(sq=(n_lists, cap_l), scale=(n_lists, cap_l))
            buf["stripes"] = [
                {name: torch.empty(
                    shape, pin_memory=dev.type == "cuda",
                    dtype=self.dtype if name == "rows" else torch.float32)
                 for name, shape in shapes.items()}
                for dev in self.mesh.devices]
        return buf["stripes"]

    def _write_slots(self, slots, planes: dict, buf: dict) -> list:
        """Each shard receives its stripe of every staged plane: logical
        slots ``s, s + N, …`` (the contiguous chunk ``s`` of the slot axis
        permuted by ``_striping_perm``) are gathered on the host into the
        shard's own buffer and copied to its device without waiting; the
        replicated planes (counts, anchors) go to every shard."""
        n = self.n_shards
        m = len(slots)
        events = []
        for s, (dev, host) in enumerate(zip(self.mesh.devices,
                                            self._stripe_buffers(buf))):
            slot_d = torch.tensor(slots, dtype=torch.long).to(dev)
            stripe = {}
            for name, part in host.items():
                part[:m].copy_(planes[name][:, s::n])
                stripe[name] = part[:m].to(dev, non_blocking=True)
            self.cache_arena[s].index_copy_(0, slot_d, stripe["rows"])
            self.cache_counts[s].index_copy_(
                0, slot_d, planes["counts"].to(dev, non_blocking=True))
            if self.quantized:
                self.cache_sq[s].index_copy_(0, slot_d, stripe["sq"])
                self.cache_scale[s].index_copy_(0, slot_d, stripe["scale"])
                self.cache_anchors[s].index_copy_(
                    0, slot_d, planes["anchors"].to(dev, non_blocking=True))
            else:
                rf = stripe["rows"].float()
                self.cache_sq[s].index_copy_(0, slot_d, (rf * rf).sum(-1))
            events += self._copied(dev)
        return events

    def memory_bytes(self) -> int:
        """Device bytes of the cache planes over every shard."""
        planes = [self.cache_arena, self.cache_sq, self.cache_counts,
                  self.cache_scale, self.cache_anchors]
        return sum(t.numel() * t.element_size()
                   for p in planes if p is not None for t in p)


class ShardedStreamingIVFFlatIndex(StreamingIVFFlatIndex):
    """The streaming tier over a device mesh.

    Same serving surface as the single-device tier; ``cache_slots`` /
    ``max_device_bytes`` describe the AGGREGATE mesh budget (each shard
    holds 1/N of every slot). Its answers are the single-device tier's."""

    def __init__(
        self,
        mesh: Mesh,
        store: HostListStore,
        centroids,
        config,
        cache_slots: int | None = None,
        max_device_bytes: int | None = None,
        policy: str = "lru",
        scan_impl: str = "auto",
        capacity: int | None = None,
    ):
        self.mesh = mesh
        self.n_shards = mesh.size
        self._init_from_store(
            store, centroids, config, cache_slots, max_device_bytes, policy,
            scan_impl, capacity, mesh.leader,
        )

    @classmethod
    def from_base(cls, base, mesh: Mesh,
                  **kw) -> "ShardedStreamingIVFFlatIndex":
        """Snapshot a resident single-device index into a mesh-served
        streaming tier (the host store keeps the stored representation
        verbatim: int8 codes stay int8)."""
        store = HostListStore.from_arena(base.arena)
        return cls(mesh, store, base.centroids, base.config,
                   capacity=base.arena.capacity, **kw)

    def _make_cache(self, cache_slots, cap, dim, dtype, policy):
        return ShardedHbmListCache(self.mesh, cache_slots, cap, dim, dtype,
                                   policy)

    def _run_cache_scan(self, q, slot_probe, k: int):
        """One wave: each shard scans its stripe of the cache (logical
        positions ``slot · capacity + logical offset``), then the merge."""
        c = self.cache
        n = self.n_shards
        scan_cap = -(-self._scan_capacity // n)
        parts = []
        for s, dev in enumerate(self.mesh.devices):
            d, pos = scan_flat(
                self.scan_impl, q.to(dev), c.cache_arena[s], c.cache_sq[s],
                c.cache_counts[s], slot_probe.to(dev), k, self.metric,
                arena_scale=c.cache_scale[s] if c.quantized else None,
                arena_anchors=c.cache_anchors[s] if c.quantized else None,
                scan_capacity=scan_cap, slot_stride=n, slot_offset=s,
                global_capacity=c.capacity,
            )
            parts.append((d[:, :k], pos[:, :k]))
        return _merge(self.mesh, parts, k)
