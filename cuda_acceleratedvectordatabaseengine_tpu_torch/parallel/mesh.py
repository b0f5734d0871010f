"""A one-process device mesh and the collectives of the sharded views
(PyTorch port of ``cuda_acceleratedvectordatabaseengine_tpu/parallel/
mesh.py``).

The JAX package runs its sharded search as one ``shard_map`` program that a
single Python process drives on every device. The counterpart here is one
process holding one tensor per shard on that shard's device: it launches
each shard's kernel in turn (CUDA launches are asynchronous, so shards on
different cards run at the same time; shards on one card run one after
another) and merges their ``[B, k]`` candidates on the first device, the
*leader*. The JAX collectives become the plain functions below:

- ``all_gather`` → :func:`all_gather` (each shard's tensor moved to the
  leader, then one ``torch.cat``);
- ``psum`` → :func:`psum` (the sum on the leader);
- a replicated array → :func:`replicate` (one copy per shard's device).

A mesh may name one device more than once (``["cpu"] * 8`` in the tests,
``["cuda:0"] * 4`` on one card): each entry is still one shard with its own
tensors, as XLA's ``--xla_force_host_platform_device_count`` gives the JAX
package its virtual CPU devices.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (
    resolve_device,
)

SHARD_AXIS = "shard"


class Mesh:
    """A 1-D mesh: ``devices`` is a numpy object array of ``torch.device``
    (so ``mesh.devices.size`` reads as in the JAX package); shard ``s``
    lives on ``devices[s]`` and shard 0's device is the leader."""

    def __init__(self, devices, axis: str = SHARD_AXIS):
        if not len(devices):
            raise ValueError("a mesh needs at least one device")
        arr = np.empty(len(devices), dtype=object)
        arr[:] = [torch.device(d) for d in devices]
        self.devices = arr
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def leader(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_names[0]}={self.size}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS, *,
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` CUDA devices (default: all),
    or over an explicit ``devices`` list, which may repeat a device.
    Raises when more CUDA devices are asked for than are visible, as the
    JAX package raises, and when a CUDA device is asked for without
    CUDA."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh over CUDA devices needs CUDA, which is not "
                "available here; pass devices=[...] (e.g. ['cpu'] * n)"
            )
        have = torch.cuda.device_count()
        n = n_devices or have
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [resolve_device(d) for d in devices]
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(
                f"n_devices={n_devices} but {len(devices)} devices given"
            )
    return Mesh(devices, axis)


def replicate(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """One copy of ``t`` per shard, on that shard's device (the tensor
    itself where it already lives there)."""
    return [t.to(dev) for dev in mesh.devices]


def stripe_slots(mesh: Mesh, t: torch.Tensor, axis: int) -> list[torch.Tensor]:
    """Split the slot axis ``axis`` of ``t`` round-robin over the mesh:
    shard ``s`` gets the contiguous tensor of logical slots ``s, s + N,
    s + 2N, …`` (local slot ``j`` = logical ``j·N + s``) on its device.
    A one-shard mesh on ``t``'s device returns ``t`` itself: never a copy,
    which would double a card-filling arena."""
    n = mesh.size
    if t.shape[axis] % n:
        raise ValueError(
            f"slot axis {t.shape[axis]} is not a multiple of {n} shards")
    if n == 1:
        return [t.to(mesh.leader)]
    index = [slice(None)] * t.dim()
    out = []
    for s, dev in enumerate(mesh.devices):
        index[axis] = slice(s, None, n)
        out.append(t[tuple(index)].clone(
            memory_format=torch.contiguous_format).to(dev))
    return out


def all_gather(mesh: Mesh, parts, dim: int = -1) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` on the leader."""
    return torch.cat([p.to(mesh.leader) for p in parts], dim)


def psum(mesh: Mesh, parts) -> torch.Tensor:
    """The sum of the shards' tensors, on the leader."""
    total = parts[0].to(mesh.leader)
    for p in parts[1:]:
        total = total + p.to(mesh.leader)
    return total
