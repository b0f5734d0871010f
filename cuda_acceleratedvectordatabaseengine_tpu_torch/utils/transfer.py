"""A search's copies between the host and the card, fenced by events of
that search's own work.

A pageable ``Tensor.to(device)`` is followed by a stream synchronisation,
and a pageable ``.cpu()`` of a result queues behind, and waits for,
everything the stream took on since. So the thread that enqueues batch
N+1 would wait out batch N's kernels, and batch N's answer would wait for
batch N+1's. Here both directions go through pinned memory from PyTorch's
caching host allocator with ``non_blocking=True`` copies: the allocator
records each copy's event and hands its block to no other tensor before
that event has passed. On a CPU index both are plain copies.
"""

from __future__ import annotations

import numpy as np
import torch


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """The host rows ``x`` as an fp32 tensor on ``device``. To a CUDA
    device the copy is enqueued on the current stream and returns at once:
    the rows are first copied into a pinned block, so the caller may reuse
    ``x`` as soon as this returns. numpy fills the block, holding the
    interpreter lock: ``Tensor.pin_memory()`` releases it for long enough
    that a busy thread beside takes it for a whole switch interval
    (0.14 ms alone, 3.8 ms beside one on an H100's host, against 0.07
    and 0.21 ms this way)."""
    if device.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)
    t = torch.empty(np.shape(x), dtype=torch.float32, pin_memory=True)
    t.numpy()[...] = x
    return t.to(device, non_blocking=True)


class HostCopy:
    """Copies of device tensors into pinned host memory, enqueued on the
    current stream when this is made, and an event recorded after them.
    Make it right after the work that writes the tensors: the copies then
    wait for that work and nothing enqueued later. On the CPU it holds the
    tensors as they are."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if not tensors[0].is_cuda:
            self._host = tensors
            return
        self._host = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True)
            for t in tensors)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(tensors[0].device))

    def numpy(self) -> list[np.ndarray]:
        """Wait for the copies, then each as a numpy array of its own: no
        view of a pinned block, which goes back to the allocator with this
        object."""
        if self._event is not None:
            self._event.synchronize()
        return [t.numpy().copy() for t in self._host]
