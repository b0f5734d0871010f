"""The device an entry point of the package runs on.

Every public constructor and factory takes ``device`` and runs on the card
unless the caller names another device: ``None`` (or no argument) means
``"cuda"``. On a machine without CUDA such a call raises instead of running
on the host, so a run that meant the card never lands on the CPU unseen.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``torch.device(device)``, ``"cuda"`` for ``None``; raises
    ``RuntimeError`` for a CUDA device when CUDA is not available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} (the default unless a device is named) needs "
            f"CUDA, which is not available here; pass device='cpu' to run "
            f"on the host"
        )
    return dev
