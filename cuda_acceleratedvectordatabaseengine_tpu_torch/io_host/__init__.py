"""The host memory tier: inverted lists in host RAM, a device cache of hot
lists, and streaming IVF-Flat search over both."""

from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.cache import (
    HbmListCache,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.prefetcher import (
    ListPrefetcher,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.streaming import (
    HostListStore,
    StreamingIVFFlatIndex,
)

__all__ = [
    "HbmListCache",
    "HostListStore",
    "ListPrefetcher",
    "StreamingIVFFlatIndex",
]
