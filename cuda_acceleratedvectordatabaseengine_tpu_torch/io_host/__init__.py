"""The host memory tier: inverted lists in host RAM, a device cache of hot
lists, streaming IVF-Flat search over both, the staging scheduler, the
access-pattern readahead of the file reader, and the capacity tier's exact
rerank from a host row store."""

from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.cache import (
    HbmListCache,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.host_rerank import (
    HostReranker,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.prefetcher import (
    AccessPattern,
    AdaptivePrefetcher,
    ListPrefetcher,
    PrefetchScheduler,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.streaming import (
    HostListStore,
    StreamingIVFFlatIndex,
)

__all__ = [
    "AccessPattern",
    "AdaptivePrefetcher",
    "HbmListCache",
    "HostListStore",
    "HostReranker",
    "ListPrefetcher",
    "PrefetchScheduler",
    "StreamingIVFFlatIndex",
]
