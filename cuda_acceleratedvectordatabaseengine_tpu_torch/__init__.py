"""Vector database engine on PyTorch and CUDA (NVIDIA Hopper).

The port of ``cuda_acceleratedvectordatabaseengine_tpu`` (JAX on a TPU),
which stays beside it as the reference. This package imports ``torch`` and
numpy, never JAX. It runs two index families: IVF-Flat (k-means training,
a chunked int8 / bf16 / fp32 build into a packed list arena, batched
search, an optional exact rerank over a stored residual plane) and IVF-PQ
(PQ / OPQ codebooks, residual codes, ADC search with an optional exact
rerank), both with removal by id and snapshots in the JAX package's Arrow
format (``storage/``, no ``pyarrow`` needed); a chunked offline builder
(``build_index_chunked``); the exact ``FlatIndex``; and a streaming tier
that serves an IVF-Flat corpus from host RAM through a device cache of hot
lists (``StreamingIVFFlatIndex``); the IVF-PQ capacity tier, whose exact
rerank reads an int8 row store in host RAM (``io_host/host_rerank.py``);
and the serving engine (``server/``: ``VdbEngine`` with its request
coalescer, epochs and admission, and the gRPC front end). Their
probed-list scans are hand-written CUDA kernels for ``sm_90a``
(``csrc/grouped_scan.cu``, ``csrc/grouped_pq_scan.cu``,
``csrc/full_row_scan.cu``, built with ``nvcc`` at first use). On CPU tensors
every op takes its plain PyTorch version; on CUDA tensors a kernel path
launches its kernel or raises. Every entry point runs on the card unless
it is given another ``device`` (``device="cpu"`` runs on the host).

    import numpy as np, cuda_acceleratedvectordatabaseengine_tpu_torch as vdb
    x = np.random.default_rng(0).standard_normal((100_000, 128), np.float32)
    idx = vdb.IVFFlatIndex(vdb.IVFFlatConfig(dimension=128, nlist=256))
    idx.train(x); idx.add(x)
    d, ids = idx.search(x[:8], vdb.SearchParams(nprobe=32, k=10))

    pq = vdb.IVFPQIndex(vdb.IVFPQConfig(dimension=128, nlist=256, m=16))
    pq.train(x); pq.add(x)
    d, ids = pq.search(x[:8], vdb.SearchParams(nprobe=32, k=10,
                                               use_exact_rerank=True))

    tier = vdb.StreamingIVFFlatIndex(idx, cache_slots=64)
    d, ids = tier.search(x[:8], vdb.SearchParams(nprobe=32, k=10))

    idx.remove_ids(np.arange(10))
    idx.save("/path/to/snapshot")
    idx2 = vdb.IVFFlatIndex.load("/path/to/snapshot")
"""

from cuda_acceleratedvectordatabaseengine_tpu_torch.builder import (
    build_index_chunked,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
    HbmListCache,
    HostListStore,
    StreamingIVFFlatIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.flat import (
    FlatIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq import (
    IVFPQConfig,
    IVFPQIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
    ArrowStorage,
    IndexManifest,
    load_ivf_flat,
    load_ivf_flat_host,
    load_ivf_pq,
    save_ivf_flat,
    save_ivf_pq,
)

__version__ = "0.1.0"

__all__ = [
    "Metric",
    "FlatIndex",
    "IVFFlatIndex",
    "IVFFlatConfig",
    "IVFPQIndex",
    "IVFPQConfig",
    "SearchParams",
    "HbmListCache",
    "HostListStore",
    "StreamingIVFFlatIndex",
    "build_index_chunked",
    "ArrowStorage",
    "IndexManifest",
    "save_ivf_flat",
    "load_ivf_flat",
    "load_ivf_flat_host",
    "save_ivf_pq",
    "load_ivf_pq",
    "__version__",
]
