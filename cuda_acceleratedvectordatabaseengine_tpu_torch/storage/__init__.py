"""Storage layer of the port: the JAX package's snapshot format, written
and read without ``pyarrow``.

  - ``manifest``    → ``IndexManifest`` JSON (copied from the JAX package)
  - ``arrow_ipc``   → the Arrow IPC file codec in numpy
  - ``arrow_store`` → ``ArrowStorage`` / ``VectorFileWriter``: vector,
                      centroid, codebook and code tables
  - ``snapshot``    → whole-index save / load of IVF-Flat and IVF-PQ, and
                      the IVF-PQ capacity tier's load
  - ``epoch``       → ``EpochManager``: versioned snapshot directories
                      (copied from the JAX package)
  - ``shard_store`` → ``ShardManager`` (per-list ``.ids`` / ``.vec`` /
                      ``.code`` files) and ``AlignedReader`` (copied from
                      the JAX package)
"""

from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.arrow_store import (
    ArrowStorage,
    VectorFileWriter,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.manifest import (
    IndexManifest,
    ShardEntry,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.shard_store import (
    AlignedReader,
    ShardManager,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.snapshot import (
    load_ivf_flat,
    load_ivf_flat_host,
    load_ivf_pq,
    load_ivf_pq_capacity,
    save_ivf_flat,
    save_ivf_pq,
)

__all__ = [
    "ArrowStorage", "VectorFileWriter", "IndexManifest", "ShardEntry",
    "save_ivf_flat", "load_ivf_flat", "load_ivf_flat_host", "save_ivf_pq",
    "load_ivf_pq", "load_ivf_pq_capacity", "ShardManager", "AlignedReader",
]
