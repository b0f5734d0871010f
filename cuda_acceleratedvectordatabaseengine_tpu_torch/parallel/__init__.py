"""Sharded serving and training over a device mesh (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/parallel/``).

One process drives every shard (``mesh.py``): a shard is a device entry of
the mesh and holds its stripe of each arena as its own tensors; each
shard's kernel is launched on its device and the candidates merge on the
first. On several cards the shards run at the same time (CUDA launches are
asynchronous); several shards on one card run one after another.
"""

from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    Mesh,
    make_mesh,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel.sharded import (
    ShardedIVFFlatIndex,
    ShardedIVFPQIndex,
    sharded_kmeans_fit,
    sharded_kmeans_lloyd_step,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel.sharded_streaming import (  # noqa: E501
    ShardedStreamingIVFFlatIndex,
)

__all__ = [
    "make_mesh",
    "SHARD_AXIS",
    "ShardedIVFFlatIndex",
    "ShardedIVFPQIndex",
    "ShardedStreamingIVFFlatIndex",
    "sharded_kmeans_fit",
    "sharded_kmeans_lloyd_step",
]
