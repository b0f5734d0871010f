"""PyTorch port, the chunked builder: the cases of the JAX package's
``tests/test_builder.py`` (progress, the capacity law, tombstones, the row
sink, spill of a fat mode) and a build streamed off an Arrow file (CPU)."""

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu import (
    IVFFlatConfig as JConfig,
    IVFFlatIndex as JIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu.builder import (
    build_index_chunked as j_build,
    chunked_capacity as j_capacity,
    train_sample_rows as j_train_rows,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    ArrowStorage,
    IVFFlatConfig,
    IVFFlatIndex,
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
    build_index_chunked,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.builder import (
    chunked_capacity,
    train_sample_rows,
)

torch.set_num_threads(1)

DIM = 16


def _clustered(rng, n, n_clusters=32, dim=DIM, spread=0.15):
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign] + spread * rng.standard_normal(
        (n, dim)).astype(np.float32)).astype(np.float32)


def _chunks_of(x, ids, chunk):
    for off in range(0, len(x), chunk):
        yield ids[off:off + chunk], x[off:off + chunk]


def test_build_index_chunked_progress_capacity_and_sink(rng):
    n, nlist = 2048, 16
    x = _clustered(rng, n, n_clusters=nlist)
    ids = np.arange(n, dtype=np.uint64)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=nlist),
                       device="cpu")
    progress, sunk = [], []
    tombs = np.array([5, 1000, 2047], np.uint64)
    built = build_index_chunked(
        idx, _chunks_of(x, ids, 512), n, train_sample=x[:1024],
        tombstones=tombs, progress=progress.append,
        row_sink=lambda i, v: sunk.append((i.copy(), v.copy())),
    )
    assert built == n - 3 == idx.ntotal
    assert len(progress) == 4 and progress == sorted(progress)
    assert progress[-1] >= (n - 3) / n
    assert idx.arena.capacity == chunked_capacity(n, nlist) == \
        j_capacity(n, nlist)
    assert int(idx.arena.counts.max()) <= idx.arena.capacity
    sunk_ids = np.concatenate([i for i, _ in sunk])
    assert len(sunk_ids) == built and not np.isin(tombs, sunk_ids).any()
    _, got = idx.search(x[8:16], SearchParams(nprobe=nlist, k=3))
    assert (got[:, 0] == np.arange(8, 16)).all()
    _, got = idx.search(x[5:6], SearchParams(nprobe=nlist, k=3))
    assert 5 not in got
    assert idx.remove_ids(tombs) == 0
    assert train_sample_rows(idx.config) == j_train_rows(idx.config) == \
        128 * nlist


def test_build_index_chunked_spills_fat_lists(rng):
    """Half the rows in one mode: the capacity stays at the 1.35×-mean
    clamp and the overflow spills, findable at full probe depth; the
    lists hold what the JAX package's build_index_chunked gives from the same
    centroids."""
    n, nlist = 4096, 16
    centers = rng.standard_normal((nlist, DIM)).astype(np.float32) * 3
    assign = np.where(rng.random(n) < 0.5, 0, rng.integers(0, nlist, n))
    x = (centers[assign]
         + 0.1 * rng.standard_normal((n, DIM))).astype(np.float32)
    ids = np.arange(n, dtype=np.uint64)
    jidx = JIndex(JConfig(dimension=DIM, nlist=nlist, dtype="float32"))
    jidx.train(x[:2048])
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=nlist,
                                     dtype="float32"), device="cpu")
    idx.centroids = torch.from_numpy(np.array(jidx.centroids))
    idx.trained = True
    assert build_index_chunked(idx, _chunks_of(x, ids, 1024), n) == n
    assert j_build(jidx, _chunks_of(x, ids, 1024), n) == n
    cap = chunked_capacity(n, nlist)
    counts = idx.arena.counts.numpy()
    assert idx.arena.capacity == cap and counts.max() <= cap
    assert counts.sum() == n
    np.testing.assert_array_equal(counts, np.asarray(jidx.arena.counts))
    np.testing.assert_array_equal(idx.arena.ids, jidx.arena.ids)
    _, got = idx.search(x[:32], SearchParams(nprobe=nlist, k=3))
    assert (got[:, 0] == np.arange(32)).all()


def test_build_streams_an_arrow_file_into_both_families(tmp_path, rng):
    """Chunks read off a vectors file (``iter_vector_chunks``) with a
    train sample spread over it (``read_train_sample``) build an IVF-Flat
    and an IVF-PQ index; IVF-PQ reserves the capacity up front."""
    n, nlist = 3000, 8
    x = _clustered(rng, n, n_clusters=nlist)
    src = str(tmp_path / "corpus.arrow")
    ArrowStorage.write_vectors(src, np.arange(n, dtype=np.uint64) + 7, x)
    for idx in (IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=nlist,
                                           dtype="int8"), device="cpu"),
                IVFPQIndex(IVFPQConfig(dimension=DIM, nlist=nlist, m=4,
                                       pq_train_sample=1024),
                           device="cpu")):
        sample = ArrowStorage.read_train_sample(
            src, train_sample_rows(idx.config))
        built = build_index_chunked(
            idx, ArrowStorage.iter_vector_chunks(src, 700),
            ArrowStorage.num_rows(src), train_sample=sample)
        assert built == n == idx.ntotal
        cap = idx.arena.capacity if hasattr(idx, "arena") else idx.capacity
        assert cap >= chunked_capacity(n, nlist)
        _, got = idx.search(x[:8], SearchParams(nprobe=nlist, k=3,
                                                use_exact_rerank=True))
        assert (got[:, 0] == np.arange(8) + 7).all()
