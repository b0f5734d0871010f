"""A search's copies between the host and the card (``utils/transfer``),
and a search's enqueue with no wait for the card.

On the CPU: the upload and the host copy hand the values back unchanged.
On a card (marked ``cuda``; skipped without one): a search of a resident
IVF-Flat index and of an IVF-PQ index, eager and replayed from CUDA
graphs, enqueues under ``torch.cuda.set_sync_debug_mode("error")``, where
any synchronising call raises; 200 back-to-back searches with distinct
queries, enqueued from one host buffer overwritten after each enqueue and
finalized after all of them, answer bit for bit as the same searches run
one at a time, at B 64, 37 and 1. The sharded views over two shards on
the one card answer through the same finalize, pinned and fenced by the
search's event, bit for bit as through pageable ``.cpu()`` copies.

This module imports no JAX. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_transfer.py
"""

import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFFlatConfig,
    IVFFlatIndex,
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.search import (
    FLT_MAX,
    positions_to_ids,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel.mesh import (
    make_mesh,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel.sharded import (
    ShardedIVFFlatIndex,
    ShardedIVFPQIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.transfer import (
    HostCopy,
    upload,
)

DIM = 128
N = 200_000
NLIST = 256
SEARCHES = 200


@pytest.mark.parametrize("dtype, shape", [
    (np.float32, (64, 32)), (np.float64, (37, 8)), (np.float32, (1, 768)),
])
def test_upload_and_host_copy_round_trip_on_the_cpu(dtype, shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(dtype)
    t = upload(x, torch.device("cpu"))
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), x.astype(np.float32))
    pos = torch.arange(t.numel(), dtype=torch.int32).reshape(t.shape)
    d, p = HostCopy(t, pos).numpy()
    np.testing.assert_array_equal(d, x.astype(np.float32))
    np.testing.assert_array_equal(p, pos.numpy())
    assert p.dtype == np.int32
    assert not np.shares_memory(d, t.numpy())
    assert not np.shares_memory(p, pos.numpy())


@pytest.fixture(scope="module")
def corpus():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: only there does a copy or a "
                    "read-back wait for the card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    centers = 4.0 * torch.randn((NLIST // 2, DIM), generator=g, device=dev)
    pick = torch.randint(0, centers.shape[0], (N,), generator=g, device=dev)
    return centers[pick] + torch.randn((N, DIM), generator=g, device=dev)


def _index(kind, x):
    ids = np.arange(N, dtype=np.uint64)
    if kind == "ivf_flat":
        idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=NLIST),
                           device=x.device)
        p = SearchParams(nprobe=16, k=10)
    else:
        idx = IVFPQIndex(IVFPQConfig(dimension=DIM, nlist=NLIST, m=16,
                                     raw_dtype="bfloat16", rerank_k=512),
                         device=x.device)
        idx.graph_searches = kind == "ivf_pq_graphs"
        p = SearchParams(nprobe=16, k=10, use_exact_rerank=True)
    idx.train_from_device(x)
    idx.build_from_device(x, ids)
    return idx, p


def _queries(corpus):
    """``queries(b)``: b corpus rows with noise, a new draw each call."""
    rng = np.random.default_rng(11)

    def queries(b):
        rows = torch.from_numpy(rng.integers(0, N, b)).to(corpus.device)
        return (corpus[rows].cpu().numpy()
                + 0.5 * rng.standard_normal((b, DIM))).astype(np.float32)
    return queries


class _NoSync:
    """Every synchronising call of PyTorch raises inside the block."""

    def __enter__(self):
        torch.cuda.synchronize()
        self.mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.mode)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq", "ivf_pq_graphs"])
def test_a_search_enqueues_with_no_sync_and_pipelines_exactly(corpus, kind):
    idx, p = _index(kind, corpus)
    queries = _queries(corpus)

    for b in (64, 37, 1):
        for _ in range(3):      # the kernels' build, the graphs' capture
            idx.search(queries(b), p)
        qs = [queries(b) for _ in range(SEARCHES)]
        buf = np.empty_like(qs[0])
        thunks = []
        with _NoSync():
            for q in qs:
                buf[...] = q
                thunks.append(idx.search_async(buf, p))
                buf[...] = np.nan   # the staged copy must not see this
        got = [fin() for fin in thunks]
        assert all(fin.waits["enqueue"] > 0.0 for fin in thunks)
        for q, (d, i) in zip(qs, got):
            d0, i0 = idx.search(q, p)
            np.testing.assert_array_equal(i, i0)
            np.testing.assert_array_equal(d, d0)


def _pageable(d_dev, pos_dev, ids_table):
    """The sharded views' finalize before the shared one: pageable copies
    back, then the id map and the sentinels."""
    d = d_dev.cpu().numpy().copy()
    pos = pos_dev.cpu().numpy()
    d[pos < 0] = FLT_MAX
    return d, positions_to_ids(pos, ids_table)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_a_sharded_search_answers_as_through_pageable_copies(corpus, kind):
    idx, p = _index(kind, corpus)
    view = (ShardedIVFFlatIndex if kind == "ivf_flat" else ShardedIVFPQIndex)(
        idx, make_mesh(devices=[corpus.device] * 2))
    queries = _queries(corpus)
    for b in (64, 37, 1):
        qs = [queries(b) for _ in range(SEARCHES // 10)]
        pendings = [view.search_async(q, p) for q in qs]
        got = [pending() for pending in pendings]
        assert all(set(pending.waits) == {"enqueue", "fetch_wait"}
                   for pending in pendings)
        for q, (d, i) in zip(qs, got):
            d0, i0 = view._enqueue(q, p, _pageable)
            np.testing.assert_array_equal(i, i0)
            np.testing.assert_array_equal(d, d0)
