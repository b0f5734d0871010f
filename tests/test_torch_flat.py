"""PyTorch port, the exact FlatIndex: the cases of the JAX package's
``tests/test_flat.py``, and the default bf16 table against the JAX index
on the same rows (CPU)."""

import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu import FlatIndex as JFlat
from cuda_acceleratedvectordatabaseengine_tpu_torch import FlatIndex
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_flat_exact(rng, oracle, metric):
    x = rng.standard_normal((500, 24)).astype(np.float32)
    q = rng.standard_normal((7, 24)).astype(np.float32)
    idx = FlatIndex(24, metric=metric, dtype=np.float32, chunk_size=128,
                    device="cpu")
    idx.add(x)
    d, ids = idx.search(q, k=10)
    _, ref = oracle(q, x, 10, metric)
    assert np.array_equal(np.sort(ids), np.sort(ref.astype(np.uint64)))
    assert (np.diff(d, axis=1) >= 0).all()


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_flat_fp32_table_matches_jax(rng, metric):
    """An fp32 table, with growth and removals in between: ids up to ties
    and fp32 distances equal to the JAX index's."""
    x = rng.standard_normal((1500, 32)).astype(np.float32)
    q = rng.standard_normal((9, 32)).astype(np.float32)
    t = FlatIndex(32, metric=metric, dtype="float32", chunk_size=512,
                  device="cpu")
    j = JFlat(32, metric=metric, dtype=np.float32, chunk_size=512)
    for idx in (t, j):
        idx.add(x[:1000])
        idx.add(x[1000:], ids=np.arange(1000, 1500, dtype=np.uint64) * 3)
        assert idx.remove_ids(np.arange(0, 1000, 7, dtype=np.uint64)) == 143
    atol = 1e-5 if metric == "Cosine" else 1e-5 * (q * q).sum(1)
    assert_topk_match(*t.search(q, k=20), *j.search(q, k=20), rtol=1e-5,
                      atol=atol)


def test_flat_bf16_table_is_exact_over_the_stored_rows(rng, oracle):
    """The default bf16 table: the fp32 query against the stored (bf16)
    rows, exact to fp32 rounding (the JAX index rounds the query too, so
    its distances are off by bf16 rounding; within that bound here)."""
    x = rng.standard_normal((1500, 32)).astype(np.float32)
    q = rng.standard_normal((9, 32)).astype(np.float32)
    t, j = FlatIndex(32, chunk_size=512, device="cpu"), JFlat(32)
    assert t.dtype == torch.bfloat16
    t.add(x)
    j.add(x)
    stored = torch.from_numpy(x).bfloat16().float().numpy()
    d_ref, i_ref = oracle(q, stored, 10)
    got = t.search(q, k=10)
    qsq = (q.astype(np.float64) ** 2).sum(1)
    assert_topk_match(*got, d_ref, i_ref.astype(np.uint64), rtol=1e-5,
                      atol=1e-5 * qsq)
    # |Δd| ≤ 2⁻⁷ ‖q‖ ‖x‖ (query rounding) + 2⁻⁷ ‖x‖² (the JAX norms)
    xn = np.linalg.norm(x, axis=1).max()
    bound = 2.0 ** -7 * (np.sqrt(qsq) * xn + xn ** 2)
    jd, _ = j.search(q, k=10)
    assert (np.abs(np.sort(jd, 1) - got[0]) <= bound[:, None]).all()


def test_flat_remove_ids(rng, oracle):
    x = rng.standard_normal((600, 24)).astype(np.float32)
    idx = FlatIndex(24, dtype=np.float32, chunk_size=128, device="cpu")
    idx.add(x)
    victims = np.asarray([0, 5, 299, 598, 599], np.uint64)
    assert idx.remove_ids(victims) == len(victims)
    assert len(idx) == 595
    _, ids = idx.search(x[victims.astype(np.int64)], k=10)
    assert not np.isin(ids, victims).any()
    keep = np.setdiff1d(np.arange(600), victims.astype(np.int64))
    q2 = rng.standard_normal((4, 24)).astype(np.float32)
    _, ids2 = idx.search(q2, k=5)
    _, ref = oracle(q2, x[keep], 5)
    assert np.array_equal(np.sort(ids2), np.sort(keep[ref].astype(np.uint64)))
    assert idx.remove_ids(victims) == 0


def test_flat_incremental_add_and_growth(rng, oracle):
    idx = FlatIndex(16, dtype=np.float32, chunk_size=256, device="cpu")
    chunks = [rng.standard_normal((700, 16)).astype(np.float32)
              for _ in range(3)]
    for i, c in enumerate(chunks):
        idx.add(c, ids=np.arange(i * 700, (i + 1) * 700, dtype=np.uint64))
    assert len(idx) == 2100 and idx._data.shape[0] == 4096
    q = rng.standard_normal((3, 16)).astype(np.float32)
    _, ids = idx.search(q, k=5)
    _, ref = oracle(q, np.concatenate(chunks), 5)
    assert np.array_equal(np.sort(ids), np.sort(ref.astype(np.uint64)))


def test_flat_underfull_returns_sentinels(rng):
    idx = FlatIndex(8, dtype=np.float32, device="cpu")
    idx.add(rng.standard_normal((3, 8)).astype(np.float32))
    d, ids = idx.search(rng.standard_normal((2, 8)).astype(np.float32), k=10)
    assert (ids[:, 3:] == INVALID_ID).all()
    assert (d[:, 3:] == np.finfo(np.float32).max).all()
    assert (ids[:, :3] != INVALID_ID).all()
    empty = FlatIndex(8, device="cpu")
    d, ids = empty.search(np.zeros((1, 8), np.float32), k=2)
    assert (ids == INVALID_ID).all()


def test_flat_custom_ids(rng):
    idx = FlatIndex(8, dtype=np.float32, device="cpu")
    x = rng.standard_normal((10, 8)).astype(np.float32)
    ids = (np.arange(10, dtype=np.uint64) + 1) * 1000
    idx.add(x, ids=ids)
    _, got = idx.search(x[:2], k=1)
    assert got[0, 0] == 1000 and got[1, 0] == 2000
    with pytest.raises(ValueError):
        idx.add(np.zeros((2, 9), np.float32))
