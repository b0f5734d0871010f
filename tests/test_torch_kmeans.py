"""PyTorch port, k-means: assignment against the JAX package on the same
centroids, and training held to the JAX trainer by quality (the two
packages' random streams differ, so their centroids cannot be equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu.ops import kmeans as jkm
from cuda_acceleratedvectordatabaseengine_tpu.ops.distance import (
    Metric as JMetric,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import kmeans as tkm
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric

torch.set_num_threads(1)


def _mixture(rng, n_modes=16, per_mode=250, dim=32, noise=0.25):
    centers = rng.standard_normal((n_modes, dim)).astype(np.float32)
    labels = np.repeat(np.arange(n_modes), per_mode)
    x = centers[labels] + noise * rng.standard_normal(
        (labels.size, dim)).astype(np.float32)
    perm = rng.permutation(labels.size)
    return x[perm], labels[perm]


def _dist(x, c, metric):
    if metric == "InnerProduct":
        return -(x @ c.T)
    return ((x[:, None, :] - c[None]) ** 2).sum(-1)


@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_assign_matches_jax(rng, metric):
    x = rng.standard_normal((3000, 24)).astype(np.float32)
    c = rng.standard_normal((40, 24)).astype(np.float32)
    jm, tm = JMetric.parse(metric), Metric.parse(metric)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    a_t = tkm.kmeans_assign(xt, ct, tm, chunk_size=1024).numpy()
    a_j = np.asarray(jkm.kmeans_assign(jnp.asarray(x), jnp.asarray(c), jm,
                                       chunk_size=1024))
    top_t = tkm.kmeans_assign_topk(xt, ct, 4, tm, chunk_size=1024).numpy()
    top_j = np.asarray(jkm.kmeans_assign_topk(jnp.asarray(x), jnp.asarray(c),
                                              4, jm, chunk_size=1024))
    vals_t, idx_t = tkm.kmeans_assign_topk_vals(xt, ct, 4, tm)
    d = _dist(x.astype(np.float64), c.astype(np.float64), metric)
    rows = np.arange(x.shape[0])[:, None]

    def tie(i_a, i_b):
        # ids may differ only where the two centroids are equidistant
        da, db = d[rows, i_a], d[rows, i_b]
        return np.abs(da - db) <= 1e-5 * (1.0 + np.abs(db))

    assert ((a_t == a_j) | tie(a_t[:, None], a_j[:, None])[:, 0]).all()
    assert ((top_t == top_j) | tie(top_t, top_j)).all()
    np.testing.assert_array_equal(idx_t.numpy(), top_t)
    np.testing.assert_allclose(vals_t.numpy(), d[rows, top_t], rtol=1e-4,
                               atol=1e-4)
    assert a_t.dtype == np.int32 and top_t.shape == (3000, 4)


def _inertia(x, c):
    return float(((x[:, None, :] - c[None]) ** 2).sum(-1).min(1).sum())


def _purity_ok(assign, labels, k):
    """One mode per list: every list serves exactly one mode and every
    mode lands in exactly one list."""
    pairs = {(int(a), int(b)) for a, b in zip(assign, labels)}
    lists = {a for a, _ in pairs}
    modes = {b for _, b in pairs}
    return len(pairs) == len(lists) == len(modes) == k


def test_kmeans_fit_quality_matches_jax(rng):
    x, labels = _mixture(rng)
    k = 16
    c_j, a_j = jkm.kmeans_fit(jax.random.PRNGKey(3), jnp.asarray(x), k,
                              iters=10, chunk_size=1024)
    gen = torch.Generator().manual_seed(3)
    c_t, a_t = tkm.kmeans_fit(torch.from_numpy(x), k, iters=10,
                              chunk_size=1024, generator=gen)
    c_t, a_t = c_t.numpy(), a_t.numpy()
    assert c_t.shape == (k, 32) and c_t.dtype == np.float32
    assert a_t.shape == (x.shape[0],) and a_t.dtype == np.int32
    in_t, in_j = _inertia(x, c_t), _inertia(x, np.asarray(c_j))
    assert in_t <= 1.05 * in_j
    assert np.bincount(a_t, minlength=k).min() > 0       # no empty list
    assert _purity_ok(a_t, labels, k)
    assert _purity_ok(np.asarray(a_j), labels, k)
    # the returned assignments are the nearest centroids of the last pass
    near = tkm.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c_t))
    assert (near.numpy() == a_t).mean() > 0.99


def test_kmeans_fit_is_seeded(rng):
    x, _ = _mixture(rng, n_modes=8, per_mode=100, dim=16)
    runs = [
        tkm.kmeans_fit(torch.from_numpy(x), 8, iters=4,
                       generator=torch.Generator().manual_seed(5))[0]
        for _ in range(2)
    ]
    np.testing.assert_array_equal(runs[0].numpy(), runs[1].numpy())


def test_kmeans_pp_seeds_are_data_rows(rng):
    x, _ = _mixture(rng, n_modes=8, per_mode=50, dim=16)
    c = tkm.kmeans_pp_init(torch.from_numpy(x), 8,
                           torch.Generator().manual_seed(0)).numpy()
    d = ((c[:, None, :] - x[None]) ** 2).sum(-1).min(1)
    assert (d == 0).all()
    assert len({tuple(r) for r in c}) == 8                # distinct rows
