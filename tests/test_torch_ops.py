"""PyTorch port, small ops: distances, normalization and top-k, held
against the JAX package on the same numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu.ops import distance as jdist
from cuda_acceleratedvectordatabaseengine_tpu.ops.normalize import (
    l2_normalize as j_l2_normalize,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.topk import (
    topk_smallest as j_topk_smallest,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import distance
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.normalize import (
    l2_normalize,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.topk import (
    merge_topk,
    topk_smallest,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.batching import (
    bucket_size,
)

torch.set_num_threads(1)


def test_metric_values_match_jax():
    assert [m.value for m in distance.Metric] == [
        m.value for m in jdist.Metric
    ]
    assert distance.Metric.parse("innerproduct") is \
        distance.Metric.INNER_PRODUCT
    with pytest.raises(ValueError):
        distance.Metric.parse("hamming")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_pairwise_distance_matches_jax(rng, metric):
    q = rng.standard_normal((7, 48)).astype(np.float32)
    x = rng.standard_normal((33, 48)).astype(np.float32) * 2.0
    d_t = distance.pairwise_distance(
        torch.from_numpy(q), torch.from_numpy(x),
        distance.Metric.parse(metric),
    ).numpy()
    d_j = np.asarray(jdist.pairwise_distance(
        jnp.asarray(q), jnp.asarray(x), jdist.Metric.parse(metric)
    ))
    # fp32 sums in another order: error scales with ‖q‖² (L2's magnitude)
    atol = 1e-5 * (q * q).sum(1, keepdims=True)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=atol.max())
    assert d_t.dtype == np.float32 and d_t.shape == (7, 33)


def test_squared_norms_and_l2_normalize_match_jax(rng):
    x = rng.standard_normal((9, 40)).astype(np.float32) * 3.0
    np.testing.assert_allclose(
        distance.squared_norms(torch.from_numpy(x)).numpy(),
        np.asarray(jdist.squared_norms(jnp.asarray(x))), rtol=1e-6,
    )
    y_t = l2_normalize(torch.from_numpy(x)).numpy()
    y_j = np.asarray(j_l2_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-6, atol=1e-7)
    z = l2_normalize(torch.from_numpy(x).to(torch.bfloat16))
    assert z.dtype == torch.bfloat16


def test_topk_smallest_with_idx_inf_and_invalid(rng):
    d = rng.standard_normal((6, 50)).astype(np.float32)
    d[0, 5:] = np.inf                     # a row with only 5 finite entries
    d[3, ::2] = np.inf
    pos = rng.permutation(6 * 50).reshape(6, 50).astype(np.int32)
    pos[np.isinf(d)] = -1
    k = 8
    v_t, i_t = topk_smallest(torch.from_numpy(d), k,
                             idx=torch.from_numpy(pos))
    v_j, i_j = j_topk_smallest(jnp.asarray(d), k, idx=jnp.asarray(pos))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    finite = np.isfinite(v_t.numpy())
    # finite values are distinct, so their identities must match exactly
    np.testing.assert_array_equal(i_t.numpy()[finite], np.asarray(i_j)[finite])
    assert (i_t.numpy()[~finite] == -1).all()
    v_c, c_t = topk_smallest(torch.from_numpy(d), k, approx=True)
    np.testing.assert_array_equal(v_c.numpy(), v_t.numpy())
    assert (np.diff(np.where(finite, v_t.numpy(), 3e38), axis=1) >= 0).all()


def test_merge_topk(rng):
    a = np.sort(rng.standard_normal((4, 5)).astype(np.float32), axis=1)
    b = np.sort(rng.standard_normal((4, 5)).astype(np.float32), axis=1)
    ia = np.arange(20, dtype=np.int32).reshape(4, 5)
    ib = ia + 100
    v, i = merge_topk(torch.from_numpy(a), torch.from_numpy(ia),
                      torch.from_numpy(b), torch.from_numpy(ib), 5)
    both = np.concatenate([a, b], 1)
    np.testing.assert_array_equal(v.numpy(), np.sort(both, 1)[:, :5])
    ids = np.concatenate([ia, ib], 1)
    np.testing.assert_array_equal(
        i.numpy(), np.take_along_axis(ids, np.argsort(both, 1)[:, :5], 1)
    )


@pytest.mark.parametrize("n,expect", [(0, 1), (1, 1), (3, 4), (1024, 1024),
                                      (1025, 2048)])
def test_bucket_size(n, expect):
    assert bucket_size(n) == expect
