"""PyTorch port, packed list arena: the same rows, lists and slots appended
by both packages give the same stored state (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu.models.arena import (
    PackedListArena as JArena,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
    PackedListArena,
    compute_append_slots,
)

torch.set_num_threads(1)

NLIST, DIM = 6, 24
JAX_DTYPES = {"int8": jnp.int8, "bfloat16": jnp.bfloat16,
              "float32": jnp.float32}


def _pair(dtype, anchors=None):
    j = JArena.create(NLIST, DIM, dtype=JAX_DTYPES[dtype])
    t = PackedListArena.create(NLIST, DIM, dtype=dtype, device="cpu")
    if anchors is not None:
        import dataclasses

        j = dataclasses.replace(j, anchors=jnp.asarray(anchors))
        t = dataclasses.replace(t, anchors=torch.from_numpy(anchors))
    return j, t


def _append_both(rng, j, t, n, offset=0):
    x = (rng.standard_normal((n, DIM)) * 2.0).astype(np.float32)
    assign = rng.integers(0, NLIST, n).astype(np.int32)
    ids = np.arange(offset, offset + n, dtype=np.uint64) * 7 + 3
    return j.append(x, ids, assign), t.append(x, ids, assign), x, assign


def _codes_agree(a_t, a_j):
    """int8 codes equal, a difference of 1 allowed on ≤ 0.01% of them
    (a residual at an exact .5 rounding boundary)."""
    diff = np.abs(a_t.astype(np.int32) - a_j.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4


def _state_agrees(j, t):
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(t.ids, j.ids)
    assert t.capacity == j.capacity and t.counts_max == j.counts_max
    if t.dtype == torch.int8:
        _codes_agree(t.arena.numpy(), np.asarray(j.arena))
        np.testing.assert_allclose(t.arena_scale.numpy(),
                                   np.asarray(j.arena_scale), rtol=1e-6)
    else:
        np.testing.assert_array_equal(
            t.arena.float().numpy(), np.asarray(j.arena).astype(np.float32)
        )
    np.testing.assert_allclose(t.arena_sq.numpy(), np.asarray(j.arena_sq),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,residual", [
    ("int8", True), ("int8", False), ("bfloat16", False), ("float32", False),
])
def test_append_matches_jax(rng, dtype, residual):
    anchors = (rng.standard_normal((NLIST, DIM)).astype(np.float32)
               if residual else None)
    j, t = _pair(dtype, anchors)
    j, t, _, _ = _append_both(rng, j, t, 300)
    _state_agrees(j, t)
    # a second append lands behind the first and grows the capacity
    j, t, _, _ = _append_both(rng, j, t, 700, offset=300)
    assert t.capacity > 128
    _state_agrees(j, t)


def test_append_returns_new_counts_and_keeps_snapshot(rng):
    _, t0 = _pair("int8")
    t1 = t0.append(rng.standard_normal((50, DIM)).astype(np.float32),
                   np.arange(50, dtype=np.uint64),
                   rng.integers(0, NLIST, 50))
    t2 = t1.append(rng.standard_normal((40, DIM)).astype(np.float32),
                   np.arange(50, 90, dtype=np.uint64),
                   rng.integers(0, NLIST, 40))
    # in-place rows, new counts / id table per handle
    assert t1.counts is not t2.counts and t1.ids is not t2.ids
    assert t1.total_vectors == 50 and t2.total_vectors == 90
    assert (t1.ids != INVALID_ID).sum() == 50


def test_grow_positions_and_host_roundtrip(rng):
    anchors = rng.standard_normal((NLIST, DIM)).astype(np.float32)
    _, t = _pair("int8", anchors)
    x = rng.standard_normal((200, DIM)).astype(np.float32)
    assign = rng.integers(0, NLIST, 200)
    ids = np.arange(1000, 1200, dtype=np.uint64)
    t = t.append(x, ids, assign)
    slots = compute_append_slots(np.zeros(NLIST, np.int64), assign)

    g = t.grow(384)
    assert g.capacity == 384 and g.arena.shape == (NLIST, 384, DIM)
    assert g.arena_scale.shape == (NLIST, 384)
    np.testing.assert_array_equal(g.arena[:, :128].numpy(), t.arena.numpy())
    assert (g.arena[:, 128:] == 0).all() and (g.ids[:, 128:] == INVALID_ID).all()
    with pytest.raises(ValueError):
        t.grow(64)

    pos = (assign * g.capacity + slots).astype(np.int32)[None, :]
    pos[0, :3] = -1
    got = g.positions_to_ids(pos)
    assert (got[0, :3] == INVALID_ID).all()
    np.testing.assert_array_equal(got[0, 3:], ids[3:])

    host = g.to_host()
    back = PackedListArena.from_host(host["arena"], host["counts"],
                                     host["ids"], "int8", anchors=anchors,
                                     device="cpu")
    _codes_agree(back.arena.numpy(), g.arena.numpy())
    np.testing.assert_allclose(back.arena_sq.numpy(), g.arena_sq.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(back.counts.numpy(), g.counts.numpy())
    # the dequantized view matches the JAX package's from the same state
    jback = JArena.from_host(host["arena"], host["counts"], host["ids"],
                             jnp.int8, anchors=anchors)
    np.testing.assert_allclose(back.to_host()["arena"],
                               jback.to_host()["arena"], rtol=1e-5,
                               atol=1e-5)
    assert g.scan_capacity_hint() == 128 and g.nbytes_device() > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_float_host_roundtrip(rng, dtype):
    _, t = _pair(dtype)
    x = rng.standard_normal((100, DIM)).astype(np.float32)
    t = t.append(x, np.arange(100, dtype=np.uint64),
                 rng.integers(0, NLIST, 100))
    host = t.to_host()
    back = PackedListArena.from_host(host["arena"], host["counts"],
                                     host["ids"], dtype, device="cpu")
    assert back.dtype == t.dtype
    np.testing.assert_array_equal(back.arena.float().numpy(),
                                  t.arena.float().numpy())
    np.testing.assert_allclose(back.arena_sq.numpy(), t.arena_sq.numpy(),
                               rtol=1e-6)
