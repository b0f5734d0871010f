"""PyTorch port, the native host runtime (``native/``): the ``g++`` build
into ``build/native/``, the staging helpers against their numpy versions
and the JAX package's ``native`` module, ``readahead``, and the fused
shortlist rerank against the JAX package's numpy rerank on the same stores
(CPU)."""

import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu import native as jnative
from cuda_acceleratedvectordatabaseengine_tpu.io_host import (
    host_rerank as jhr,
)
from cuda_acceleratedvectordatabaseengine_tpu.io_host.streaming import (
    HostListStore as JStore,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.distance import (
    Metric as JMetric,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch import native
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
    host_rerank as thr,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.streaming import (
    HostListStore,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

DIM, NLIST = 40, 6
RTOL = 1e-5        # the stated tolerance: RTOL · |d| + ATOL_QSQ · ‖q‖²
ATOL_QSQ = 1e-5    # (a C++ fp32 dot sums in another order than BLAS)
SQ_RTOL = 1e-6     # squared norms: the C++ loop against numpy's sum


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's module with its library built: its entry points
    would fall back to numpy without one, which is not what they are held
    against here."""
    assert jnative.available()
    return jnative


def test_native_builds_into_build_root_and_reuses_it(tmp_path):
    lib = native.load_library()
    assert lib.vdb_hardware_concurrency() >= 1
    built = native.build_library()
    assert built.parent.parent == native.BUILD_ROOT
    assert built.parts[-3:-2] == ("native",)
    # a fresh root builds once, then hands back the same file untouched
    first = native.build_library(tmp_path)
    mtime = first.stat().st_mtime_ns
    assert native.build_library(tmp_path) == first
    assert first.stat().st_mtime_ns == mtime
    assert [p.name for p in first.parent.iterdir()] == [native.LIB_NAME]
    assert native.available()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source the compiler refuses raises with its message and leaves no
    library and no temporary file behind."""
    bad = tmp_path / "vdbhost.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library(tmp_path / "out")
    assert not [p for p in (tmp_path / "out").rglob("*") if p.is_file()]


@pytest.mark.parametrize("counts", [(3, 0, 7, 5), (10,), (0, 0), (8, 1)])
def test_gather_lists(rng, jax_native, counts):
    """Padded staging block: vectors bit for bit against the numpy version
    and the JAX package's; squared norms within 1e-6 relative of numpy's
    and equal to the JAX package's C++ (the same source). A list longer
    than ``cap`` is cut."""
    cap = 8
    lists = [rng.standard_normal((c, DIM)).astype(np.float32)
             for c in counts]
    out, sq = native.gather_lists(lists, cap=cap, dim=DIM)
    ref, ref_sq = native.gather_lists_plain(lists, cap=cap, dim=DIM)
    jout, jsq = jax_native.gather_lists(lists, cap=cap, dim=DIM)
    assert out.shape == (len(counts), cap, DIM) and sq.shape == (
        len(counts), cap)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_allclose(sq, ref_sq, rtol=SQ_RTOL)
    np.testing.assert_array_equal(sq, jsq)
    for i, c in enumerate(counts):
        assert (out[i, min(c, cap):] == 0).all()
        assert (sq[i, min(c, cap):] == 0).all()


def test_gather_rows(rng, jax_native):
    """Rows by index; -1 and rows past the end give zeros."""
    src = rng.standard_normal((100, DIM)).astype(np.float32)
    rows = np.array([5, 0, 99, -1, 42, 100, 7, 5], np.int64)
    out = native.gather_rows(src, rows)
    np.testing.assert_array_equal(out, native.gather_rows_plain(src, rows))
    np.testing.assert_array_equal(out, jax_native.gather_rows(src, rows))
    np.testing.assert_array_equal(out[0], src[5])
    assert (out[3] == 0).all() and (out[5] == 0).all()
    empty = np.zeros((0, DIM), np.float32)
    np.testing.assert_array_equal(native.gather_rows(empty, rows),
                                  native.gather_rows_plain(empty, rows))


def test_f32_to_bf16(rng, jax_native):
    """Round-to-nearest-even bits: equal to the numpy version, to the JAX
    package's and to ``torch.Tensor.to(torch.bfloat16)`` (zeros, infinities,
    the largest float, subnormals and ties included; NaN payloads are not
    part of the contract)."""
    x = np.concatenate([
        rng.standard_normal(4990).astype(np.float32) * 100,
        np.array([0.0, -0.0, np.inf, -np.inf, 3.4028235e38, 1e-40, -1e-45,
                  1.00390625, 1.01171875, -2.00781250], np.float32),
    ]).reshape(50, -1)
    got = native.f32_to_bf16(x)
    assert got.shape == x.shape and got.dtype == np.uint16
    np.testing.assert_array_equal(got, native.f32_to_bf16_plain(x))
    np.testing.assert_array_equal(got, jax_native.f32_to_bf16(x))
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want.view(np.uint16))


def test_readahead(tmp_path, jax_native):
    p = str(tmp_path / "blob")
    with open(p, "wb") as f:
        f.write(b"x" * 100_000)
    assert native.readahead(p, 0, 100_000, touch_bytes=4096)
    assert native.readahead(p)
    assert jax_native.readahead(p, 0, 100_000, touch_bytes=4096)
    assert not native.readahead(str(tmp_path / "missing"))
    # a warm read past the end of the file comes up short
    assert not native.readahead(p, 99_000, 0, touch_bytes=4096)


# --------------------------------------------------------------------------- #
# the fused rerank
# --------------------------------------------------------------------------- #

def _stores(rng, n, dtype):
    """The same rows, ids and list assignment in both packages' stores."""
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    ids = (np.arange(n, dtype=np.uint64) * 3 + 11)
    assigns = rng.integers(0, NLIST, n).astype(np.int64)
    anchors = None
    if dtype == "int8":
        anchors = np.stack([x[assigns == l].mean(0) for l in range(NLIST)])
    mine = HostListStore.from_assignments(x, ids, assigns, NLIST,
                                          dtype=dtype, anchors=anchors)
    theirs = JStore.from_assignments(x, ids, assigns, NLIST, dtype=dtype,
                                     anchors=anchors)
    return ids, mine, theirs


def _shortlists(rng, ids, b, r):
    """Shortlists with INVALID_ID padding, a fully padded row, unknown ids
    (which map to row -1) and repeated candidates."""
    cand = ids[rng.integers(0, len(ids), (b, r))]
    cand[0, 1] = INVALID_ID
    cand[1, :] = INVALID_ID
    cand[2, :3] = np.uint64(10**12)
    cand[3, 4] = cand[3, 5]
    return cand


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_native_rerank_matches_jax_numpy(rng, metric, dtype):
    """The port's fused C++ rerank against the JAX package's numpy rerank
    on identical stores: ids equal up to ties, distances within RTOL · |d|
    + ATOL_QSQ · ‖q‖²; k below, at and above the shortlist depth (r < k
    pads with FLT_MAX / INVALID_ID)."""
    ids, mine, theirs = _stores(rng, 500, dtype)
    rr = thr.HostReranker(mine, use_native=True)
    jrr = jhr.HostReranker(theirs, use_native=False)
    q = rng.standard_normal((9, DIM)).astype(np.float32)
    if metric == "Cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    cand = _shortlists(rng, ids, 9, 12)
    atol = ATOL_QSQ * (q.astype(np.float64) ** 2).sum(1)
    for k in (4, 12, 20):
        d, got = rr.rerank(q, cand, Metric.parse(metric), k)
        jd, jgot = jrr.rerank(q, cand, JMetric.parse(metric), k)
        assert d.shape == (9, k) and got.dtype == np.uint64
        assert_topk_match(d, got, jd, jgot, rtol=RTOL, atol=atol)
        assert (got[1] == INVALID_ID).all()
        assert (d[1] == thr.FLT_MAX).all()
        if k > 12:
            assert (got[:, 12:] == INVALID_ID).all()
    assert rr.native_batches == 3 and rr.numpy_batches == 0


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_native_rerank_call_matches_the_numpy_path(rng, dtype):
    """``native.rerank`` called directly with rows of -1 (what the reranker
    passes for unknown ids) against the port's own numpy path."""
    ids, mine, _ = _stores(rng, 300, dtype)
    rr = thr.HostReranker(mine, use_native=False)
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    cand = _shortlists(rng, ids, 6, 16)
    rows = rr._rows_of_ids(cand)
    assert (rows[1] == -1).all() and (rows[2, :3] == -1).all()
    q_sq = np.einsum("bd,bd->b", q, q)
    qa = rr._anchor_dots(q, rows) if rr.quantized else None
    d, got = native.rerank(rr.vecs, rows, cand, q, q_sq, 0, 5,
                           scale=rr.scale, sq=rr.sq,
                           anchor_row=rr.anchor_row, qa_cand=qa)
    jd, jgot = rr.rerank(q, cand, Metric.L2, 5)
    assert_topk_match(d, got, jd, jgot, rtol=RTOL,
                      atol=ATOL_QSQ * q_sq.astype(np.float64))


def test_native_rerank_equals_the_jax_native_bits(rng, jax_native):
    """The same source built by either package gives the same bits."""
    ids, mine, theirs = _stores(rng, 400, "int8")
    rr = thr.HostReranker(mine, use_native=True)
    jrr = jhr.HostReranker(theirs, use_native=True)
    q = rng.standard_normal((7, DIM)).astype(np.float32)
    cand = _shortlists(rng, ids, 7, 10)
    for metric in ("L2", "InnerProduct", "Cosine"):
        d, got = rr.rerank(q, cand, Metric.parse(metric), 6)
        jd, jgot = jrr.rerank(q, cand, JMetric.parse(metric), 6)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(got, jgot)


def test_layout_picks_the_path(rng):
    """A store that is not C-contiguous takes the numpy path even with
    ``use_native`` (the store is never copied for the C++), and the two
    paths agree; ``native.rerank`` refuses such a store outright."""
    ids, mine, _ = _stores(rng, 300, "float32")
    rr = thr.HostReranker(mine, use_native=True)
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    cand = _shortlists(rng, ids, 4, 9)
    d, got = rr.rerank(q, cand, Metric.L2, 5)
    assert (rr.native_batches, rr.numpy_batches) == (1, 0)
    wide = np.zeros((rr.vecs.shape[0], 2 * DIM), np.float32)
    wide[:, ::2] = rr.vecs
    rr.vecs = wide[:, ::2]
    assert not rr.vecs.flags["C_CONTIGUOUS"]
    d2, got2 = rr.rerank(q, cand, Metric.L2, 5)
    assert (rr.native_batches, rr.numpy_batches) == (1, 1)
    assert_topk_match(d, got, d2, got2, rtol=RTOL,
                      atol=ATOL_QSQ * (q.astype(np.float64) ** 2).sum(1))
    rows = rr._rows_of_ids(cand)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.rerank(rr.vecs, rows, cand, q, None, 1, 5)


def test_native_rerank_checks_its_arguments(rng):
    ids, mine, _ = _stores(rng, 50, "int8")
    rr = thr.HostReranker(mine, use_native=True)
    q = rng.standard_normal((2, DIM)).astype(np.float32)
    rows = np.zeros((2, 3), np.int64)
    cand = np.zeros((2, 3), np.uint64)
    q_sq = np.ones(2, np.float32)
    with pytest.raises(ValueError, match="L2 needs"):
        native.rerank(rr.vecs, rows, cand, q, None, 0, 2, scale=rr.scale)
    with pytest.raises(ValueError, match="needs scale"):
        native.rerank(rr.vecs, rows, cand, q, q_sq, 1, 2)
    with pytest.raises(ValueError, match="qa_cand"):
        native.rerank(rr.vecs, rows, cand, q, q_sq, 1, 2, scale=rr.scale)
    with pytest.raises(ValueError, match="queries"):
        native.rerank(rr.vecs, rows, cand, q[:, :5], q_sq, 1, 2,
                      scale=rr.scale, qa_cand=np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="scale must have shape"):
        native.rerank(rr.vecs, rows, cand, q, q_sq, 1, 2,
                      scale=rr.scale[:-1], qa_cand=np.zeros((2, 3)))
    with pytest.raises(ValueError, match="metric_code"):
        native.rerank(rr.vecs, rows, cand, q, q_sq, 3, 2, scale=rr.scale,
                      qa_cand=np.zeros((2, 3)))
