"""PyTorch port, storage: the numpy Arrow IPC codec against ``pyarrow``
and the JAX package's ``ArrowStorage`` in both directions, and index
snapshots that cross between the packages both ways (CPU)."""

import functools
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu import (
    IVFFlatConfig as JFlatConfig,
    IVFFlatIndex as JFlatIndex,
    IVFPQConfig as JPQConfig,
    IVFPQIndex as JPQIndex,
    SearchParams as JParams,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops import pallas_scan
from cuda_acceleratedvectordatabaseengine_tpu.storage import snapshot as jsnap
from cuda_acceleratedvectordatabaseengine_tpu.storage.arrow_store import (
    ArrowStorage as JStorage,
    VectorFileWriter as JWriter,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFFlatConfig,
    IVFFlatIndex,
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
    StreamingIVFFlatIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    PackedListArena,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
    arrow_ipc,
    snapshot,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.arrow_store import (
    ArrowStorage,
    VectorFileWriter,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

DIM, NLIST = 24, 8


def _rows(rng, n, dim=DIM):
    ids = rng.integers(0, 2**64 - 2, n, dtype=np.uint64)
    return ids, rng.standard_normal((n, dim)).astype(np.float32)


def _pa_batch(ids, vecs, name="vector", item=pa.float32()):
    n, d = vecs.shape
    col = pa.ListArray.from_arrays(
        pa.array(np.arange(0, (n + 1) * d, d, dtype=np.int32)),
        pa.array(vecs.reshape(-1)))
    schema = pa.schema([("id", pa.uint64()), (name, pa.list_(item))])
    return pa.record_batch({"id": pa.array(ids), name: col},
                           schema=schema), schema


# --------------------------------------------------------------------------- #
# the codec
# --------------------------------------------------------------------------- #

def test_codec_reads_pyarrow_and_jax_files(tmp_path, rng):
    """Files written by pyarrow (several batches, one sliced table in
    chunks) and by the JAX package (``write_vectors``,
    ``VectorFileWriter``): whole reads, offset / length slices across
    batch boundaries, ``num_rows``, ``iter_vector_chunks`` and
    ``read_train_sample`` give what the JAX reader gives."""
    ids, x = _rows(rng, 1000)
    paths = {}
    # pyarrow: three record batches of uneven size
    paths["pa_batches"] = str(tmp_path / "pa_batches.arrow")
    _, schema = _pa_batch(ids[:1], x[:1])
    with ipc.new_file(paths["pa_batches"], schema) as w:
        for a, b in ((0, 123), (123, 700), (700, 1000)):
            w.write_batch(_pa_batch(ids[a:b], x[a:b])[0])
    # pyarrow: one table of four chunks, sliced (offsets start past 0)
    paths["pa_table"] = str(tmp_path / "pa_table.arrow")
    wide = _pa_batch(np.concatenate([ids[:5], ids]),
                     np.concatenate([x[:5], x]))[0].slice(5)
    table = pa.Table.from_batches(
        [wide.slice(a, 250) for a in range(0, 1000, 250)])
    with ipc.new_file(paths["pa_table"], schema) as w:
        w.write_table(table)
    paths["jax"] = str(tmp_path / "jax.arrow")
    JStorage.write_vectors(paths["jax"], ids, x)
    paths["jax_writer"] = str(tmp_path / "jax_writer.arrow")
    with JWriter(paths["jax_writer"]) as w:
        for a in range(0, 1000, 300):
            w.append(ids[a:a + 300], x[a:a + 300])
    for name, path in paths.items():
        got_ids, got = ArrowStorage.read_vectors(path)
        np.testing.assert_array_equal(got_ids, ids, err_msg=name)
        np.testing.assert_array_equal(got, x, err_msg=name)
        assert ArrowStorage.num_rows(path) == 1000
        for off, length in ((0, 1), (120, 10), (299, 302), (990, 50),
                            (1000, 5)):
            got = ArrowStorage.read_vectors(path, off, length)
            want = JStorage.read_vectors(path, off, length)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1].reshape(want[1].shape),
                                          want[1])
        chunks = list(ArrowStorage.iter_vector_chunks(path, 333))
        assert [len(c[0]) for c in chunks] == [333, 333, 333, 1]
        np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks]),
                                      x)
        np.testing.assert_array_equal(
            ArrowStorage.read_train_sample(path, 100, n_slices=7),
            JStorage.read_train_sample(path, 100, n_slices=7))


def test_codec_writes_files_pyarrow_and_jax_read(tmp_path, rng):
    """Vectors, codes, codebooks, centroids and a multi-append
    ``VectorFileWriter`` file: pyarrow validates and reads them, and the
    JAX package's readers return the same arrays."""
    ids, x = _rows(rng, 700)
    p = str(tmp_path / "v.arrow")
    ArrowStorage.write_vectors(p, ids, x)
    t = ipc.open_file(pa.memory_map(p)).read_all()
    t.validate(full=True)
    assert t.schema.equals(pa.schema([("id", pa.uint64()),
                                      ("vector", pa.list_(pa.float32()))]))
    np.testing.assert_array_equal(t.column("id").to_numpy(), ids)
    got = JStorage.read_vectors(p, 10, 400)
    np.testing.assert_array_equal(got[1], x[10:410])
    p = str(tmp_path / "w.arrow")
    with VectorFileWriter(p) as w:
        for a in range(0, 700, 256):
            w.append(ids[a:a + 256], x[a:a + 256])
        assert w.rows == 700
    with pa.memory_map(p) as f:
        r = ipc.open_file(f)
        assert r.num_record_batches == 3
        r.read_all().validate(full=True)
    np.testing.assert_array_equal(JStorage.read_vectors(p)[1], x)
    codes = rng.integers(0, 256, (700, 12)).astype(np.uint8)
    p = str(tmp_path / "c.arrow")
    ArrowStorage.write_codes(p, ids, codes)
    ipc.open_file(pa.memory_map(p)).read_all().validate(full=True)
    got_ids, got = JStorage.read_codes(p)
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got, codes)
    cb = rng.standard_normal((6, 256, 4)).astype(np.float32)
    p = str(tmp_path / "cb.arrow")
    ArrowStorage.write_codebooks(p, cb)
    np.testing.assert_array_equal(JStorage.read_codebooks(p), cb)
    np.testing.assert_array_equal(ArrowStorage.read_codebooks(p), cb)
    cen = rng.standard_normal((NLIST, DIM)).astype(np.float32)
    p = str(tmp_path / "cen.arrow")
    ArrowStorage.write_centroids(p, cen)
    np.testing.assert_array_equal(JStorage.read_centroids(p), cen)
    JStorage.write_codes(p, ids, codes)
    np.testing.assert_array_equal(ArrowStorage.read_codes(p)[1], codes)


def test_codec_splits_batches_at_the_row_limit(tmp_path, rng, monkeypatch):
    """With the value limit patched small, a write splits into batches of
    at most ``limit // width`` rows that pyarrow and the JAX reader read
    back whole; past the limit one batch's offsets would wrap."""
    monkeypatch.setattr(arrow_ipc, "ROW_VALUES_MAX", 10 * DIM + 5)
    ids, x = _rows(rng, 95)
    p = str(tmp_path / "split.arrow")
    ArrowStorage.write_vectors(p, ids, x)
    with pa.memory_map(p) as f:
        r = ipc.open_file(f)
        assert r.num_record_batches == 10
        assert max(r.get_batch(i).num_rows
                   for i in range(r.num_record_batches)) == 10
    np.testing.assert_array_equal(JStorage.read_vectors(p)[1], x)
    np.testing.assert_array_equal(ArrowStorage.read_vectors(p, 7, 31)[1],
                                  x[7:38])
    # the JAX writer's whole-table offsets wrap past 2³¹ values
    wrapped = np.arange(0, 3_000_000_000, 768 * 2**20, dtype=np.int32)
    assert (wrapped < 0).any()


def test_codec_refuses_what_it_cannot_read(tmp_path, rng):
    """Nulls, compressed bodies, dictionaries and other schemas are
    refused with the reason named."""
    ids, x = _rows(rng, 20)
    batch, schema = _pa_batch(ids, x)
    cases = {}
    p = str(tmp_path / "nulls.arrow")
    nulls = pa.record_batch(
        [pa.array([None] + ids[1:].tolist(), pa.uint64()),
         batch.column(1)], schema=schema)
    with ipc.new_file(p, schema) as w:
        w.write_batch(nulls)
    cases[p] = "null"
    p = str(tmp_path / "lz4.arrow")
    with ipc.new_file(p, schema, options=ipc.IpcWriteOptions(
            compression="lz4")) as w:
        w.write_batch(batch)
    cases[p] = "compress"
    p = str(tmp_path / "f64.arrow")
    b64, s64 = _pa_batch(ids, x.astype(np.float64), item=pa.float64())
    with ipc.new_file(p, s64) as w:
        w.write_batch(b64)
    cases[p] = "schema"
    p = str(tmp_path / "dict.arrow")
    dschema = pa.schema([("id", pa.dictionary(pa.int32(), pa.uint64())),
                         ("vector", pa.list_(pa.float32()))])
    with ipc.new_file(p, dschema) as w:
        w.write_batch(pa.record_batch(
            [pa.array(ids).dictionary_encode(), batch.column(1)],
            schema=dschema))
    cases[p] = "dictionar"
    p = str(tmp_path / "not_arrow.arrow")
    with open(p, "wb") as f:
        f.write(b"plain bytes, not an Arrow file")
    cases[p] = "not an Arrow"
    for path, reason in cases.items():
        with pytest.raises(ValueError, match=reason):
            ArrowStorage.read_vectors(path)
    with pytest.raises(ValueError, match="schema"):
        ArrowStorage.read_codes(str(tmp_path / "f64.arrow"))


# --------------------------------------------------------------------------- #
# snapshots across the packages
# --------------------------------------------------------------------------- #

def _clustered(rng, n):
    centers = 2.0 * rng.standard_normal((NLIST, DIM)).astype(np.float32)
    return (centers[rng.integers(0, NLIST, n)]
            + rng.standard_normal((n, DIM))).astype(np.float32)


def _jax_search(jidx, q, p):
    """The JAX index's search through its Pallas grouped kernel in
    interpret mode (fp32-exact on every arena dtype)."""
    orig = pallas_scan.scan_probed_lists_pallas_grouped
    pallas_scan.scan_probed_lists_pallas_grouped = functools.partial(
        orig, interpret=True)
    try:
        jidx.config.scan_impl = "pallas_grouped"
        return jidx.search(q, JParams(**p))
    finally:
        pallas_scan.scan_probed_lists_pallas_grouped = orig


@pytest.mark.parametrize("dtype,remove", [
    ("int8", False), ("bfloat16", False), ("float32", False), ("int8", True)])
def test_ivf_flat_snapshots_cross_both_ways(tmp_path, rng, dtype, remove):
    """A JAX save loads in the port and searches like the JAX package's
    own load of it; a port save loads in the JAX package and searches like
    the port index it was saved from (both packages requantize the saved
    rows with the same per-row math, so the codes come back equal)."""
    x = _clustered(rng, 2000)
    ids = np.arange(2000, dtype=np.uint64) * 3 + 1
    q = x[:12] + 0.3 * rng.standard_normal((12, DIM)).astype(np.float32)
    atol = 1e-5 * (q * q).sum(1)
    p = dict(nprobe=4, k=10)
    jidx = JFlatIndex(JFlatConfig(dimension=DIM, nlist=NLIST, dtype=dtype,
                                  train_iters=8))
    jidx.train(x)
    jidx.add(x, ids)
    if remove:
        jidx.remove_ids(ids[::4])
    jidx.calibrated_nprobe = 3
    jidx.save(str(tmp_path / "j"))
    tidx = IVFFlatIndex.load(str(tmp_path / "j"), device="cpu")
    jback = JFlatIndex.load(str(tmp_path / "j"))
    assert tidx.ntotal == jback.ntotal == (1500 if remove else 2000)
    assert tidx.calibrated_nprobe == 3 and tidx.arena.capacity == \
        jback.arena.capacity
    np.testing.assert_array_equal(tidx.arena.ids, jback.arena.ids)
    got = tidx.search(q, SearchParams(**p))
    assert_topk_match(*got, *_jax_search(jback, q, p), rtol=1e-5, atol=atol)
    if remove:
        assert not np.isin(got[1], ids[::4]).any()
    # the port saves, the JAX package loads
    tidx.remove_ids(ids[1::5])
    tidx.save(str(tmp_path / "t"))
    jload = JFlatIndex.load(str(tmp_path / "t"))
    assert jload.ntotal == tidx.ntotal
    assert_topk_match(*_jax_search(jload, q, p),
                      *tidx.search(q, SearchParams(**p)), rtol=1e-5,
                      atol=atol)
    if dtype == "int8":
        np.testing.assert_array_equal(
            np.asarray(jload.arena.arena)[tidx.arena.ids != 2**64 - 1],
            tidx.arena.arena.numpy()[tidx.arena.ids != 2**64 - 1])


def test_store_residuals_survive_the_round_trip(tmp_path, rng):
    """A residual index saves ``stored + lo`` and marks it; the load
    rebuilds the lo plane, so reranked searches come back equal. The JAX
    package loads the same snapshot (it requantizes the better rows)."""
    x = _clustered(rng, 2000)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=NLIST,
                                     dtype="int8", store_residuals=True,
                                     train_iters=8), device="cpu")
    idx.train(x)
    idx.build_from_device(torch.from_numpy(x))
    idx.remove_ids(np.arange(0, 2000, 7))
    path = str(tmp_path / "res")
    idx.save(path)
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["extra"]["store_residuals"] is True
    back = IVFFlatIndex.load(path, device="cpu")
    assert back.config.store_residuals and back.arena.arena_lo is not None
    q = x[:12] + 0.3 * rng.standard_normal((12, DIM)).astype(np.float32)
    p = SearchParams(nprobe=4, k=10, use_exact_rerank=True)
    assert_topk_match(*back.search(q, p), *idx.search(q, p), rtol=1e-5,
                      atol=1e-5 * (q * q).sum(1))
    # the saved rows are x to bf16-of-residual precision, not the stored x̂
    sids, rows = ArrowStorage.read_vectors(os.path.join(path,
                                                        "vectors.arrow"))
    err = np.abs(rows - x[sids.astype(np.int64)]).max()
    assert err < 1e-3
    jidx = JFlatIndex.load(path)
    assert jidx.ntotal == back.ntotal


def test_load_through_the_append_path_equals_from_host(tmp_path, rng):
    """The device-append load writes the codes, scales, ids and counts
    that ``PackedListArena.from_host`` makes of the padded rows."""
    x = _clustered(rng, 1500)
    jidx = JFlatIndex(JFlatConfig(dimension=DIM, nlist=NLIST, dtype="int8",
                                  train_iters=8))
    jidx.train(x)
    jidx.add(x)
    path = str(tmp_path / "snap")
    jidx.save(path)
    loaded = IVFFlatIndex.load(path, device="cpu").arena
    st = jidx.state_arrays()
    ref = PackedListArena.from_host(
        st["arena"], st["counts"], st["ids"], "int8",
        anchors=st["centroids"], device="cpu")
    np.testing.assert_array_equal(loaded.arena.numpy(), ref.arena.numpy())
    live = np.arange(ref.capacity)[None, :] < st["counts"][:, None]
    # (from_host also gives padded slots a scale, 1e-12 / 127; unread)
    np.testing.assert_array_equal(loaded.arena_scale.numpy()[live],
                                  ref.arena_scale.numpy()[live])
    np.testing.assert_array_equal(loaded.ids, ref.ids)
    np.testing.assert_array_equal(loaded.counts.numpy(), ref.counts.numpy())
    np.testing.assert_allclose(loaded.arena_sq.numpy(), ref.arena_sq.numpy(),
                               rtol=1e-5, atol=1e-4)
    assert loaded.counts_max == ref.counts_max


def test_host_load_serves_the_streaming_tier_like_the_resident_index(
        tmp_path, rng):
    from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
        load_ivf_flat_host,
    )

    x = rng.standard_normal((1500, DIM)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=NLIST,
                                     dtype="float32"), device="cpu")
    idx.train(x)
    idx.add(x, ids=np.arange(1500, dtype=np.uint64) * 7)
    path = str(tmp_path / "snap-host")
    idx.save(path)
    store, centroids, cfg, cap = load_ivf_flat_host(path)
    assert store.total() == 1500 and cap == idx.arena.capacity
    tier = StreamingIVFFlatIndex.from_store(store, centroids, cfg,
                                            cache_slots=4, capacity=cap,
                                            device="cpu")
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    p = SearchParams(nprobe=NLIST, k=10)
    assert_topk_match(*tier.search(q, p), *idx.search(q, p), rtol=1e-5,
                      atol=1e-5 * (q * q).sum(1))


def _pq_kw(keep_raw, opq):
    return dict(dimension=DIM, nlist=NLIST, m=4, keep_raw=keep_raw, opq=opq,
                opq_iters=2, train_iters=8, pq_train_sample=1024,
                raw_dtype="float32")


@pytest.mark.parametrize("keep_raw,opq", [(True, False), (False, False),
                                          (True, True)])
def test_ivf_pq_snapshots_cross_both_ways(tmp_path, rng, keep_raw, opq):
    """IVF-PQ with and without raw rows, and OPQ: a JAX save (no frame
    marker) loads in the port as original-frame rows and searches like
    the JAX package's own load; a port save writes the marker and loads
    in the JAX package, searching like the port index."""
    x = _clustered(rng, 2000)
    q = x[:10] + 0.3 * rng.standard_normal((10, DIM)).astype(np.float32)
    atol = 1e-5 * (q * q).sum(1)
    jidx = JPQIndex(JPQConfig(scan_impl="xla", **_pq_kw(keep_raw, opq)))
    jidx.train(x)
    jidx.add(x)
    jidx.remove_ids(np.arange(0, 2000, 9, dtype=np.uint64))
    jsnap.save_ivf_pq(str(tmp_path / "j"), jidx)
    tidx = IVFPQIndex.load(str(tmp_path / "j"), device="cpu")
    jback = JPQIndex.load(str(tmp_path / "j"))
    jback.config.scan_impl = "xla"
    tidx.config.scan_impl = "xla"
    assert (tidx.raw is None) == (not keep_raw)
    assert (tidx.opq_R is not None) == opq
    np.testing.assert_array_equal(tidx.ids, jback.ids)
    np.testing.assert_array_equal(tidx.code_arena_t.numpy(),
                                  np.asarray(jback.code_arena_t))
    for rr in ((False, True) if keep_raw else (False,)):
        p = dict(nprobe=4, k=10, use_exact_rerank=rr)
        assert_topk_match(*tidx.search(q, SearchParams(**p)),
                          *jback.search(q, JParams(**p)), rtol=1e-5,
                          atol=atol)
    tidx.remove_ids(np.arange(1, 2000, 9, dtype=np.uint64))
    tidx.save(str(tmp_path / "t"))
    with open(tmp_path / "t" / "manifest.json") as f:
        extra = json.load(f)["extra"]
    assert extra["keep_raw"] == keep_raw
    assert extra.get("raw_frame") == ("original" if keep_raw else None)
    jload = JPQIndex.load(str(tmp_path / "t"))
    jload.config.scan_impl = "xla"
    for rr in ((False, True) if keep_raw else (False,)):
        p = dict(nprobe=4, k=10, use_exact_rerank=rr)
        assert_topk_match(*jload.search(q, JParams(**p)),
                          *tidx.search(q, SearchParams(**p)), rtol=1e-5,
                          atol=atol)


def test_pq_host_rows_and_the_frame_marker(tmp_path, rng):
    """``save_ivf_pq(host_rows=...)`` writes original-frame rows matched
    by id and marks them; the JAX capacity loader reads them; a snapshot
    whose marker names another frame is refused."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
        load_ivf_pq,
        save_ivf_pq,
    )

    x = _clustered(rng, 1500)
    ids = np.arange(1500, dtype=np.uint64) * 5 + 2
    idx = IVFPQIndex(IVFPQConfig(**_pq_kw(False, True)), device="cpu")
    idx.train(x)
    idx.add(x, ids)
    path = str(tmp_path / "cap")
    perm = rng.permutation(1500)
    save_ivf_pq(path, idx, host_rows=(x[perm], ids[perm]))
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["extra"]["host_rows"] and man["extra"]["raw_frame"] == \
        "original"
    sids, rows = ArrowStorage.read_vectors(os.path.join(path,
                                                        "vectors.arrow"))
    np.testing.assert_array_equal(rows, x[((sids - 2) // 5).astype(int)])
    jcap = jsnap.load_ivf_pq_capacity(path, rerank_k=32)
    d, got = jcap.search(x[:5], JParams(nprobe=NLIST, k=1,
                                        use_exact_rerank=True))
    assert (got[:, 0] == ids[:5]).all()
    man["extra"]["raw_frame"] = "rotated"
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="frame"):
        load_ivf_pq(path, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        snapshot.load_ivf_flat(path, device="cpu")
