"""PyTorch port, per-list shards and the reader (``storage/shard_store.py``)
and the access-pattern prefetcher (``io_host/prefetcher.AdaptivePrefetcher``)
against the JAX package's: shards written by either package read by the
other, ``compact`` alike, aligned reads of the same bytes, the same
classification of offset streams (CPU)."""

import filecmp
import os

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine_tpu.io_host import (
    prefetcher as jpf,
)
from cuda_acceleratedvectordatabaseengine_tpu.storage import (
    shard_store as jss,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
    AccessPattern,
    AdaptivePrefetcher,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
    AlignedReader,
    ShardManager,
)

DIM = 12
PACKAGES = {"jax": (jss.ShardManager, jss.AlignedReader),
            "port": (ShardManager, AlignedReader)}


def _write(manager_cls, base, rng, code_width):
    """Two appends to lists 3 and 17, an empty list 5; returns what went
    in, per list."""
    mgr = manager_cls(str(base), DIM, code_width=code_width)
    mgr.create_shard(5)
    want = {}
    for list_id, sizes in ((3, (4, 6)), (17, (7, 1))):
        parts = []
        for n in sizes:
            ids = rng.integers(0, 1 << 40, n).astype(np.uint64)
            vec = rng.standard_normal((n, DIM)).astype(np.float32)
            codes = (rng.integers(0, 256, (n, code_width)).astype(np.uint8)
                     if code_width else None)
            mgr.append(list_id, ids, vec, codes)
            parts.append((ids, vec, codes))
        want[list_id] = tuple(
            np.concatenate([p[i] for p in parts]) if parts[0][i] is not None
            else None for i in range(3))
    want[5] = (np.empty(0, np.uint64), np.empty((0, DIM), np.float32),
               np.empty((0, code_width), np.uint8) if code_width else None)
    return want


@pytest.mark.parametrize("code_width", [0, 8])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_shards_cross_read(tmp_path, rng, writer, reader, code_width):
    """The same file layout: each package reads the other's shards, memory
    mapped and read whole, and writes the same bytes for the same rows."""
    want = _write(PACKAGES[writer][0], tmp_path / "w", rng, code_width)
    other = PACKAGES[reader][0](str(tmp_path / "w"), DIM, code_width)
    assert other.list_shards() == [3, 5, 17]
    for list_id, (ids, vec, codes) in want.items():
        assert other.num_vectors(list_id) == len(ids)
        for mmap in (True, False):
            got = other.load(list_id, mmap=mmap)
            np.testing.assert_array_equal(got[0], ids)
            np.testing.assert_array_equal(got[1], vec)
            if code_width:
                np.testing.assert_array_equal(got[2], codes)
            else:
                assert got[2] is None
    # the other package writes the same rows into the same bytes
    again = PACKAGES[reader][0](str(tmp_path / "r"), DIM, code_width)
    for list_id, (ids, vec, codes) in want.items():
        again.create_shard(list_id)
        if len(ids):
            again.append(list_id, ids, vec, codes)
    names = sorted(os.listdir(tmp_path / "w"))
    assert names == sorted(os.listdir(tmp_path / "r"))
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "w", tmp_path / "r", names, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("code_width", [0, 8])
def test_compact_matches_jax(tmp_path, rng, code_width):
    """``compact`` drops the same rows and leaves the same files."""
    seed = int(rng.integers(1 << 30))
    for name, (mgr_cls, _) in PACKAGES.items():
        _write(mgr_cls, tmp_path / name, np.random.default_rng(seed),
               code_width)
    mine = ShardManager(str(tmp_path / "port"), DIM, code_width)
    theirs = jss.ShardManager(str(tmp_path / "jax"), DIM, code_width)
    ids3 = mine.load(3)[0]
    drop = {int(ids3[0]), int(ids3[5]), 12345}
    assert mine.compact(3, drop) == theirs.compact(3, drop) == 8
    assert mine.compact(5, drop) == theirs.compact(5, drop) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax", names, shallow=False)
    assert not mismatch and not errors
    kept = mine.load(3)[0]
    assert not np.isin(kept.astype(np.int64), list(drop)).any()


def test_aligned_reader_reads_equal_bytes(tmp_path, rng):
    """Unaligned offsets and sizes, across 4 KiB pages and past the end:
    the same bytes as the file and as the JAX package's reader; the async
    path hands them to its callback."""
    blob = rng.integers(0, 256, 3 * 4096 + 123).astype(np.uint8).tobytes()
    path = str(tmp_path / "blob")
    with open(path, "wb") as f:
        f.write(blob)
    mine, theirs = AlignedReader(), jss.AlignedReader()
    try:
        for off, size in ((0, 10), (4095, 2), (100, 5000), (12000, 500),
                          (4096, 4096), (len(blob) - 3, 3)):
            got = mine.read_aligned(path, off, size)
            assert got == blob[off:off + size]
            assert got == theirs.read_aligned(path, off, size)
        seen = []
        fut = mine.read_async(path, 10, 20, callback=seen.append)
        mine.prefetch(path)
        mine.wait_all()
        assert fut.result() == blob[10:30] and seen == [blob[10:30]]
    finally:
        mine.close()
        theirs.close()


def test_aligned_reader_prefetches_like_jax(tmp_path):
    """A sequential reader: both packages' adaptive prefetchers issue the
    same number of readahead prefetches; without ``adaptive`` none."""
    path = str(tmp_path / "blob")
    with open(path, "wb") as f:
        f.write(b"\0" * (64 * 4096))
    counts = []
    for cls in (AlignedReader, jss.AlignedReader):
        reader = cls()
        try:
            for i in range(10):
                reader.read_aligned(path, i * 4096, 4096)
            reader.wait_all()
            counts.append(reader.adaptive.prefetches_issued)
        finally:
            reader.close()
    assert counts[0] == counts[1] > 0
    plain = AlignedReader(adaptive=False)
    try:
        assert plain.adaptive is None
        plain.read_aligned(path, 0, 10)
    finally:
        plain.close()


class _Recorder:
    def __init__(self):
        self.calls = []

    def prefetch(self, path, offset, size):
        self.calls.append((path, offset, size))


def _stream(kind, rng):
    if kind == "sequential":
        return [i * 4096 for i in range(20)]
    if kind == "strided":
        return [i * 5 * (1 << 20) for i in range(20)]
    if kind == "random":
        return rng.integers(0, 1 << 30, 20).tolist()
    if kind == "backwards":
        return [(40 - i) * 4096 for i in range(20)]
    if kind == "short":
        return [0, 4096, 8192]
    # mixed: a sequential run, a jump, then strided steps
    return ([i * 4096 for i in range(6)] + [1 << 30]
            + [(1 << 30) + i * (3 << 20) for i in range(1, 10)])


@pytest.mark.parametrize("kind", ["sequential", "strided", "random",
                                  "backwards", "short", "mixed"])
def test_adaptive_prefetcher_classifies_like_jax(rng, kind):
    """Offset by offset, the same (pattern, stride, consistency) and the
    same prefetch requests as the JAX package's classifier."""
    offsets = _stream(kind, rng)
    mine_r, theirs_r = _Recorder(), _Recorder()
    mine = AdaptivePrefetcher(reader=mine_r)
    theirs = jpf.AdaptivePrefetcher(reader=theirs_r)
    seen = set()
    for off in offsets:
        mine.record_access("f", off)
        theirs.record_access("f", off)
        pat, stride, cons = mine.classify("f")
        jpat, jstride, jcons = theirs.classify("f")
        assert (pat.value, stride, cons) == (jpat.value, jstride, jcons)
        seen.add(pat)
    assert mine_r.calls == theirs_r.calls
    assert mine.prefetches_issued == theirs.prefetches_issued
    expect = {"sequential": AccessPattern.SEQUENTIAL,
              "strided": AccessPattern.STRIDED,
              "random": AccessPattern.RANDOM,
              "short": AccessPattern.RANDOM}
    if kind in expect:
        assert mine.classify("f")[0] == expect[kind]
    if kind == "mixed":
        assert {AccessPattern.SEQUENTIAL, AccessPattern.STRIDED} <= seen
    assert mine.classify("other")[0] == AccessPattern.RANDOM
