"""PyTorch port, the streaming tier's harness (``tools/streaming_bench.py``)
on the CPU against the JAX system's ``scripts/dev_streaming_bench.py``:
the store directory is one layout both ways (the port serves the JAX
script's store and truth, the JAX script serves the port's, with equal
probe unions, recall and warm hit rate), the port's own build stores every
row once, in its list and within its quantization step, and the JSON
lines carry the same keys."""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.kmeans import (
    kmeans_assign,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (
    streaming_bench as sb,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N = 20_000
FLAGS = ["--n", str(N), "--dim", "32", "--nlist", "64", "--nprobe", "8",
         "--batch", "64", "--n-batches", "3", "--hot-clusters", "4",
         "--cache-frac", "0.5"]
BATCH, K = 64, 10
# Recall over one store, one truth and one query batch: the two packages'
# scans may order an entry tied at the k-th distance differently; each
# such tie moves recall by 1/(B·k). Allowed: 2 tied entries, plus the
# JAX line's rounding to 4 decimals.
RECALL_TOL = 2 / (BATCH * K) + 5e-5
HIT_RATE_TOL = 0.02
PORT_CHUNK_ROWS = 8_000          # the port's build in 3 chunks


def jax_script(name):
    """``scripts/<name>.py``, loaded as a module (its ``main`` reads
    ``sys.argv``)."""
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name, argv) -> list[dict]:
    """The JSON lines of the JAX script ``name`` run in this process."""
    mod = jax_script(name)
    saved, out = sys.argv, io.StringIO()
    sys.argv = [f"{name}.py", *argv]
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            mod.main()
    finally:
        sys.argv = saved
    return [json.loads(s) for s in out.getvalue().strip().splitlines()]


def run_port(main, argv) -> list[dict]:
    """The JSON lines of a port tool's ``main(argv)`` on the CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert main([*argv, "--device", "cpu"]) == 0
    return [json.loads(s) for s in out.getvalue().strip().splitlines()]


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A store directory written by the JAX script, and its line."""
    sd = tmp_path_factory.mktemp("jax_store")
    line = run_jax("dev_streaming_bench", FLAGS + ["--store-dir", str(sd)])
    return sd, line[-1]


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    """A store directory written by the port in 3 chunks, and its line."""
    sd = tmp_path_factory.mktemp("port_store")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sb, "CHUNK_ROWS", PORT_CHUNK_ROWS)
        line = run_port(sb.main, FLAGS + ["--store-dir", str(sd)])
    return sd, line[-1]


def assert_same_serving(got, want):
    assert got["workload_probe_union_lists"] == want[
        "workload_probe_union_lists"]
    assert got["cache_slots"] == want["cache_slots"]
    assert abs(got["recall_at_10"] - want["recall_at_10"]) <= RECALL_TOL
    assert abs(got["hit_rate_warm"] - want["hit_rate_warm"]) <= HIT_RATE_TOL


def test_port_serves_the_jax_store(jax_dir):
    """The port's tool on the JAX script's own store and truth: the same
    probe union (over more lists than the cache holds), recall and warm
    hit rate."""
    sd, want = jax_dir
    got = run_port(sb.main, FLAGS + ["--store-dir", str(sd)])[-1]
    assert want["workload_probe_union_lists"] > want["cache_slots"]
    assert_same_serving(got, want)


def test_jax_script_serves_the_port_store(port_dir):
    """The JAX script on the port's store and truth: the port's union,
    recall and warm hit rate."""
    sd, want = port_dir
    got = run_jax("dev_streaming_bench", FLAGS + ["--store-dir", str(sd)])
    assert_same_serving(got[-1], want)


def test_port_build_stores_each_row_once_in_its_list(port_dir):
    """Every id once, the counts summing to n, each list's rows in id
    order (the JAX script's chunk-by-chunk stable packing), each row in
    the list of its nearest stored centroid, and each stored row within
    half its scale of the regenerated row in every coordinate."""
    sd, _ = port_dir
    with np.load(sd / "meta.npz") as meta:
        counts, offsets = meta["counts"], meta["offsets"]
        ids, scale = meta["ids"], meta["scale"]
        centroids = meta["centroids"]
        maker = str(meta["maker"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sb, "CHUNK_ROWS", PORT_CHUNK_ROWS)
        assert maker == sb.store_maker("cpu")
    assert maker != sb.store_maker("cpu") != sb.store_maker("cuda")
    assert counts.sum() == N
    np.testing.assert_array_equal(np.sort(ids), np.arange(N, dtype=np.uint64))
    np.testing.assert_array_equal(offsets[1:], np.cumsum(counts)[:-1])
    lists = np.repeat(np.arange(64), counts)
    for l in range(64):
        seg = ids[offsets[l]:offsets[l] + counts[l]]
        assert (np.diff(seg.astype(np.int64)) > 0).all()
    codes = np.load(sd / "vecs.npy")
    # the generator draws a chunk at a time, seeded by its start
    chunk = sb.corpus(64, 32, torch.device("cpu"))
    rows = torch.cat([chunk(s, min(PORT_CHUNK_ROWS, N - s))
                      for s in range(0, N, PORT_CHUNK_ROWS)]).float()
    order = ids.astype(np.int64)
    assign = kmeans_assign(rows, torch.from_numpy(centroids),
                           Metric.L2).numpy()
    np.testing.assert_array_equal(assign[order], lists)
    deq = centroids[lists] + codes.astype(np.float32) * scale[:, None]
    err = np.abs(deq - rows.numpy()[order])
    assert (err <= scale[:, None] * (0.5 + 1e-4) + 1e-6).all()


def test_json_keys_match_the_jax_line(jax_dir, port_dir):
    want, got = jax_dir[1], port_dir[1]
    assert set(got) - sb.ADDED_KEYS == set(want)
    assert sb.ADDED_KEYS <= set(got)
    assert set(got["hotness_restage"]) == set(want["hotness_restage"])
    assert got["device"] == "cpu" and got["stream_ms_per_batch"] is None


def test_new_workload_over_a_jax_store_is_refused(jax_dir):
    """A truth for another query workload means the oracle over every
    row: over a store the port's generator did not write, that raises
    (the rows would not be the store's)."""
    sd, _ = jax_dir
    flags = [f if f != "4" else "6" for f in FLAGS]   # --hot-clusters 6
    assert flags != FLAGS
    with pytest.raises(ValueError, match="cannot be regenerated"):
        run_port(sb.main, flags + ["--store-dir", str(sd)])


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                       tmp_path):
    assert sb.parse_args([]).device is None
    assert sb.DEFAULT_STORE_DIR.endswith("streamstore_i8_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sb.main(FLAGS + ["--store-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
