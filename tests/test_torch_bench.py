"""PyTorch port, the headline benchmark harness (``tools/bench.py``) on the
CPU against the JAX system's root ``bench.py``: the zipf size table and the
corpus membership are bit-exact, the oracle agrees, and on bench.py's own
``--quick`` corpora (regenerated with its JAX functions and keys) the
port's build and measurement land within the stated tolerances of
``bench.main()``'s JSON, in the balanced, zipf, hierarchical and
zipf + multi-assignment geometries."""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from cuda_acceleratedvectordatabaseengine_tpu.models.ivf_flat import (
    _choose_capacity as j_choose_capacity,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.calibrate import (
    probe_coverage_calibrate,
    true_lists,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import flat_scan
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.kmeans import (
    kmeans_assign_topk,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (
    bench as tbench,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MA_FLAGS = ["--skew", "zipf", "--multi-assign-eps", "0.15",
            "--multi-assign-budget", "0.25", "--capacity-factor", "1.6"]
CASES = {
    "balanced": [],
    "zipf": ["--skew", "zipf"],
    "cpl2": ["--clusters-per-list", "2"],
    "zipf_multi_assign": MA_FLAGS,
}
# Tolerances of the end-to-end parity (the two packages' k-means draw from
# different generators, so the indexes differ; the geometry does not).
RECALL_TOL = 0.02         # recall@10, eps-recall, probe coverage
REPLICATION_TOL = 0.02    # replication factor
NPROBE_STEPS = 1          # auto nprobe: candidate steps apart
# Capacity equal to bench.py's where the flags fix it: the chunked build's
# formula, and the bulk build's floor (1.5 × mean, rounded up to 128) where
# the lists are balanced. The bulk build on zipf sizes clamps at the
# trained quantizer's 1%-spill point instead, which moves by 128-slot
# steps with the k-means seed in either package; there the port's capacity
# must be the JAX package's rule applied to the port's own rank-0 list
# counts.
CAPACITY_FROM_FLAGS = {"balanced", "cpl2", "zipf_multi_assign"}


@pytest.mark.parametrize("n,n_modes,s", [
    (50_000, 128, 1.0), (10_000_000, 4096, 1.0), (1_000_003, 1000, 0.7),
    (777, 777, 1.3)])
def test_zipf_cumulative_matches_bench(n, n_modes, s):
    np.testing.assert_array_equal(tbench.zipf_cumulative(n, n_modes, s),
                                  bench.zipf_cumulative(n, n_modes, s))


# (n_total, start, m): g · 2654435761 passes 2³² from g = 2 on, so every
# start below wraps; the last rows of a 10M corpus reach g ≈ 2³³·1.2
MEMBERSHIP = [(50_000, 0, 700), (10_000_000, 9_999_300, 700),
              (10_000_000, 4_999_650, 700), (1_000_003, 123_456, 700)]


def _jax_rows(start, m, centers, cum, n_total):
    """bench.py's generators at noise 0: each row its mode's center."""
    key = jax.random.PRNGKey(0)
    idx = jnp.arange(m)
    if cum is None:
        out = bench._corpus_gen(key, jnp.int32(start), jnp.asarray(centers),
                                0.0, idx)
    else:
        out = bench._corpus_gen_skew(
            key, jnp.uint32(start), jnp.asarray(centers),
            jnp.asarray(cum, jnp.int64), n_total, 0.0, idx)
    return np.asarray(out).view(np.uint16)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("skew", ["none", "zipf"])
@pytest.mark.parametrize("n_total,start,m", MEMBERSHIP)
def test_membership_is_bitwise_bench(n_total, start, m, skew):
    """Noise 0, the same numpy centers: the port's rows ``[start, start +
    m)`` are bit-equal (bf16) to bench.py's, generated whole and across a
    chunk boundary (chunks of 256 rows, so the range spans three)."""
    rng = np.random.default_rng(start)
    n_modes = 64
    centers = rng.standard_normal((n_modes, 8)).astype(np.float32)
    cum = (bench.zipf_cumulative(n_total, n_modes, 1.0)
           if skew == "zipf" else None)
    want = _jax_rows(start, m, centers, cum, n_total)
    cum_t = torch.from_numpy(cum) if cum is not None else None
    c_t = torch.from_numpy(centers)
    whole = tbench.corpus_chunk(c_t, start, m, 42, 0.0, cum_t, n_total)
    chunked = tbench.clustered_corpus(c_t, m, 42, base=start, skew_cum=cum_t,
                                      n_total=n_total, noise=0.0, chunk=256)
    np.testing.assert_array_equal(_bits(whole), want)
    np.testing.assert_array_equal(_bits(chunked), want)
    if cum is not None:
        # the zipf map really is bench's bucket of the wrapped product
        g = np.arange(start, start + m, dtype=np.uint64)
        r = (g * np.uint64(tbench.HASH_MULT)) % np.uint64(2**32) % np.uint64(
            n_total)
        np.testing.assert_array_equal(
            tbench.row_modes(start, m, n_modes, cum_t, n_total).numpy(),
            np.searchsorted(cum, r.astype(np.int64), side="right"))


def test_skewed_corpus_refuses_a_bad_total():
    for bad in (2**31, 2654435761 * 2, 0):
        with pytest.raises(ValueError):
            tbench.check_skew_total(bad)
    tbench.check_skew_total(10_000_000)


def test_oracle_matches_bench_over_two_chunks(rng):
    """Two chunks at base offsets 0 and 300, several blocks each: distances
    within 1e-5·(1 + |d|), ids equal up to ties."""
    k, dim = 10, 24
    q = rng.standard_normal((40, dim)).astype(np.float32)
    chunks = [(0, rng.standard_normal((300, dim))),
              (300, rng.standard_normal((257, dim)))]
    j_upd = bench.make_oracle_updater(k)
    jd = jnp.full((40, k), jnp.inf, jnp.float32)
    ji = jnp.full((40, k), -1, jnp.int32)
    td = torch.full((40, k), float("inf"))
    ti = torch.full((40, k), -1, dtype=torch.long)
    for base, x in chunks:
        xb = torch.from_numpy(x.astype(np.float32)).bfloat16()
        jd, ji = j_upd(jd, ji, jnp.asarray(q), jnp.asarray(
            xb.float().numpy()).astype(jnp.bfloat16), jnp.int32(base))
        td, ti = tbench.oracle_update(td, ti, torch.from_numpy(q), xb, base,
                                      k, block=64)
    assert_topk_match(td.numpy(), ti.numpy(), np.asarray(jd),
                      np.asarray(ji), rtol=1e-5, atol=1e-5)


def test_oracle_leaves_out_removed_rows(rng):
    q = rng.standard_normal((8, 16)).astype(np.float32)
    x = torch.from_numpy(q[[3, 5]]).bfloat16()
    keep = torch.tensor([False, True])
    d, i = tbench.oracle_update(torch.full((8, 1), float("inf")),
                                torch.full((8, 1), -1, dtype=torch.long),
                                torch.from_numpy(q), x, 100, 1, keep=keep)
    assert (i.numpy() == 101).all()


def test_coverage_counts_either_copy_of_a_replicated_id():
    """The id table's lookup finds both resident copies of a multi-assigned
    id, and the calibration covers it at the earlier copy's coarse rank
    (bench.py's rule under multi-assignment): id 5 sits in lists 1 and 2;
    from the query at 0 they rank 2nd and 1st, so 2 probes cover it
    (the first copy alone would need 3)."""
    table = np.array([[0, INVALID_ID], [1, 5], [5, INVALID_ID], [2, 3]],
                     np.uint64)
    matched, lists = true_lists(table, np.array([[5, 0, 9]]))
    np.testing.assert_array_equal(matched, [[True, True, False]])
    np.testing.assert_array_equal(lists[0, :2], [[1, 2], [0, 0]])
    cal = probe_coverage_calibrate(
        centroids=torch.tensor([[0.0], [10.0], [1.0], [20.0]]),
        metric=Metric.L2, ids_table=table,
        queries=np.zeros((1, 1), np.float32),
        exact_search_fn=lambda q, k: (np.zeros((1, 1)), np.array([[5]])),
        target_coverage=0.99, k=1, candidates=(1, 2, 3))
    assert cal["curve"] == {1: 0.0, 2: 1.0, 3: 1.0, 4: 1.0}
    assert cal["nprobe"] == 2 and not cal["coverage_limited"]


def test_scan_default_ignores_the_environment(monkeypatch):
    """The harness measures K1 unless ``--scan`` says otherwise: no
    environment variable changes what it times."""
    monkeypatch.setenv("VDB_SCAN", "gather")
    assert tbench.parse_args([]).scan == "pallas_grouped"


# --------------------------------------------------------------------------
# end to end against bench.main()
# --------------------------------------------------------------------------

_BENCH_JSON: dict = {}


def bench_json(flags) -> dict:
    """bench.main()'s JSON for ``--quick`` + ``flags`` (cached: one run a
    geometry)."""
    key = tuple(flags)
    if key not in _BENCH_JSON:
        argv = sys.argv
        sys.argv = ["bench.py", "--quick", *flags]
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(io.StringIO()):
                bench.main()
        finally:
            sys.argv = argv
        _BENCH_JSON[key] = json.loads(out.getvalue().strip().splitlines()[-1])
    return _BENCH_JSON[key]


def bench_inputs(args):
    """bench.py's own corpus (numpy fp32 of the bf16 rows) and queries for
    the flags ``args``, from its JAX functions and keys (PRNGKey 42 for the
    rows, 1234 for the centers, 7 for the queries), along the build path
    bench.py takes."""
    cpl = args.clusters_per_list
    n_modes = args.nlist * cpl
    cum = (bench.zipf_cumulative(args.n, n_modes, args.skew_s)
           if args.skew == "zipf" else None)
    ks, ko = jax.random.split(jax.random.PRNGKey(1234))
    centers = jax.random.normal(ks, (args.nlist, args.dim), jnp.float32)
    if cpl > 1:
        centers = centers[jnp.arange(n_modes) // cpl] + 0.4 * (
            jax.random.normal(ko, (n_modes, args.dim), jnp.float32))
    kq1, kq2 = jax.random.split(jax.random.PRNGKey(7))
    qi = np.asarray(jax.random.randint(kq1, (args.batch,), 0, args.n))
    if args.multi_assign_eps > 0:        # the chunked path: one chunk here
        assert args.n <= tbench.CHUNK_ROWS
        _, sub = jax.random.split(jax.random.PRNGKey(42))
        x, _ = bench.clustered_corpus(
            sub, args.n, args.dim, n_clusters=n_modes, noise=0.25,
            centers=centers, base=0, skew_cum=cum, n_total=args.n)
        qi = np.sort(qi)
    else:
        x, _ = bench.clustered_corpus(
            jax.random.PRNGKey(42), args.n, args.dim, n_clusters=n_modes,
            noise=0.25, centers=centers, skew_cum=cum, n_total=args.n)
    x = np.asarray(x.astype(jnp.float32))
    queries = np.asarray(jnp.asarray(x[qi]) + 0.1 * jax.random.normal(
        kq2, (args.batch, args.dim), jnp.float32))
    return x, queries


@pytest.mark.parametrize("case", list(CASES))
def test_quick_geometry_matches_bench(case):
    flags = CASES[case]
    want = bench_json(flags)["detail"]
    args = tbench.parse_args(["--quick", *flags, "--device", "cpu"])
    x, queries = bench_inputs(args)
    keep = {}
    got = tbench.run(
        args, CPU, rows=lambda s, m: torch.from_numpy(x[s:s + m]).bfloat16(),
        queries=queries, keep=keep)["detail"]
    for key in ("recall_at_10", "recall_eps_05", "probe_coverage"):
        assert abs(got[key] - want[key]) <= RECALL_TOL, (key, got, want)
    steps = tbench.NPROBE_CANDIDATES
    assert abs(steps.index(got["nprobe"])
               - steps.index(want["nprobe"])) <= NPROBE_STEPS
    if case in CAPACITY_FROM_FLAGS:
        assert got["capacity_per_list"] == want["capacity_per_list"]
    else:
        idx = keep["index"]
        rank0 = kmeans_assign_topk(torch.from_numpy(x), idx.centroids,
                                   args.assign_choices)[:, 0].numpy()
        counts0 = np.bincount(rank0, minlength=args.nlist)
        assert got["capacity_per_list"] == j_choose_capacity(
            counts0, 128, max_factor=4.0)
    assert got["build"] == ("chunked" if case == "zipf_multi_assign"
                            else "bulk")
    if case == "zipf_multi_assign":
        assert abs(got["replication_factor"]
                   - want["replication_factor"]) <= REPLICATION_TOL
        assert got["rows_with_duplicate_ids"] == 0
    else:
        assert got["replication_factor"] is None
        # the one-shard view serves the same answers
        assert got["mesh1"]["recall_at_10"] == got["recall_at_10"]


def run_main(argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert tbench.main(argv) == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_main_prints_every_bench_key():
    """``main(["--quick", "--device", "cpu"])``: one JSON line holding
    every key bench.py writes (its embedded TPU wire record excepted), the
    host as the device, and no device time measured."""
    got = run_main(["--quick", "--device", "cpu"])
    want = bench_json([])
    assert set(want) == set(got)
    missing = set(want["detail"]) - {"wire"} - set(got["detail"])
    assert not missing, missing
    assert "wire" not in got["detail"]
    assert got["detail"]["device"] == "cpu"
    assert got["detail"]["device_ms_per_batch"] is None
    assert got["detail"]["peak_device_gb"] is None
    assert got["detail"]["recall_at_10"] >= 0.95
    assert got["detail"]["mesh1"]["recall_at_10"] == got["detail"][
        "recall_at_10"]


@pytest.mark.parametrize("scan,dtype", [
    ("pallas", "int8"), ("pallas", "bfloat16"), ("pallas_sorted", "int8"),
    ("ragged", "int8")])
def test_scan_name_is_reported_and_never_swapped(scan, dtype, monkeypatch):
    """The scan asked for runs (its plain version on the CPU) and is the
    one reported: the plain gather scan, bench.py's stand-in off the TPU,
    is never called."""
    def no_gather(*a, **kw):
        raise AssertionError("the gather scan ran")

    monkeypatch.setattr(flat_scan, "scan_probed_lists", no_gather)
    got = run_main(["--quick", "--device", "cpu", "--scan", scan,
                    "--dtype", dtype])["detail"]
    assert got["scan_impl"] == scan
    assert got["mesh1"]["scan_impl"] == scan
    assert got["recall_at_10"] >= 0.95


def test_mesh1_failure_fails_the_run():
    """A failure of the one-shard view is not caught into the artifact:
    the process exits non-zero and prints no result."""
    code = textwrap.dedent("""
        import torch
        torch.set_num_threads(1)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import bench

        class Broken:
            def __init__(self, *a, **kw):
                raise RuntimeError("mesh1 broke")

        bench.ShardedIVFFlatIndex = Broken
        raise SystemExit(bench.main(["--quick", "--device", "cpu"]))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "mesh1 broke" in out.stderr
    assert out.stdout.strip() == ""
