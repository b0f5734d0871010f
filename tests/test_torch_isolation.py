"""PyTorch port, isolation: the package runs without JAX, and its CUDA
build never falls back to a plain path."""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_and_searches_without_jax():
    code = textwrap.dedent("""
        import sys
        import tempfile
        sys.modules["pyarrow"] = None      # the card's machine has none
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import cuda_acceleratedvectordatabaseengine_tpu_torch as vdb
        from cuda_acceleratedvectordatabaseengine_tpu_torch import builder
        from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
            arrow_ipc, arrow_store, manifest, snapshot)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.models import flat
        from cuda_acceleratedvectordatabaseengine_tpu_torch import testing
        from cuda_acceleratedvectordatabaseengine_tpu_torch import io_host
        from cuda_acceleratedvectordatabaseengine_tpu_torch.models import (
            calibrate, convert, ivf_pq)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
            _build, flat_scan, grouped_pq_scan, grouped_scan, kmeans,
            pair_scan, pq, scan, sorted_scan)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.utils import (
            batching)
        from cuda_acceleratedvectordatabaseengine_tpu_torch import parallel
        from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel import (
            mesh, sharded, sharded_streaming)
        x = np.random.default_rng(0).standard_normal((512, 16), np.float32)
        idx = vdb.IVFFlatIndex(vdb.IVFFlatConfig(dimension=16, nlist=8,
                                                 dtype="int8",
                                                 train_iters=3), device="cpu")
        idx.train(x)
        idx.add(x)
        d, ids = idx.search(x[:4], vdb.SearchParams(nprobe=8, k=3))
        assert (ids[:, 0] == np.arange(4)).all(), ids
        for impl in ("pallas_sorted", "pallas"):
            idx.config.scan_impl = impl
            d, ids = idx.search(x[:4], vdb.SearchParams(nprobe=8, k=100))
            assert (ids[:, 0] == np.arange(4)).all(), ids
        tier = io_host.StreamingIVFFlatIndex(idx, cache_slots=4,
                                             scan_impl="pallas_sorted",
                                             device="cpu")
        d, ids = tier.search(x[:4], vdb.SearchParams(nprobe=8, k=3))
        assert (ids[:, 0] == np.arange(4)).all(), ids
        pq_idx = vdb.IVFPQIndex(vdb.IVFPQConfig(dimension=16, nlist=8, m=4,
                                                train_iters=3, opq=True,
                                                opq_iters=1), device="cpu")
        pq_idx.train(x)
        pq_idx.add(x)
        d, ids = pq_idx.search(x[:4], vdb.SearchParams(
            nprobe=8, k=3, use_exact_rerank=True))
        assert (ids[:, 0] == np.arange(4)).all(), ids
        assert pq_idx.remove_ids(np.arange(4)) == 4
        with tempfile.TemporaryDirectory() as tmp:
            pq_idx.save(tmp)
            back = vdb.IVFPQIndex.load(tmp, device="cpu")
            assert back.ntotal == 508 and back.opq_R is not None
        assert idx.remove_ids(np.arange(4)) == 4
        with tempfile.TemporaryDirectory() as tmp:
            idx.save(tmp)
            back = vdb.IVFFlatIndex.load(tmp, device="cpu")
            d, ids = back.search(x[4:8], vdb.SearchParams(nprobe=8, k=3))
            assert (ids[:, 0] == np.arange(4, 8)).all(), ids
        fidx = vdb.FlatIndex(16, device="cpu")
        fidx.add(x)
        assert (fidx.search(x[:4], k=1)[1][:, 0] == np.arange(4)).all()
        built = vdb.IVFFlatIndex(vdb.IVFFlatConfig(dimension=16, nlist=8,
                                                   train_iters=3,
                                                   store_residuals=True),
                                 device="cpu")
        vdb.build_index_chunked(built, [(np.arange(512), x)], 512,
                                train_sample=x)
        d, ids = built.search(x[:4], vdb.SearchParams(
            nprobe=8, k=3, use_exact_rerank=True))
        assert (ids[:, 0] == np.arange(4)).all(), ids
        cpu4 = parallel.make_mesh(devices=["cpu"] * 4)
        view = parallel.ShardedIVFFlatIndex.build_on_mesh(
            cpu4, vdb.IVFFlatConfig(dimension=16, nlist=8, dtype="int8",
                                    train_iters=3), x, chunk_rows=200)
        d, ids = view.search(x[:4], vdb.SearchParams(nprobe=8, k=3))
        assert (ids[:, 0] == np.arange(4)).all(), ids
        stripes = lambda parts: np.concatenate(  # noqa: E731
            [t.numpy() for t in parts], 1)
        carried = convert.sharded_ivf_flat_from_arrays(
            view.config, cpu4, arena_s=stripes(view.arena_s),
            arena_sq_s=stripes(view.arena_sq_s),
            arena_scale=stripes(view.arena_scale),
            anchors=view.arena_anchors[0].numpy(),
            centroids=view.centroids.numpy(), counts=view.counts[0].numpy(),
            ids=view._ids_table, global_cap=view.global_cap)
        assert (carried.search(x[:4], vdb.SearchParams(nprobe=8, k=3))[1]
                == ids).all()
        pq_view = parallel.ShardedIVFPQIndex(pq_idx, cpu4)
        d, ids = pq_view.search(x[4:8], vdb.SearchParams(
            nprobe=8, k=3, use_exact_rerank=True))
        assert (ids[:, 0] == np.arange(4, 8)).all(), ids
        tier = parallel.ShardedStreamingIVFFlatIndex.from_base(
            idx, cpu4, cache_slots=4)
        d, ids = tier.search(x[4:8], vdb.SearchParams(nprobe=8, k=3))
        assert (ids[:, 0] == np.arange(4, 8)).all(), ids
        assert mesh.SHARD_AXIS == "shard" and sharded_streaming
        assert sys.modules["pyarrow"] is None
        assert (grouped_scan.LAUNCHES == grouped_pq_scan.LAUNCHES
                == sorted_scan.LAUNCHES == pair_scan.LAUNCHES == 0)
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m.startswith("cuda_acceleratedvectordatabaseengine_tpu.")
               or m == "cuda_acceleratedvectordatabaseengine_tpu"]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_engine_runs_without_the_wire_and_config_packages():
    """An install without grpc, protobuf, PyYAML, prometheus_client or
    pyarrow: the serving engine imports and runs
    create → add → build → activate → search → remove → restart on the
    CPU, with the production config read by the port's own YAML reader."""
    code = textwrap.dedent("""
        import sys
        import tempfile
        import time
        for name in ("grpc", "google.protobuf", "yaml",
                     "prometheus_client", "pyarrow"):
            sys.modules[name] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from cuda_acceleratedvectordatabaseengine_tpu_torch import (
            SearchParams)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.server import (
            health, service)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.server.config \\
            import ServerConfig
        cfg = ServerConfig.from_yaml("configs/production.yaml")
        assert cfg.warm_nprobes == (8, 32)
        data = tempfile.mkdtemp()
        cfg = cfg.apply_overrides(data_path=data, default_nlist=8,
                                  prefetch_hot_interval_s=0.0,
                                  max_batch_size=8, metrics_enabled=False)
        x = np.random.default_rng(0).standard_normal((400, 16), np.float32)
        ids = np.arange(400, dtype=np.uint64)
        eng = service.VdbEngine(cfg, device="cpu")
        eng.create_index("docs", 16, "L2", 8, 0, 0)
        eng.add_vectors("docs", x, ids)
        eid = eng.build_epoch("docs")
        while not eng.build_jobs["docs"].done:
            time.sleep(0.02)
        assert not eng.build_jobs["docs"].error, eng.build_jobs["docs"].error
        eng.activate_epoch("docs", eid)
        p = SearchParams(nprobe=8, k=3)
        def serve(engine, q):
            t0 = time.monotonic()
            fut = engine.submit_search(engine.get_state("docs"), q, p)
            return engine.finish_search(fut, "docs", t0, len(q))
        d, got = serve(eng, x[:4])
        assert (got[:, 0] == ids[:4]).all(), got
        assert eng.remove_vectors("docs", ids[:2]) == (2, 398)
        text = eng.metrics.prometheus_text().decode()
        assert "vdb_searches_total" in text
        eng.close()
        again = service.VdbEngine(cfg, device="cpu")
        d, got = serve(again, x[:4])
        assert not np.isin(got, ids[:2]).any() and (got[2:, 0] ==
                                                    ids[2:4]).all()
        assert health.device_usable("cpu")
        again.close()
        for name in ("grpc", "google.protobuf", "yaml", "prometheus_client",
                     "pyarrow"):
            assert sys.modules[name] is None
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m.startswith("cuda_acceleratedvectordatabaseengine_tpu.")
               or m == "cuda_acceleratedvectordatabaseengine_tpu"]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: the build helper raises instead of handing back a plain
    fallback (it is called directly; no GPU is needed)."""
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setenv("CUDA_HOME", str(empty))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library(build_root=tmp_path / "kernels")
    assert not any((tmp_path / "kernels").rglob("*.so"))


def test_default_device_is_the_card():
    """An index built without a device runs on "cuda"; where there is no
    CUDA the call raises instead of running on the host."""
    import torch

    import cuda_acceleratedvectordatabaseengine_tpu_torch as vdb
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
        PackedListArena,
    )

    makers = [
        lambda: vdb.IVFFlatIndex(vdb.IVFFlatConfig(dimension=8, nlist=4)),
        lambda: vdb.IVFPQIndex(vdb.IVFPQConfig(dimension=8, nlist=4, m=2)),
        lambda: PackedListArena.create(4, 8),
        lambda: vdb.HbmListCache(2, 128, 8),
    ]
    for make in makers:
        if torch.cuda.is_available():
            obj = make()
            dev = getattr(obj, "device", None) or obj.arena.device
            assert torch.device(dev).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


def test_kernel_sources_are_hashed(tmp_path, monkeypatch):
    srcs = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert srcs == ["full_row_scan.cu", "grouped_pq_scan.cu",
                    "grouped_scan.cu"]
    assert (_build.CSRC / "grouped_common.cuh").is_file()
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    # an edited header changes the hash (and so rebuilds) like a source
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.source_hash() == h
    with open(csrc / "grouped_common.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.source_hash() != h


def _c_prototypes():
    """``{name: (argument kinds, result kind)}`` of every exported function
    in ``csrc/*.cu`` (``p`` a pointer, ``i`` an int)."""
    import re

    protos = {}
    for src in _build.CSRC.glob("*.cu"):
        body = src.read_text().split('extern "C" {', 1)[1]
        for res, name, params in re.findall(
                r"^(int|void\*?)\s+(vdb_\w+)\(([^)]*)\)\s*\{", body, re.M):
            kinds = "".join("p" if "*" in a else "i"
                            for a in params.split(",") if a.strip())
            protos[name] = (kinds, "p" if "*" in res else "i")
    return protos


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_the_c_prototype(name):
    """The ctypes declaration of each kernel entry point takes the
    arguments its C prototype takes: a mismatch would pass garbage to the
    kernel on the card, where no CPU test reaches."""
    assert _c_prototypes()[name] == _build.SIGNATURES[name]


def test_every_c_entry_point_is_declared():
    assert set(_c_prototypes()) == set(_build.SIGNATURES)


def test_tools_native_profiling_and_shards_import_without_jax():
    """The modules of the tools slice import and run with JAX and the JAX
    package made unimportable: the native runtime reranks, a shard
    round-trips, a traced block runs, and ``build_index`` and ``autotune``
    build and tune a snapshot on the CPU."""
    code = textwrap.dedent("""
        import contextlib
        import io
        import json
        import sys
        import tempfile
        for name in ("jax", "jaxlib",
                     "cuda_acceleratedvectordatabaseengine_tpu"):
            sys.modules[name] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from cuda_acceleratedvectordatabaseengine_tpu_torch import native
        from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
            AdaptivePrefetcher, HostListStore, HostReranker)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance \\
            import Metric
        from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
            shard_store)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (
            autotune, benchmark, build_index, load_test, recall_test)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.utils import (
            profiling)
        x = np.random.default_rng(0).standard_normal((64, 16), np.float32)
        ids = np.arange(64, dtype=np.uint64)
        store = HostListStore.from_assignments(
            x, ids, np.arange(64) % 4, 4, dtype="int8",
            anchors=np.zeros((4, 16), np.float32))
        rr = HostReranker(store)
        d, got = rr.rerank(x[:3], ids[None, :10].repeat(3, 0), Metric.L2, 2)
        assert (got[:, 0] == ids[:3]).all() and rr.native_batches == 1
        np.testing.assert_array_equal(native.gather_rows(x, [3]), x[3:4])
        with tempfile.TemporaryDirectory() as tmp:
            mgr = shard_store.ShardManager(tmp, 16)
            mgr.append(7, ids, x)
            np.testing.assert_array_equal(mgr.load(7)[1], x)
            snap = tmp + "/snap"
            with contextlib.redirect_stdout(io.StringIO()):
                assert build_index.main([
                    "--synthetic", "600", "--dimension", "8", "--nlist", "4",
                    "--output", snap, "--device", "cpu"]) == 0
                assert autotune.main(["--snapshot", snap, "--sample", "32",
                                      "--device", "cpu", "--output",
                                      tmp + "/t.json"]) == 0
            assert json.load(open(tmp + "/t.json"))["ntotal"] == 600
        with profiling.trace("vdb.isolated"):
            torch.ones(2).sum()
        assert AdaptivePrefetcher().classify("f")[1] == 0
        assert load_test.parse_stage_metrics("") == {}
        bad = [m for m in sys.modules if (m == "jax" or m.startswith("jax.")
               or m.startswith("cuda_acceleratedvectordatabaseengine_tpu."))
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _native_prototypes():
    """``{name: (argument kinds, result kind)}`` of every exported function
    in ``native/vdbhost.cc``, in the kinds of ``native.SIGNATURES``."""
    import re

    from cuda_acceleratedvectordatabaseengine_tpu_torch import native

    def kind(decl):
        if "*" in decl:
            return "s" if "char" in decl else "p"
        return {"int32_t": "i", "int64_t": "l", "size_t": "z",
                "void": "v"}[decl.split()[0]]

    protos = {}
    for body in native.SOURCE.read_text().split('extern "C" {')[1:]:
        for res, name, params in re.findall(
                r"^(void\*?|int32_t)\s+(vdb_\w+)\(([^)]*)\)\s*\{",
                body, re.M):
            args = "".join(kind(a) for a in params.split(",") if a.strip())
            protos[name] = (args, kind(res))
    return protos


def _native_names():
    from cuda_acceleratedvectordatabaseengine_tpu_torch import native

    return sorted(native.SIGNATURES)


@pytest.mark.parametrize("name", _native_names())
def test_native_ctypes_signature_matches_the_c_prototype(name):
    """The ctypes declaration of each native entry point takes the
    arguments its ``extern "C"`` prototype in ``vdbhost.cc`` takes."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch import native

    assert _native_prototypes()[name] == native.SIGNATURES[name]


def test_every_native_entry_point_is_declared():
    from cuda_acceleratedvectordatabaseengine_tpu_torch import native

    assert set(_native_prototypes()) == set(native.SIGNATURES)
    assert len(native.SIGNATURES) == 8


def test_native_without_compiler_raises(tmp_path, monkeypatch, rng):
    """No ``g++`` and no library built: ``use_native=True`` raises
    ``RuntimeError`` (at construction, before any search), so does every
    native entry point; ``use_native=False`` still serves the numpy path.
    Nothing falls back."""
    import numpy as np

    from cuda_acceleratedvectordatabaseengine_tpu_torch import native
    from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
        HostListStore,
        HostReranker,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
        Metric,
    )

    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "native")
    native.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native.find_compiler()
        x = rng.standard_normal((40, 8)).astype(np.float32)
        ids = np.arange(40, dtype=np.uint64)
        store = HostListStore.from_assignments(x, ids, np.arange(40) % 2, 2,
                                               dtype="float32")
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            HostReranker(store)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            HostReranker(store, use_native=True)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native.gather_rows(x, np.arange(3))
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native.rerank(x, np.zeros((1, 2), np.int64),
                          np.zeros((1, 2), np.uint64), x[:1], None, 1, 1)
        assert not native.available()
        rr = HostReranker(store, use_native=False)
        d, got = rr.rerank(x[:2], ids[None, :5].repeat(2, 0), Metric.L2, 1)
        assert (got[:, 0] == ids[:2]).all()
        assert (rr.native_batches, rr.numpy_batches) == (0, 1)
        # the numpy path was chosen by the flag: switching the flag on now
        # raises instead of falling back
        rr.use_native = True
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            rr.rerank(x[:2], ids[None, :5].repeat(2, 0), Metric.L2, 1)
        assert not (tmp_path / "native").exists()
    finally:
        native.load_library.cache_clear()


def test_bench_harness_runs_without_jax():
    """``tools/bench`` imports and runs its ``--quick`` cut on the CPU with
    JAX, the JAX package and the JAX system's root ``bench.py`` made
    unimportable, and prints its one JSON line."""
    code = textwrap.dedent("""
        import contextlib
        import io
        import json
        import sys
        for name in ("jax", "jaxlib", "bench",
                     "cuda_acceleratedvectordatabaseengine_tpu"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import bench
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert bench.main(["--quick", "--device", "cpu"]) == 0
        result = json.loads(out.getvalue())
        assert result["detail"]["recall_at_10"] >= 0.95, result
        bad = [m for m in sys.modules if (m == "jax" or m.startswith("jax.")
               or m.startswith("cuda_acceleratedvectordatabaseengine_tpu."))
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_tier_tools_run_without_jax(tmp_path):
    """``tools/streaming_bench``, ``tools/pq_capacity`` and
    ``tools/pq_sweep`` import and run a tiny cut on the CPU with JAX, the
    JAX package and the root ``bench.py`` made unimportable: the streaming
    harness writes a store, the capacity harness reranks from it, and each
    prints its JSON lines."""
    code = textwrap.dedent(f"""
        import contextlib
        import io
        import json
        import sys
        for name in ("jax", "jaxlib", "bench",
                     "cuda_acceleratedvectordatabaseengine_tpu"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (
            pq_capacity, pq_sweep, streaming_bench)
        geometry = ["--n", "6000", "--dim", "16", "--nlist", "16",
                    "--nprobe", "4", "--batch", "16", "--n-batches", "1",
                    "--device", "cpu"]
        store = ["--store-dir", {str(tmp_path)!r}]
        lines = []
        for main, argv in (
                (streaming_bench.main, geometry + store + [
                    "--hot-clusters", "2", "--cache-frac", "0.5"]),
                (pq_capacity.main, geometry + store + [
                    "--m", "4", "--rerank", "0,16"]),
                (pq_sweep.main, ["--n", "6000", "--dim", "16", "--nlist",
                                 "16", "--m", "4", "--max-batch", "16",
                                 "--nprobe", "4",
                                 "--n-batches", "1", "--config", "16:8",
                                 "--device", "cpu"])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert main(argv) == 0
            lines.append([json.loads(s) for s in
                          out.getvalue().strip().splitlines()])
        assert lines[0][-1]["recall_at_10"] >= 0.9, lines[0]
        adc, reranked = lines[1][-1]["points"]
        assert reranked["recall_at_10"] > adc["recall_at_10"], lines[1]
        assert lines[2][-1]["recall"] >= 0.5, lines[2]
        bad = [m for m in sys.modules if (m == "jax" or m.startswith("jax.")
               or m.startswith("cuda_acceleratedvectordatabaseengine_tpu."))
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
