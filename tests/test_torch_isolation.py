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
