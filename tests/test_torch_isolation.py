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
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import cuda_acceleratedvectordatabaseengine_tpu_torch as vdb
        from cuda_acceleratedvectordatabaseengine_tpu_torch import testing
        from cuda_acceleratedvectordatabaseengine_tpu_torch.models import (
            calibrate, convert, ivf_pq)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
            _build, grouped_pq_scan, grouped_scan, kmeans, pq, scan)
        from cuda_acceleratedvectordatabaseengine_tpu_torch.utils import (
            batching)
        x = np.random.default_rng(0).standard_normal((512, 16), np.float32)
        idx = vdb.IVFFlatIndex(vdb.IVFFlatConfig(dimension=16, nlist=8,
                                                 dtype="int8",
                                                 train_iters=3))
        idx.train(x)
        idx.add(x)
        d, ids = idx.search(x[:4], vdb.SearchParams(nprobe=8, k=3))
        assert (ids[:, 0] == np.arange(4)).all(), ids
        pq_idx = vdb.IVFPQIndex(vdb.IVFPQConfig(dimension=16, nlist=8, m=4,
                                                train_iters=3, opq=True,
                                                opq_iters=1))
        pq_idx.train(x)
        pq_idx.add(x)
        d, ids = pq_idx.search(x[:4], vdb.SearchParams(
            nprobe=8, k=3, use_exact_rerank=True))
        assert (ids[:, 0] == np.arange(4)).all(), ids
        assert grouped_scan.LAUNCHES == 0 and grouped_pq_scan.LAUNCHES == 0
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


def test_kernel_sources_are_hashed(tmp_path, monkeypatch):
    srcs = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert "grouped_scan.cu" in srcs and "grouped_pq_scan.cu" in srcs
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
