"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, which is loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds). The library lands in
``build/kernels/<hash>/`` beside the package, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. There is no fallback: without ``nvcc`` the CUDA path raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libvdb_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``). Raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    cand = home / "bin" / "nvcc"
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "cannot be built, and the CUDA path has no fallback"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library(build_root: Path = BUILD_ROOT) -> Path:
    """Compile ``csrc/*.cu`` unless a library for the same sources exists;
    return its path. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept in ``nvcc.log`` beside it."""
    out_dir = Path(build_root) / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (out_dir / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its C signatures
    declared (pointers and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(str(build_library()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vdb_grouped_scan.argtypes = [p] * 10 + [i] * 9 + [p]
    lib.vdb_grouped_scan.restype = i
    lib.vdb_grouped_scan_max_m.argtypes = [i, i]
    lib.vdb_grouped_scan_max_m.restype = i
    return lib
