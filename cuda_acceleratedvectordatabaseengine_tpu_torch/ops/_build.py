"""Build and load the port's CUDA kernels (``csrc/*.cu``, with the shared
headers ``csrc/*.cuh``).

The sources are compiled at first use with ``nvcc``, one process per
source, all started together, and linked into one shared library with a
plain C interface, which is loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds). The library lands in
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")
# The library's C interface: argument kinds (``p`` a pointer or the stream,
# ``i`` an int) and the result kind of each exported function, in the order
# of its prototype in ``csrc/*.cu``.
SIGNATURES = {
    "vdb_grouped_scan": ("p" * 11 + "i" * 10 + "p", "i"),
    "vdb_grouped_scan_max_m": ("ii", "i"),
    "vdb_pq_tables": ("p" * 3 + "i" * 3 + "p", "i"),
    "vdb_grouped_pq_scan": ("p" * 9 + "i" * 12 + "p", "i"),
    "vdb_sorted_scan": ("p" * 10 + "i" * 10 + "p", "i"),
    "vdb_sorted_scan_max_m": ("ii", "i"),
    "vdb_pair_scan": ("p" * 7 + "i" * 10 + "p", "i"),
}


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
    """Hash of the flags and of every source and header: an edited header
    rebuilds like an edited source."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library(build_root: Path = BUILD_ROOT) -> Path:
    """Compile ``csrc/*.cu`` (one ``nvcc -c`` per source, in parallel) and
    link them, unless a library for the same sources exists; return its
    path. The compilers' output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) is kept in ``nvcc.log`` beside it."""
    out_dir = Path(build_root) / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in _sources():
        obj = out_dir / f".{src.stem}.{tag}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:          # waits for every compiler it started
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]}: exit code {proc.returncode}\n"
                          f"{err[-4000:]}")
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link: exit code {proc.returncode}\n"
                          f"{proc.stderr[-4000:]}")
    (out_dir / "nvcc.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its C signatures
    (:data:`SIGNATURES`) declared (pointers and the stream as
    ``c_void_p``)."""
    lib = ctypes.CDLL(str(build_library()))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for name, (args, res) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [kinds[a] for a in args]
        fn.restype = kinds[res]
    return lib
