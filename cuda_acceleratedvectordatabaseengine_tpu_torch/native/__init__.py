"""ctypes bindings for the native host runtime (``vdbhost.cc``): the same
functions as the JAX package's ``native`` module.

The shared library is built at first use with ``g++`` (``-O3 -std=c++17
-fPIC -pthread -shared``) into ``build/native/<hash>/`` beside the package,
keyed by a hash of the source, the flags and the compiler's version, so an
edited source rebuilds and an unchanged one is reused. Concurrent builders
(several test workers) each compile into a temporary name and ``os.replace``
it, so a reader sees a whole library or none.

There is no fallback: without ``g++``, or when the build fails, every entry
point raises ``RuntimeError``. The numpy versions of the staging helpers
(``gather_lists_plain``, ``gather_rows_plain``, ``f32_to_bf16_plain``) are
the references the tests hold the native ones against; no code path turns a
failed build into them.

Each entry point holds no Python object across the call, and ctypes
releases the GIL during a foreign call, so the C++ threads run beside the
serving threads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "vdbhost.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libvdbhost.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
# The library's C interface: argument kinds and the result kind of each
# exported function, in the order of its prototype in ``vdbhost.cc``:
# ``p`` a pointer, ``s`` a C string, ``i`` int32, ``l`` int64, ``z`` size_t,
# ``v`` void.
SIGNATURES = {
    "vdb_aligned_alloc": ("z", "p"),
    "vdb_aligned_free": ("p", "v"),
    "vdb_gather_lists": ("ppiiipp", "v"),
    "vdb_gather_rows": ("pliplp", "v"),
    "vdb_f32_to_bf16": ("plp", "v"),
    "vdb_readahead": ("slll", "i"),
    "vdb_hardware_concurrency": ("", "i"),
    "vdb_rerank": ("pilipppp" "ippii" "ppii" "ppp", "v"),
}
_KINDS = {"p": ctypes.c_void_p, "s": ctypes.c_char_p, "i": ctypes.c_int32,
          "l": ctypes.c_int64, "z": ctypes.c_size_t, "v": None}


def find_compiler() -> str:
    """``g++`` from ``PATH``; raises ``RuntimeError`` when there is none."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError(
            "g++ not found on PATH: the native host runtime (vdbhost.cc) "
            "cannot be built, and it has no fallback"
        )
    return found


def source_hash(cxx: str) -> str:
    """Hash of the source, the flags, the machine and the compiler's
    version: a library built by another compiler is not reused."""
    version = subprocess.run(
        [cxx, "-dumpfullversion", "-dumpversion"], capture_output=True,
        text=True, check=True, timeout=60,
    ).stdout.strip()
    h = hashlib.sha256(" ".join((*CXX_FLAGS, platform.machine(),
                                 version)).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build_library(build_root: Path | None = None) -> Path:
    """Compile ``vdbhost.cc`` unless a library of the same source, flags
    and compiler exists; return its path. Raises ``RuntimeError`` without
    a compiler or when the compiler fails."""
    cxx = find_compiler()
    out_dir = Path(build_root or BUILD_ROOT) / source_hash(cxx)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, check=False, timeout=600,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} (exit code "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library with its C signatures
    (:data:`SIGNATURES`) declared."""
    lib = ctypes.CDLL(str(build_library()))
    for name, (args, res) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [_KINDS[a] for a in args]
        fn.restype = _KINDS[res]
    return lib


def available() -> bool:
    """Whether the library builds and loads here (for reports; no path
    chooses another implementation by it)."""
    try:
        load_library()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _ptr(a: np.ndarray | None) -> int | None:
    return None if a is None else a.ctypes.data


def _vector(a, n: int, dtype, name: str) -> np.ndarray | None:
    """``a`` as a C-contiguous ``[n]`` array of ``dtype`` (None stays)."""
    if a is None:
        return None
    a = np.ascontiguousarray(a, dtype)
    if a.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {a.shape}")
    return a


# --------------------------------------------------------------------------- #
# staging helpers and their numpy references
# --------------------------------------------------------------------------- #

def gather_lists(
    list_arrays: list[np.ndarray], cap: int, dim: int
) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged fp32 lists into a padded staging block + squared norms:
    returns (vectors [n, cap, dim], sq [n, cap]); lists longer than ``cap``
    are cut."""
    lib = load_library()
    n = len(list_arrays)
    arrs = [np.ascontiguousarray(a, np.float32) for a in list_arrays]
    for a in arrs:
        if a.ndim != 2 or a.shape[1] != dim:
            raise ValueError(f"each list must be [n, {dim}], got {a.shape}")
    out = np.empty((n, cap, dim), np.float32)
    out_sq = np.empty((n, cap), np.float32)
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
    counts = np.array([a.shape[0] for a in arrs], np.int32)
    lib.vdb_gather_lists(ctypes.addressof(ptrs), counts.ctypes.data, n, cap,
                         dim, out.ctypes.data, out_sq.ctypes.data)
    return out, out_sq


def gather_lists_plain(
    list_arrays: list[np.ndarray], cap: int, dim: int
) -> tuple[np.ndarray, np.ndarray]:
    """numpy version of :func:`gather_lists`."""
    n = len(list_arrays)
    out = np.zeros((n, cap, dim), np.float32)
    out_sq = np.zeros((n, cap), np.float32)
    for i, arr in enumerate(list_arrays):
        c = min(arr.shape[0], cap)
        out[i, :c] = arr[:c]
        out_sq[i, :c] = (arr[:c] ** 2).sum(-1)
    return out, out_sq


def gather_rows(src: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """out[i] = src[rows[i]]; rows outside ``[0, len(src))`` → zeros."""
    lib = load_library()
    src = np.ascontiguousarray(src, np.float32)
    rows = np.ascontiguousarray(rows, np.int64).reshape(-1)
    if src.ndim != 2:
        raise ValueError(f"src must be [n, dim], got {src.shape}")
    out = np.empty((rows.shape[0], src.shape[1]), np.float32)
    lib.vdb_gather_rows(src.ctypes.data, src.shape[0], src.shape[1],
                        rows.ctypes.data, rows.shape[0], out.ctypes.data)
    return out


def gather_rows_plain(src: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """numpy version of :func:`gather_rows`."""
    src = np.asarray(src, np.float32)
    rows = np.asarray(rows, np.int64).reshape(-1)
    bad = (rows < 0) | (rows >= src.shape[0])
    out = src[np.where(bad, 0, rows)] if src.shape[0] else np.zeros(
        (rows.shape[0], src.shape[1]), np.float32)
    out[bad] = 0
    return out


def f32_to_bf16(src: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even fp32 → bf16 (as the uint16 bit pattern)."""
    lib = load_library()
    src = np.ascontiguousarray(src, np.float32)
    out = np.empty(src.shape, np.uint16)
    lib.vdb_f32_to_bf16(src.ctypes.data, src.size, out.ctypes.data)
    return out


def f32_to_bf16_plain(src: np.ndarray) -> np.ndarray:
    """numpy version of :func:`f32_to_bf16`."""
    bits = np.ascontiguousarray(src, np.float32).view(np.uint32)
    rounding = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & 1)
    return ((bits + rounding) >> np.uint32(16)).astype(np.uint16)


# --------------------------------------------------------------------------- #
# the fused shortlist rerank
# --------------------------------------------------------------------------- #

def rerank(
    vecs: np.ndarray,            # [n_rows, dim] int8 or fp32, C-contiguous
    rows: np.ndarray,            # [b, r] int64, -1 = invalid candidate
    cand_ids: np.ndarray,        # [b, r] uint64
    queries: np.ndarray,         # [b, dim] fp32
    q_sq: np.ndarray | None,     # [b] fp32 (L2 only)
    metric_code: int,            # 0=L2, 1=IP, 2=cosine
    k: int,
    scale: np.ndarray | None = None,       # [n_rows] fp32 (int8 store)
    sq: np.ndarray | None = None,          # [n_rows] fp32 (L2 only)
    anchor_row: np.ndarray | None = None,  # [n_rows] int32 (int8 store)
    qa: np.ndarray | None = None,          # [b, nlist] fp32 (int8 store)
    qa_cand: np.ndarray | None = None,     # [b, r] fp32 per-candidate
                                           # anchor dots (preferred over
                                           # the dense qa — see vdb_rerank)
) -> tuple[np.ndarray, np.ndarray]:
    """Fused gather + dequant + dot + top-k shortlist rerank
    (``vdb_rerank``): ``(distances [b, k] fp32, ids [b, k] uint64)``,
    ascending, FLT_MAX / INVALID_ID padding.

    The row store is never copied: a store that is not C-contiguous raises
    ``ValueError`` (the caller picks its path by the store's layout). Every
    other argument is checked for shape and converted to its C type here,
    before a pointer reaches the C++."""
    lib = load_library()
    if vecs.ndim != 2 or vecs.dtype not in (np.int8, np.float32):
        raise ValueError(f"vecs must be [n, dim] int8 or float32, got "
                         f"{vecs.dtype} {vecs.shape}")
    if not vecs.flags["C_CONTIGUOUS"]:
        raise ValueError("vecs must be C-contiguous (the row store is "
                         "never copied)")
    if metric_code not in (0, 1, 2):
        raise ValueError(f"metric_code must be 0, 1 or 2, got {metric_code}")
    n_rows, dim = vecs.shape
    is_int8 = vecs.dtype == np.int8
    rows = np.ascontiguousarray(rows, np.int64)
    if rows.ndim != 2:
        raise ValueError(f"rows must be [b, r], got {rows.shape}")
    b, r = rows.shape
    cand_ids = np.ascontiguousarray(cand_ids, np.uint64)
    queries = np.ascontiguousarray(queries, np.float32)
    if cand_ids.shape != (b, r) or queries.shape != (b, dim):
        raise ValueError(f"cand_ids {cand_ids.shape} / queries "
                         f"{queries.shape} do not fit rows {rows.shape} and "
                         f"dim {dim}")
    q_sq = _vector(q_sq, b, np.float32, "q_sq")
    scale = _vector(scale, n_rows, np.float32, "scale")
    sq = _vector(sq, n_rows, np.float32, "sq")
    anchor_row = _vector(anchor_row, n_rows, np.int32, "anchor_row")
    if metric_code == 0 and (q_sq is None or sq is None):
        raise ValueError("L2 needs q_sq and sq")
    nlist = 0
    if qa is not None:
        qa = np.ascontiguousarray(qa, np.float32)
        if qa.ndim != 2 or qa.shape[0] != b:
            raise ValueError(f"qa must be [{b}, nlist], got {qa.shape}")
        nlist = qa.shape[1]
    if qa_cand is not None:
        qa_cand = np.ascontiguousarray(qa_cand, np.float32)
        if qa_cand.shape != (b, r):
            raise ValueError(f"qa_cand must be [{b}, {r}], got "
                             f"{qa_cand.shape}")
    if is_int8:
        if scale is None:
            raise ValueError("an int8 store needs scale")
        if qa_cand is None and (qa is None or anchor_row is None):
            raise ValueError("an int8 store needs qa_cand, or qa and "
                             "anchor_row")
        if qa_cand is None and n_rows and (
                anchor_row.min() < 0 or anchor_row.max() >= nlist):
            raise ValueError("anchor_row outside [0, nlist)")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    out_d = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.uint64)
    lib.vdb_rerank(
        vecs.ctypes.data, int(is_int8), n_rows, dim,
        _ptr(scale), _ptr(sq), _ptr(anchor_row), _ptr(qa), nlist,
        queries.ctypes.data, _ptr(q_sq), b, r,
        rows.ctypes.data, cand_ids.ctypes.data, metric_code, k,
        out_d.ctypes.data, out_i.ctypes.data, _ptr(qa_cand),
    )
    return out_d, out_i


def readahead(path: str, offset: int = 0, length: int = 0,
              touch_bytes: int = 0) -> bool:
    """``posix_fadvise(WILLNEED)`` over ``[offset, offset + length)`` (0 =
    to the end) and a synchronous read of its first ``touch_bytes``; False
    when the file does not open or the read comes up short."""
    lib = load_library()
    return lib.vdb_readahead(
        os.fsencode(path), offset, length or (1 << 40), touch_bytes
    ) == 0
