"""Arrow IPC vector, centroid, codebook and code tables (the JAX package's
``storage/arrow_store.py`` API, on the numpy codec of ``arrow_ipc.py``, so
no ``pyarrow`` is needed).

Same files as the JAX package: record batches of ``(id uint64, vector
list<float32>)`` for vectors, centroids and PQ codebooks (a codebook row's
id packs ``(m << 16) | k``), ``(id uint64, code list<uint8>)`` for codes,
with offset / length slicing on read through a memory map. One difference:
a batch holds at most ``(2³¹ − 1) // width`` rows, so int32 list offsets
never wrap (the JAX writer puts a whole table in one batch).
"""

from __future__ import annotations

import numpy as np

from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.arrow_ipc import (
    IpcFileReader,
    IpcFileWriter,
)


class VectorFileWriter:
    """Chunk-appending writer for the vectors schema: each ``append``
    writes its rows as record batches, so a corpus larger than RAM
    streams to disk without being concatenated (readers slice across
    batches)."""

    def __init__(self, path: str):
        self._writer = IpcFileWriter(path, "vector")

    @property
    def rows(self) -> int:
        return self._writer.rows

    def append(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        self._writer.write(ids, vectors)

    def close(self) -> None:
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ArrowStorage:
    """Stateless read/write helpers over Arrow IPC files."""

    # ------------------------------------------------------------------ #
    # vectors
    # ------------------------------------------------------------------ #

    @staticmethod
    def write_vectors(path: str, ids: np.ndarray, vectors: np.ndarray) -> None:
        """Write ``[n]`` uint64 ids + ``[n, dim]`` fp32 vectors."""
        with IpcFileWriter(path, "vector") as w:
            w.write(ids, vectors)

    @staticmethod
    def read_vectors(
        path: str, offset: int = 0, length: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """``(ids [n] uint64, vectors [n, dim] fp32)`` of rows ``[offset,
        offset + length)``; only those rows are read from the file."""
        return IpcFileReader(path, "vector").read(offset, length)

    @staticmethod
    def num_rows(path: str) -> int:
        """Total row count from the file's metadata (no vector data is
        read)."""
        return IpcFileReader(path, "vector").num_rows

    @staticmethod
    def iter_vector_chunks(path: str, chunk_rows: int):
        """Yield ``(ids, vectors)`` slices of at most ``chunk_rows`` rows,
        each read on its own off one memory map, so peak host RAM is one
        chunk whatever the file's size."""
        reader = IpcFileReader(path, "vector")
        for off in range(0, reader.num_rows, chunk_rows):
            yield reader.read(off, chunk_rows)

    @staticmethod
    def read_train_sample(
        path: str, rows: int, n_slices: int = 32
    ) -> np.ndarray:
        """≈``rows`` training vectors as evenly spaced slices across the
        whole file (bounded RAM, robust to sorted or clustered row order;
        the JAX package's law)."""
        reader = IpcFileReader(path, "vector")
        total = reader.num_rows
        rows = min(rows, total)
        n_slices = max(1, min(n_slices, rows))
        per = -(-rows // n_slices)
        stride = max(total // n_slices, per)
        parts = []
        got = 0
        for i in range(n_slices):
            off = min(i * stride, max(total - per, 0))
            take = min(per, total - off, rows - got)
            if take <= 0:
                break
            parts.append(reader.read(off, take)[1])
            got += take
        return np.concatenate(parts) if parts else np.zeros((0, 0))

    # ------------------------------------------------------------------ #
    # centroids / codebooks — same schema, synthetic ids
    # ------------------------------------------------------------------ #

    @staticmethod
    def write_centroids(path: str, centroids: np.ndarray) -> None:
        ids = np.arange(centroids.shape[0], dtype=np.uint64)
        ArrowStorage.write_vectors(path, ids, centroids)

    @staticmethod
    def read_centroids(path: str) -> np.ndarray:
        return ArrowStorage.read_vectors(path)[1]

    @staticmethod
    def write_codebooks(path: str, codebooks: np.ndarray) -> None:
        """``[m, ks, dsub]`` fp32; row id = (m << 16) | k."""
        m, ks, dsub = codebooks.shape
        ids = (
            (np.repeat(np.arange(m, dtype=np.uint64), ks) << np.uint64(16))
            | np.tile(np.arange(ks, dtype=np.uint64), m)
        )
        ArrowStorage.write_vectors(path, ids, codebooks.reshape(m * ks, dsub))

    @staticmethod
    def read_codebooks(path: str) -> np.ndarray:
        ids, flat = ArrowStorage.read_vectors(path)
        m = int((ids[-1] >> np.uint64(16)) + 1)
        ks = flat.shape[0] // m
        return flat.reshape(m, ks, flat.shape[1])

    # ------------------------------------------------------------------ #
    # PQ codes
    # ------------------------------------------------------------------ #

    @staticmethod
    def write_codes(path: str, ids: np.ndarray, codes: np.ndarray) -> None:
        """Write ``[n]`` uint64 ids + ``[n, m]`` uint8 codes."""
        with IpcFileWriter(path, "code") as w:
            w.write(ids, codes)

    @staticmethod
    def read_codes(path: str) -> tuple[np.ndarray, np.ndarray]:
        return IpcFileReader(path, "code").read()
