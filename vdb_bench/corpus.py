"""The benchmark's data, made on the device from ``--seed``: a mixture
corpus with one gaussian ball per list, the balls in groups of ``group``
whose centres lie ``group_radius`` from the group's point, and a query pool
of group points plus noise.

The rows are a frozen copy of the generator of the port's ``tools/bench.py``
(``corpus_chunk``: round-robin membership, so row ``g`` joins ball
``g mod n_balls`` and every ball holds the same number of rows; one mode a
ball); the centres and the queries are this benchmark's own. A query sits
near its group's point, at about the same distance from each of the
group's ``group`` ball centres and far from every other ball, so its exact
top-k is spread over the group's lists: with ``group`` equal to the
configuration's nprobe, an IVF search finds it only where the coarse probe,
the list assignment and the scan are right for every probed list, not for
the nearest one alone.

Every stream draws from its own seed, derived from ``--seed``, so one seed
gives the same centres, rows, queries and traffic on every run and every
seed gives the same sizes. Both sides of a run read the same rows: the
program gets them to build its index, the plain reference regenerates them,
chunk by chunk, to judge the answers.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK_ROWS = 500_000          # rows a generated chunk
CHUNK_SEED_STRIDE = 1_000_003  # a chunk's generator: seed · stride + start
QUERY_BLOCK = 1024             # queries projected at a time


def stream_seeds(seed: int) -> dict:
    """Independent 32-bit seeds of the run's streams (centers, corpus,
    queries, traffic), derived from ``seed`` of any size."""
    s = np.random.SeedSequence(int(seed)).generate_state(4, np.uint32)
    return dict(zip(("centers", "corpus", "queries", "traffic"),
                    (int(v) for v in s)))


class Corpus:
    """The rows of one configuration under one seed. ``rows(start, m)``
    gives global rows ``[start, start + m)`` in bf16 on ``device``, the
    same values whatever the chunking of the caller."""

    def __init__(self, spec: dict, seed: int, device):
        self.n = int(spec["n"])
        self.dim = int(spec["dim"])
        self.n_balls = int(spec["balls"])
        self.group = int(spec["group"])
        self.noise = float(spec["noise"])
        self.device = torch.device(device)
        self.seeds = stream_seeds(seed)
        gen = torch.Generator(device=self.device).manual_seed(
            self.seeds["centers"])
        n_groups = -(-self.n_balls // self.group)
        self.points = torch.randn((n_groups, self.dim), generator=gen,
                                  device=self.device)
        # each group's ``group`` ball directions, orthonormal: [G, dim, group]
        self.dirs = torch.linalg.qr(torch.randn(
            (n_groups, self.dim, self.group), generator=gen,
            device=self.device)).Q
        ball = torch.arange(self.n_balls, device=self.device)
        self.centers = (self.points[ball // self.group]
                        + float(spec["group_radius"])
                        * self.dirs[ball // self.group, :, ball % self.group])

    def _chunk(self, start: int, m: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(
            self.seeds["corpus"] * CHUNK_SEED_STRIDE + start)
        ball = torch.arange(start, start + m, device=self.device) \
            % self.n_balls
        pts = self.centers[ball] + self.noise * torch.randn(
            (m, self.dim), generator=gen, device=self.device)
        return pts.to(torch.bfloat16)

    def chunks(self):
        """``(start, rows)`` over the whole corpus, one generated chunk at
        a time."""
        for start in range(0, self.n, CHUNK_ROWS):
            yield start, self._chunk(start, min(CHUNK_ROWS, self.n - start))

    def all_rows(self) -> torch.Tensor:
        """The whole corpus ``[n, dim]`` bf16 on the device."""
        out = torch.empty((self.n, self.dim), dtype=torch.bfloat16,
                          device=self.device)
        for start, rows in self.chunks():
            out[start:start + rows.shape[0]] = rows
        return out


def query_pool(corpus: Corpus, spec: dict, seed: int) -> torch.Tensor:
    """``spec["queries"]`` group points drawn uniformly, each plus
    ``spec["query_noise"]`` · N(0, 1) with its components along the group's
    ball directions taken out, so that the query stays exactly as far from
    each of the group's ball centres: fp32 ``[queries, dim]`` on the
    corpus's device."""
    gen = torch.Generator(device=corpus.device).manual_seed(
        stream_seeds(seed)["queries"])
    n_q = int(spec["queries"])
    g = torch.randint(0, corpus.points.shape[0], (n_q,), generator=gen,
                      device=corpus.device)
    e = torch.randn((n_q, corpus.dim), generator=gen, device=corpus.device)
    for s0 in range(0, n_q, QUERY_BLOCK):
        q_dirs = corpus.dirs[g[s0:s0 + QUERY_BLOCK]]         # [b, dim, group]
        blk = e[s0:s0 + QUERY_BLOCK]
        blk -= torch.einsum("qdg,qg->qd", q_dirs,
                            torch.einsum("qdg,qd->qg", q_dirs, blk))
    return corpus.points[g] + float(spec["query_noise"]) * e
