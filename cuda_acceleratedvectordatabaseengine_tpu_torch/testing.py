"""Tie-aware comparison of two top-k search results.

Two correct top-k implementations may order tied results differently, and
two correct fp32 implementations may round a distance differently in its
last bits, which reorders near-ties. So results are compared the way the
contract allows: the sorted distances must agree within a tolerance, and an
id may be in one result and not the other only where it sits at the k-th
distance boundary of the other (a tie the two broke differently). Used by
the parity tests and by ``chip_smoke.py``; imports no JAX.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

FLT_MAX = np.float32(np.finfo(np.float32).max)


@dataclasses.dataclass
class TopkComparison:
    max_abs_err: float        # largest |d_a − d_b| over finite entries
    max_excess: float         # largest |d_a − d_b| − tol (≤ 0: within tol)
    n_entries: int            # rows × k
    n_id_differences: int     # ids in one result and not the other
    n_unexplained: int        # of those, not at the k-th distance boundary

    @property
    def ok(self) -> bool:
        return self.max_excess <= 0.0 and self.n_unexplained == 0


def _finite(d: np.ndarray) -> np.ndarray:
    return np.isfinite(d) & (d < FLT_MAX)


def compare_topk(d_a, ids_a, d_b, ids_b, rtol: float = 1e-5,
                 atol=0.0) -> TopkComparison:
    """Compare results ``(d_a, ids_a)`` and ``(d_b, ids_b)``, each
    ``[B, k]`` with ascending distances. ``atol`` is a scalar or a per-row
    ``[B]`` array (e.g. a multiple of ‖q‖², the scale of an L2 distance's
    rounding error). Invalid entries (inf / FLT_MAX) must coincide."""
    d_a = np.asarray(d_a, np.float64)
    d_b = np.asarray(d_b, np.float64)
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    if d_a.shape != d_b.shape or ids_a.shape != ids_b.shape:
        raise ValueError(f"shape mismatch {d_a.shape} vs {d_b.shape}")
    b, k = d_a.shape
    atol = np.broadcast_to(np.asarray(atol, np.float64), (b,))
    fa, fb = _finite(d_a), _finite(d_b)
    tol = atol[:, None] + rtol * np.abs(np.where(fb, d_b, 0.0))
    both = fa & fb
    err = np.abs(np.where(both, d_a, 0.0) - np.where(both, d_b, 0.0))
    excess = np.where(both, err - tol, 0.0)
    excess = np.where(fa != fb, np.inf, excess)
    n_diff = n_bad = 0
    for r in range(b):
        ca = collections.Counter(ids_a[r][fa[r]].tolist())
        cb = collections.Counter(ids_b[r][fb[r]].tolist())
        da = dict(zip(ids_a[r].tolist(), d_a[r].tolist()))
        db = dict(zip(ids_b[r].tolist(), d_b[r].tolist()))
        for only, dist, other_d, other_f in (
            (ca - cb, da, d_b[r], fb[r]),
            (cb - ca, db, d_a[r], fa[r]),
        ):
            for i, c in only.items():
                n_diff += c
                # The other result left this id out: fair only if the
                # other's k-th distance is no larger than this id's.
                kth = other_d[other_f].max() if other_f.any() else np.inf
                slack = atol[r] + rtol * abs(kth)
                if other_f.all() and dist[i] >= kth - slack:
                    continue
                n_bad += c
    return TopkComparison(
        max_abs_err=float(err.max()) if err.size else 0.0,
        max_excess=float(excess.max()) if excess.size else 0.0,
        n_entries=b * k,
        n_id_differences=n_diff,
        n_unexplained=n_bad,
    )


def assert_topk_match(d_a, ids_a, d_b, ids_b, rtol: float = 1e-5,
                      atol=0.0) -> TopkComparison:
    """:func:`compare_topk`, raising ``AssertionError`` unless it is ok."""
    c = compare_topk(d_a, ids_a, d_b, ids_b, rtol=rtol, atol=atol)
    if not c.ok:
        raise AssertionError(f"top-k results disagree: {c}")
    return c
