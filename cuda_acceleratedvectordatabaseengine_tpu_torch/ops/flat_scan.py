"""The probed-list flat scans behind one name: which scan a ``scan_impl``
name runs, and the call.

Both users of the flat scans go through here, so the routing is written
once: ``models/ivf_flat.py`` (the resident arena) and
``io_host/streaming.py`` (the device list cache). Names, after the JAX
package's ``scan_impl`` values:

- ``"auto"``: the grouped kernel K1 on CUDA, the gather scan on the CPU;
- ``"grouped"`` / ``"pallas_grouped"``: K1 (``ops/grouped_scan.py``);
- ``"sorted"`` / ``"pallas_sorted"``: the sorted full-row kernel K3
  (``ops/sorted_scan.py``);
- ``"ragged"``: K3 too. The JAX package's ``scan_probed_lists_ragged`` is
  plain XLA (pairs sorted by list, full ``[B·P, cap]`` rows with scale
  and anchor, the top-k outside), which is K3's function with no limit on
  k;
- ``"pallas"``: the pair full-row kernel K4 (``ops/pair_scan.py``), or K3
  on an arena with per-row scales, as in the JAX package (K4 reads no
  scales);
- ``"gather"``: the plain gather scan (``ops/scan.py``).

K1 keeps at most ``KMAX`` candidates per (query, list), so a K1 search
deeper than that goes to K3, which writes full rows and takes the top-k
outside the kernel. On the CPU every kernel name runs its kernel's plain
PyTorch version.
"""

from __future__ import annotations

from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.grouped_scan import (
    KMAX,
    scan_probed_lists_grouped,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.pair_scan import (
    scan_probed_lists_pairs,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.scan import (
    scan_probed_lists,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.sorted_scan import (
    scan_probed_lists_sorted,
)

# scan_impl name → the scan it selects ("auto" is resolved from the device)
SCAN_NAMES = {
    "auto": "auto", "gather": "gather", "grouped": "grouped",
    "pallas_grouped": "grouped", "sorted": "sorted",
    "pallas_sorted": "sorted", "ragged": "sorted", "pallas": "pallas",
}


def check_scan_name(name: str) -> None:
    if name not in SCAN_NAMES:
        raise ValueError(
            f"scan_impl {name!r} is not available in this package; "
            f"expected one of {sorted(SCAN_NAMES)}"
        )


def resolve_scan(name: str, *, on_cuda: bool, k: int = 1,
                 scaled: bool = False) -> str:
    """The scan that ``name`` runs: ``"grouped"``, ``"sorted"``,
    ``"pallas"`` or ``"gather"``, for an arena on CUDA (``on_cuda``) or
    not, a search depth ``k`` and an arena with per-row scales
    (``scaled``). A resolved name resolves to itself."""
    check_scan_name(name)
    impl = SCAN_NAMES[name]
    if impl == "auto":
        impl = "grouped" if on_cuda else "gather"
    if impl == "pallas" and scaled:
        impl = "sorted"
    if impl == "grouped" and k > KMAX:
        impl = "sorted"
    return impl


def scan_flat(name, q, arena, arena_sq, counts, probe, k, metric, *,
              arena_scale=None, arena_anchors=None, m_budget=None,
              scan_capacity=None, slot_stride=1, slot_offset=0,
              global_capacity=None):
    """Scan the probed lists with the scan ``name`` selects (see
    :func:`resolve_scan`); returns ``(dists [B, ≥k], pos [B, ≥k])`` as the
    selected scan does. The striping arguments describe one shard of a
    slot-striped arena (``parallel/sharded.py``) as in
    ``ops/scan.scan_probed_lists``; ``scan_capacity`` bounds the shard's
    local slot prefix."""
    impl = resolve_scan(name, on_cuda=arena.is_cuda, k=k,
                        scaled=arena_scale is not None)
    args = (q, arena, arena_sq, counts, probe, k, metric)
    stripe = dict(slot_stride=slot_stride, slot_offset=slot_offset,
                  global_capacity=global_capacity)
    if impl == "grouped":
        return scan_probed_lists_grouped(
            *args, m_budget=m_budget, arena_scale=arena_scale,
            arena_anchors=arena_anchors, scan_capacity=scan_capacity,
            **stripe)
    if impl == "sorted":
        return scan_probed_lists_sorted(
            *args, m_budget=m_budget, arena_scale=arena_scale,
            arena_anchors=arena_anchors, scan_capacity=scan_capacity,
            **stripe)
    if impl == "pallas":
        return scan_probed_lists_pairs(*args, scan_capacity=scan_capacity,
                                       **stripe)
    return scan_probed_lists(*args, arena_scale=arena_scale,
                             arena_anchors=arena_anchors, **stripe)
