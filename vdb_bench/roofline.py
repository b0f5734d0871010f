"""The yardstick of the kernels: the card's published peaks and the work a
probed-list scan needs.

Frozen copies of ``chip_smoke.py``'s ``roofline``, ``scan_work`` and the
grouped (K1) branch of ``flat_scan_bound``, taking the probe set and the
list occupancy as plain tensors. They count the bytes and operations the
inputs need, so the count stays the same whatever implements the scan.
"""

from __future__ import annotations

import torch

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): fp32 on
# the CUDA cores, dense bf16 on the tensor cores, HBM3 bandwidth. The scans
# of int8 and bf16 arenas run on the tensor cores as three exact bf16
# products per multiply-add of an fp32 query (hi / mid / lo planes).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
BF16_PLANES = 3
PEAK_HBM_BYTES = 3.35e12


def roofline(flops: float, nbytes: float, exact_bf16: bool) -> dict:
    """The least time the card could take for this work (``bound_s``): the
    larger of the operations over their peak and the bytes over the HBM
    rate."""
    t_ops = (BF16_PLANES * flops / PEAK_BF16_FLOPS if exact_bf16
             else flops / PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def scan_work(probe: torch.Tensor, counts: torch.Tensor,
              cap_s: int) -> tuple[int, int, int]:
    """How much a probed-list scan of these inputs touches: the (valid
    pair, occupied scanned slot) count, the occupied scanned slots of the
    distinct probed lists, and the number of distinct lists."""
    flat = probe.reshape(-1).long()
    flat = flat[flat >= 0]
    occ = counts.long().clamp(max=cap_s)
    distinct = torch.unique(flat)
    return (int(occ[flat].sum()), int(occ[distinct].sum()),
            int(distinct.numel()))


def grouped_scan_bound(probe: torch.Tensor, counts: torch.Tensor, cap_s: int,
                       dim: int, elem_bytes: int, k: int,
                       scaled: bool = False, anchored: bool = False) -> dict:
    """Roofline of one grouped scan (K1, top-k rows out) of a batch whose
    probes are ``probe [B, nprobe]``: a D-long dot (2·D operations) per
    (valid pair, occupied slot); bytes read once: the distinct lists'
    occupied rows (codes, norms, scales), their anchors and the fp32
    queries; written once: ``k`` (distance, position) pairs per (query,
    probe)."""
    batch, nprobe = probe.shape
    pair_slots, list_slots, n_lists = scan_work(probe, counts, cap_s)
    flops = 2 * dim * pair_slots
    row = dim * elem_bytes + 4 + (4 if scaled else 0)
    nbytes = row * list_slots
    if anchored:
        nbytes += n_lists * dim * 4
    nbytes += batch * dim * 4 + batch * nprobe * k * 8
    return roofline(flops, nbytes, exact_bf16=elem_bytes <= 2)
