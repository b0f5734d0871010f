"""K1's (``grouped_scan_tc_kernel``) share of its roofline in %, from the
traced windows and ``roofline.grouped_scan_bound``."""

from vdb_bench.readers import k1_roofline


def read(run):
    return k1_roofline(run)
