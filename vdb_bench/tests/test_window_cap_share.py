"""``window_cap_share`` on hand-made stages."""

import pytest

from vdb_bench import spec
from vdb_bench.harness import Run


@pytest.mark.parametrize("stages, share", [
    # every window closed at the cap
    ({"window_wait": {"count": 40}, "window_cap": {"count": 40}}, 1.0),
    # 10 of 40 windows ran until their deadline
    ({"window_wait": {"count": 40}, "window_cap": {"count": 30},
      "window_deadline": {"count": 10}}, 0.75),
    # an engine that ends a window only at max_n items records neither
    ({"window_wait": {"count": 40}}, None),
    # an engine that records no window at all
    ({}, None),
])
def test_window_cap_share_reads_the_drains_the_cap_closed(stages, share):
    assert spec.load_reader("window_cap_share")(Run(stages=stages)) == share
