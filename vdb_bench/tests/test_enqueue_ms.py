"""``enqueue_ms`` on hand-made stages."""

import pytest

from vdb_bench import spec
from vdb_bench.harness import Run


@pytest.mark.parametrize("stages, value", [
    ({"enqueue": {"p50": 0.75, "mean": 0.9, "count": 40},
      "fetch_wait": {"p50": 2.0, "mean": 2.1, "count": 40}}, 0.75),
    # an engine or index that records no enqueue (the parent's)
    ({"fetch_wait": {"p50": 2.0, "mean": 2.1, "count": 40}}, None),
    ({}, None),
])
def test_enqueue_ms_reads_the_enqueue_stage(stages, value):
    assert spec.load_reader("enqueue_ms")(Run(stages=stages)) == value
