"""The trace reader on events made up by hand."""

import pytest

from portbench import devtrace


def test_union_and_attribution():
    ops = [("k1", 100, 50, 1), ("k2", 120, 50, 2), ("k3", 400, 100, 3), ("k4", 900, 10, 4), ("k5", 950, 10, 5)]
    launches = {1: 10, 2: 20, 3: 300, 4: 800}  # k5 has no launch on record
    ranges = {"draw": [(0, 30)], "gather": [(250, 310)], "sample": [(0, 320)]}
    s = devtrace.summarize(ops, launches, ranges, window_s=1e-6)
    assert s["device_ops"] == 5 and s["unattributed"] == 1
    assert s["busy_s"] == pytest.approx((170 - 100 + 100 + 10 + 10) * 1e-9)
    assert s["under"]["draw"] == {"device_s": pytest.approx(100e-9), "device_ops": 2, "calls": 1}
    assert s["under"]["sample"]["device_ops"] == 3
    assert s["under"]["gather"]["device_ops"] == 1
    gaps = dict(s["breakdown"]["idle_gaps"])
    # 170 -> 400 ends at k3, launched inside gather (the innermost open range)
    assert gaps["gather"] == pytest.approx(230e-9)
    assert gaps["outside the benchmark's ranges"] == pytest.approx(400e-9)
    assert gaps["unattributed"] == pytest.approx(40e-9)
    assert s["breakdown"]["device_ops"][0] == ["k3", pytest.approx(100e-9)]


def test_union_merges_overlaps():
    assert devtrace.union([(5, 9), (1, 3), (2, 4), (9, 10)]) == [(1, 4), (5, 10)]
