"""The readers of the program's own spans (``portbench/program_trace.py``):
the trace reader on events made up by hand, each metric's reader on a
record made up by hand, and a run of the tiny cell on the CPU, where the
host readers read a value and the device readers none."""

import pytest

from portbench import program_trace as pt
from _tiny import CELLS, tiny

P = pt.PREFIX


def _events():
    # (name, on the device, a user annotation, start, duration, correlation id)
    return [
        (P + "step", False, True, 0, 1000, 1),
        (P + "update", False, True, 100, 400, 2),
        (P + "feedback", False, True, 600, 300, 3),
        ("cudaLaunchKernel", False, False, 150, 10, 10),
        ("cudaLaunchKernel", False, False, 650, 10, 11),
        ("cudaGraphLaunch", False, False, 700, 10, 12),
        ("cudaLaunchKernel", False, False, 1500, 10, 13),  # outside every span
        ("aten::add", False, False, 150, 20, 4),
        ("gemm", True, False, 2000, 100, 10),
        ("reduce", True, False, 2300, 100, 11),
        ("graph_kernel_a", True, False, 2500, 50, 12),
        ("graph_kernel_b", True, False, 2560, 50, 12),
        ("fill", True, False, 3000, 10, 13),
        # device-side mirrors of host ranges, of any name: no operations
        (P + "update", True, True, 2000, 300, 2),
        ("portbench.update", True, True, 2000, 300, 5),
        ("other_range", True, True, 2900, 10, 6),
    ]


def test_device_mirrors_of_any_range_are_no_operations():
    ops, launches, ranges = pt.split_events(_events())
    assert [op[0] for op in ops] == ["gemm", "reduce", "graph_kernel_a", "graph_kernel_b", "fill"]
    assert launches == {10: 150, 11: 650, 12: 700, 13: 1500}
    assert ranges == {"step": [(0, 1000)], "update": [(100, 500)], "feedback": [(600, 900)]}


def test_launches_are_distinct_correlation_ids_under_a_span():
    ops, launches, ranges = pt.split_events(_events())
    assert pt.launches_under(ops, launches, ranges) == {"step": 3, "update": 1, "feedback": 2}


def test_idle_gaps_by_the_innermost_span():
    gaps = pt.idle_gaps_by_span(*pt.split_events(_events()))
    # 2100 -> 2300 ends at reduce (feedback), 2400 -> 2500 at graph_kernel_a
    # (feedback), 2550 -> 2560 at graph_kernel_b (feedback), 2610 -> 3000 at
    # fill, launched outside every span
    assert gaps == {"feedback": pytest.approx(310e-9), pt.OUTSIDE: pytest.approx(390e-9)}


def _record():
    return {
        "num_envs": 64,
        "setup_spans": {"raw": [("init", -1, 0, 5), ("step", -1, 10, 20), ("step", -1, 20, 40),
                                ("step", -1, 40, 100), ("update", 3, 50, 90), ("step", -1, 100, 150)]},
        "host_spans": {"spans": {"step": {"seconds": 0.6, "self_seconds": 0.01, "calls": 3},
                                 "add": {"seconds": 0.006, "self_seconds": 0.006, "calls": 3}}},
        "program_trace": {"scan_steps": 3, "launches": {"step": 30000},
                          "under": {"update": {"device_ops": 960, "device_s": 1.0, "calls": 96},
                                    "feedback": {"device_ops": 1440, "device_s": 1.0, "calls": 48}},
                          "counters": {"updates": 48, "feedbacks": 48}},
    }


def test_each_reader_on_a_record():
    rec = _record()
    assert pt.replay_add_ms(rec) == pytest.approx(2.0)
    assert pt.update_ops(rec) == pytest.approx(20.0)  # by the counter, not the span's calls
    assert pt.feedback_ops(rec) == pytest.approx(30.0)
    assert pt.host_us_per_launch(rec) == pytest.approx(200_000 / 10_000)
    assert pt.warmup_s(rec) == pytest.approx(30e-9)  # the steps that end before the first update


@pytest.mark.parametrize("name", sorted(pt.READERS))
def test_a_record_without_the_programs_spans_reads_nothing(name):
    """A run of a program without spans, or of the harness's own windows,
    gives no reading and raises nothing."""
    read = pt.READERS[name]
    assert read({}) is None
    assert read({"trace": {"under": {}}, "spans": {"spans": {}, "scan_steps": 1}}) is None
    empty = {"setup_spans": {"raw": []}, "host_spans": {"spans": {}},
             "program_trace": {"scan_steps": 1, "launches": {}, "under": {}, "counters": {}}}
    assert read(empty) is None


def test_a_run_on_the_cpu_reads_the_host_spans():
    out = pt.run(tiny(CELLS[0]), 2**33 + 5, "cpu")
    assert out["correct"], out["checks"]
    r = out["readings"]
    assert r["replay_add_ms"] > 0 and r["warmup_s"] > 0
    assert r["update_ops"] is None and r["feedback_ops"] is None and r["host_us_per_launch"] is None
    host = out["host_window"]
    assert host["counters"]["updates"] == host["counters"]["feedbacks"] == 2 * 2  # 2 steps of 2 updates
    assert 0.9 < host["covered"] <= 1.0
    assert out["set_up"]["spans"]["init"]["calls"] == 1
    cost = out["span_cost"]
    assert cost["span_us"]["on"] > 0 and cost["spans_per_step"] == 5 + 5 * 2
    assert 0 < cost["share_off"] < cost["share_on"] < 1
