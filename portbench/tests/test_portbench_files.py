"""The harness finds every file of a cell by name, and a cell made of new
files runs with no file of the harness edited."""

import json
import shutil

import pytest

from portbench import harness
from _tiny import CELLS


def test_every_cell_has_its_files():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["name"] == w["traffic"]
        assert cell["limits"], w["name"]
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_config_files_state_what_runs():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        # each key changed from the source is a group of the file, with its
        # reason among the assumptions; none is a width
        for key in cfg["reduced"]:
            assert key in cfg and key not in ("network",), key
            assert any(a.startswith(f"{key}.") for a in cfg["assumed"]), key
        assert cfg["build"]["frame_shape"] == [84, 84, 4]
        assert cfg["network"] == {"convs": [[32, 8, 4], [64, 4, 2], [64, 3, 1]], "hidden": 512, "torso_bias": 0.1}


def test_new_cell_needs_no_edit(tmp_path):
    """A new traffic mix, limits file and metric reader, added as files with
    an entry in ``BENCHMARK.json``, are found by name."""
    root = tmp_path
    shutil.copytree(harness.HERE, root / harness.HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    base = harness.load_cell(CELLS[0])
    traffic = dict(base["traffic"], name="train-b64", minibatch_size=64, update_interval=8)
    (root / "portbench" / "traffic" / "train-b64.json").write_text(json.dumps(traffic))
    (root / "portbench" / "limits" / "per-dqn.train-b64.json").write_text(json.dumps(base["limits"]))
    (root / "portbench" / "metrics" / "new_metric.py").write_text("def read(rec):\n    return 1.5\n")
    bench["workloads"].append({"name": "per-dqn.train-b64", "config": "per-dqn", "traffic": "train-b64",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "Runner", "moves": "env_steps_per_s"})
    for c in bench["configs"]:
        shutil.copy(harness.ROOT / c["file"], root / c["file"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("per-dqn.train-b64", root=root)
    assert cell["traffic"]["minibatch_size"] == 64
    assert "new_metric" in [m["name"] for m in cell["per_layer"]]
    assert harness.metric_reader("new_metric", root=root)({}) == 1.5


def test_unknown_cell_exits():
    with pytest.raises(SystemExit):
        harness.load_cell("no-such.cell")
