"""``experiments/seed_sweep.py``'s comparison of two packages' seed sweeps
(imports no JAX): the tests it runs on rows of the sweeps' layout, their
p-values against scipy's on the same numbers, and the seeds' parser."""

import pytest
from scipy import stats

from pfrl_tpu_torch.experiments import seed_sweep


def _rows(package, name, bests, steps_at, cap=300_000, score=475.0):
    return [{"package": package, "name": name, "seed": i, "best": b, "solved": b >= score,
             "t": t if b >= score else cap, "steps": cap, "rows": 10, "seconds": 1.0, "host": "x"}
            for i, (b, t) in enumerate(zip(bests, steps_at))]


def test_parse_seeds():
    assert seed_sweep.parse_seeds("0-9") == list(range(10))
    assert seed_sweep.parse_seeds("1,3,5") == [1, 3, 5]


def test_same_rows_reject_nothing():
    rows = _rows("jax", "rainbow_cartpole", [480.0, 500.0, 300.0, 490.0], [49_920, 59_904, 0, 49_920])
    (res,) = seed_sweep.compare(rows, rows).values()
    assert res["solved"] == [3, 3] and res["p_solved"] == 1.0 and res["p_best"] == 1.0 and res["p_steps"] == 1.0
    assert not res["rejects"]


def test_a_large_gap_rejects_with_scipy_p_values():
    jax = _rows("jax", "rainbow_cartpole", [500.0] * 10, [49_920] * 6 + [59_904] * 4)
    port = _rows("torch", "rainbow_cartpole", [480.0] * 8 + [300.0] * 2, [99_840 + 9_984 * i for i in range(10)])
    jax += _rows("jax", "dqn_cartpole", [500.0] + [200.0] * 9, [159_744] + [0] * 9, cap=209_664, score=500.0)
    port += _rows("torch", "dqn_cartpole", [250.0] * 10, [0] * 10, cap=209_664, score=500.0)
    out = seed_sweep.compare(jax, port)
    assert list(out) == ["dqn_cartpole", "rainbow_cartpole"]
    rb, dqn = out["rainbow_cartpole"], out["dqn_cartpole"]
    assert rb["steps_at_solve"][1][-2:] == [300_000, 300_000]  # unsolved runs count at the cap
    assert rb["p_steps"] == pytest.approx(stats.mannwhitneyu(*rb["steps_at_solve"], alternative="two-sided").pvalue)
    assert rb["p_solved"] == pytest.approx(stats.fisher_exact([[10, 0], [8, 2]])[1])
    assert rb["p_steps"] < seed_sweep.ALPHA and rb["rejects"]
    assert "p_steps" not in dqn and dqn["solved"] == [1, 0]
    table = seed_sweep.markdown(out)
    assert table.count("\n") == 3 and "| rainbow_cartpole | 10/10 | 8/10 |" in table


def test_only_recipes_on_both_sides_are_compared():
    jax = _rows("jax", "al_cartpole", [500.0, 200.0], [149_760, 0])
    port = _rows("torch", "dqn_cartpole", [250.0], [0])
    assert seed_sweep.compare(jax, port) == {}
