"""``chip_smoke.phase``'s watchdog, on the CPU: ``chip_smoke.py`` imports only
``torch``, ``numpy`` and the standard library at its top, so its ``phase``
runs here. Each case runs in a subprocess under ``timeout``: a phase under
its limit returns its value; a phase that sleeps past a 1 s limit ends the
process with a non-zero code, its name and every thread's stack on stderr.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(body: str):
    code = f"import time, chip_smoke as cs\n{body}\n"
    return subprocess.run(["timeout", "60", sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=90)


def test_a_phase_under_its_limit_returns_its_value():
    out = _run("print('value', cs.phase('quick', lambda x: x + 1, 41, limit=5), cs.PHASE_TIMES['quick'] < 5)")
    assert out.returncode == 0, out.stderr
    start, seconds, value = out.stdout.splitlines()
    assert start == "phase quick: start" and seconds.startswith("phase quick: ") and seconds.endswith(" s")
    assert value == "value 42 True"


def test_every_phase_name_of_the_script_has_a_limit():
    out = _run("assert all(v >= 60 for v in cs.PHASE_LIMITS.values()) and len(cs.PHASE_LIMITS) > 100; print('ok')")
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_a_phase_past_its_limit_ends_the_run_with_its_name_and_a_traceback():
    out = _run("def sleepy_phase():\n    time.sleep(30)\n"
               "cs.phase('sleepy', sleepy_phase, limit=1)\nprint('not reached')")
    assert out.returncode not in (0, 124), (out.returncode, out.stderr)
    assert "not reached" not in out.stdout and "phase sleepy: start" in out.stdout
    assert "phase sleepy: start, limit 1 s" in out.stderr
    assert "Timeout" in out.stderr and "sleepy_phase" in out.stderr and "Thread" in out.stderr


def test_a_phase_that_raises_fails_the_run():
    out = _run("cs.phase('broken', lambda: 1 / 0, limit=5)")
    assert out.returncode != 0 and "ZeroDivisionError" in out.stderr


def test_phase_25_trains_the_quick_recipes_and_cuts_rainbow_in_depth_only():
    out = _run(
        "from pfrl_tpu_torch.experiments import record_curves as rc\n"
        "assert set(cs.CURVE_QUICK) == {'acer_abc', 'rppo_delayed_cue'} and cs.CURVE_RESUMED in cs.CURVE_QUICK\n"
        "assert all(isinstance(seed, int) for seed in cs.CURVE_QUICK.values())\n"
        "curve = rc.RUNS['rainbow_cartpole']('cpu')\n"
        "cfg = curve.runner.config\n"
        "assert (cfg.replay_start_size, curve.eval_every, cfg.num_envs) == (1024, 10000, 32)\n"  # the recipe's, uncut
        "assert 0 < cs.RAINBOW_CURVE_REPLAY_START < cs.RAINBOW_CURVE_EVAL_EVERY < curve.eval_every\n"
        "assert cs.RAINBOW_CURVE_REPLAY_START < cfg.replay_start_size and cs.RAINBOW_CURVE_EVAL_EVERY % 32 == 0\n"
        "assert curve.runner.buffer.tree_capacity == 131072 and cfg.minibatch_size == 64\n"
        "assert cs.PHASE_LIMITS['curves'] >= 60\n"
        "print('ok')")
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
