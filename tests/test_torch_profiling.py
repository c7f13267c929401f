"""``pfrl_tpu_torch/utils/profiling.py`` on the CPU: ``trace`` writes a
Chrome / TensorBoard trace whose events name the traced operators, and
``StepTimer`` returns a positive rate that counts every lap's steps. The
JAX package's ``StepTimer`` is driven beside it with the same laps."""

import glob
import json
import time

import jax.numpy as jnp
import torch

from pfrl_tpu.utils.profiling import StepTimer as JaxStepTimer
from pfrl_tpu_torch.utils import StepTimer, trace
from pfrl_tpu_torch.utils.profiling import block_until_ready

torch.set_num_threads(1)


def test_trace_writes_a_trace_file_on_the_cpu(tmp_path):
    with trace(str(tmp_path)) as prof:
        x = torch.randn(64, 64)
        for _ in range(3):
            x = torch.tanh(x @ x)
    assert prof is not None
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::tanh" in names


def test_step_timer_returns_a_positive_rate_over_its_laps():
    timer, jtimer = StepTimer(), JaxStepTimer()
    x = torch.ones(8)
    timer.start(fence=x)
    jtimer.start(fence=jnp.ones(8))
    time.sleep(0.02)
    first = timer.lap(10, fence={"a": [x, (x,)]})
    jfirst = jtimer.lap(10, fence=jnp.ones(8))
    assert 0 < first < 10 / 0.02 and 0 < jfirst < 10 / 0.02
    time.sleep(0.02)
    second = timer.lap(10)
    assert 0 < second < 20 / 0.04 and timer._steps == 20
    timer.start()  # a new start forgets the laps
    assert timer._steps == 0 and timer.lap(5) > 0


def test_a_fence_of_cpu_tensors_needs_no_card():
    model = torch.nn.Linear(3, 2)
    block_until_ready([model, {"t": torch.zeros(2)}, None, 3])  # nothing to wait for, nothing raised
