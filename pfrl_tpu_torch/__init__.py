"""PyTorch/CUDA port of pfrl_tpu for NVIDIA Hopper.

The JAX package ``pfrl_tpu`` is the reference: module paths and class names
here mirror it, and ``tests/test_torch_*.py`` hold each module against its
counterpart. This package imports ``torch`` and nothing of JAX or
``pfrl_tpu``.

The port covers ``pfrl_tpu/``'s public surface: every public class and
function of every module, with their arguments, fields and public
methods, has its counterpart here. ``tests/test_torch_api_parity.py``
checks that by reading both trees with ``ast``; its ``DIFFERENCES`` table
lists each deliberate difference (parameters that live in the module,
JAX-only arguments, renamings, the native frame ops' refusal to fall
back, an argument the reference never reads) and fails when an entry goes
stale. The one Pallas kernel, ``prefix_sample_pallas``, is the hand-written
Hopper kernel ``csrc/prefix_sample.cu``. Every script of ``examples/`` has
a command line, ``python -m pfrl_tpu_torch.experiments.<module>`` with the
example's flags (``README.md`` maps the 27 scripts), and
``tools/record_curves.py`` is ``python -m
pfrl_tpu_torch.experiments.record_curves``;
``experiments/seed_sweep.py`` trains its recipes over seeds and compares
them with the JAX package's (``tests/jax_seed_sweep.py``).

Every first-order core takes ``compute_dtype`` (bf16 compute over float32
masters, see :mod:`.utils.precision`); TRPO refuses it, as in JAX. A JAX
checkpoint (flax msgpack) loads through the port's own reader
(:mod:`.utils.flax_msgpack`) and :mod:`.convert`, with no JAX installed,
and :func:`.convert.save_flax_checkpoint` writes one the JAX package reads.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise (see :mod:`._device`). Kernels
are built from ``csrc/`` at first use (see :mod:`.ops.cuda_build`).
"""

from pfrl_tpu_torch import collections_  # noqa: F401,E402  (no torch: safe in the actor processes)
from pfrl_tpu_torch import collections_ as collections  # noqa: F401,E402  (pfrl name)


def __getattr__(name):
    # Resolved on first use, so that the Atari pipeline's actor processes,
    # which import the package's host modules, never load torch.
    if name == "resolve_device":
        from pfrl_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
