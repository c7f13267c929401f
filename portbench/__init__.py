"""The benchmark of the PyTorch and CUDA port (``pfrl_tpu_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the CUDA device and prints one
JSON result line. Everything that belongs to one configuration, traffic mix,
per-layer metric or set of limits is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``,
``limits/<cell>.json``. ``reference/`` is the plain reference that decides
``correct``; it imports nothing of the port.
"""
