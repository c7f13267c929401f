"""Plain PyTorch reference of the benchmarked training step.

It imports nothing of ``pfrl_tpu_torch`` or of the JAX package: AtariSim's
arithmetic, the Nature network, the summed Huber loss, optax's RMSprop and
proportional prioritized replay are written out here again, from their
published descriptions and the port's documented draw order.
"""
