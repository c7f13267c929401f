"""Tensor ops and the hand-written kernels (``prefix_sample``).

Import from the submodules: ``ops.prefix_sample`` names both a module and
its wrapper function, so nothing is re-exported here.
"""
