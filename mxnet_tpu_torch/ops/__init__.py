"""Kernels of the port: hand-written CUDA sources in ``csrc/``, each with
its plain torch version beside it."""
