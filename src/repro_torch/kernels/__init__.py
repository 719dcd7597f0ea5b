"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

CUDA sources live in ``repro_torch/csrc/`` and are built at first use
(``kernels/_build.py``); importing this package builds nothing.
"""
