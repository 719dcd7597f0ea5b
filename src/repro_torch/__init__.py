"""PyTorch + CUDA port of the OCEAN scheduler (``repro``'s JAX package).

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``core/``, ``kernels/``, ``sim/``) and names so each counterpart
is easy to find.  It imports ``torch`` and numpy only — never ``jax``,
``repro`` or ``benchmarks``.

Entry points (``core.ocean.simulate``, ``sim.run_grid``) run on the CUDA
card by default; ``device="cpu"`` is the only way onto the CPU, and with
no card present any other request raises ``RuntimeError``.  The kernel
wrappers in ``kernels/`` launch their hand-written Hopper kernels for
CUDA tensors and run their plain PyTorch versions for CPU tensors.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
