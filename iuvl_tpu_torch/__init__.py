"""iuvl_tpu_torch — the PyTorch / CUDA port of ``iuvl_tpu`` for NVIDIA Hopper.

The JAX package ``iuvl_tpu`` is the reference; this package mirrors its
layout (``models/sam``, ``models/xdecoder``, ``ops``, ``losses``,
``train``) so each module has an obvious counterpart. Plain tensor code is PyTorch; every Pallas kernel of the
JAX package on a ported path is a hand-written CUDA kernel under
``csrc/``, built at first use by ``ops/cuda/build.py``.

This package imports ``torch`` and never ``jax``.
"""
