"""Tensor ops of the port: plain PyTorch math and the CUDA kernel wrappers
(``ops/cuda``), counterparts of ``iuvl_tpu/ops``."""
