"""Hand-written Hopper kernels, counterparts of ``iuvl_tpu/ops/pallas``.

Each module holds a kernel's wrapper, its plain PyTorch version and a
launch counter (``<wrapper>.launches``). A wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernel or raises.
"""
