"""multihmr_tpu_torch — the PyTorch and CUDA port of multihmr_tpu.

Mirrors the module paths of ``multihmr_tpu`` (the JAX reference, which stays
as it is) and imports nothing of it. The flash-attention forward and
backward and the channels-major LayerNorm are hand-written CUDA kernels for
Hopper (``csrc/``), built at first use; every other op is plain PyTorch. A
CPU tensor takes each kernel's plain version.
"""
