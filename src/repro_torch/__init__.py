"""PyTorch/CUDA port of the FairEnergy system (``repro``, JAX on TPU).

Same module layout and public names as the JAX package; runs on an
NVIDIA GPU (Hopper kernels in ``kernels``), or on the CPU when asked, where
every kernel's plain PyTorch version runs instead. Imports no JAX.
"""
